"""Serving pillar of the port: model server and the generate engine."""
