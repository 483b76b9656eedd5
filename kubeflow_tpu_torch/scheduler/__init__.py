"""Scheduling of the port's control plane: GPU nodes and gangs."""
