"""Core utilities of the port: the metrics registry and trace context."""
