"""Training of the port: trainer, data and checkpoints on one card."""
