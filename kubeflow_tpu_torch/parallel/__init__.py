"""Process groups for the port's workers (``torch.distributed``)."""
