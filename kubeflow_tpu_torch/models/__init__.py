"""Models of the port (BERT MLM in this slice)."""
