"""Training pieces (the port of ``repro.train``): the AdamW optimizer."""
