"""Training runtime: the fault-tolerant trainer and elastic rescaling by
live pre-copy of the training state."""
