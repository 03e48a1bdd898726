"""Data parallelism of the port over torch.distributed."""
