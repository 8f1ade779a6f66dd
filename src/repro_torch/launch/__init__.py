"""Launch helpers: the process mesh over a ``torch.distributed`` world."""
