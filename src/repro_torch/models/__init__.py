"""Model zoo of the port (the dense decoder family in this slice)."""
from repro_torch.models.registry import Model, get_model  # noqa: F401
