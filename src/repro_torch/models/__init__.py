"""Model zoo of the port (the dense and MoE decoder families)."""
from repro_torch.models.registry import Model, get_model  # noqa: F401
