"""Model zoo of the port (the dense, MoE, VLM and hybrid families)."""
from repro_torch.models.registry import Model, get_model  # noqa: F401
