"""Model zoo of the port (every family of the JAX package)."""
from repro_torch.models.registry import Model, get_model  # noqa: F401
