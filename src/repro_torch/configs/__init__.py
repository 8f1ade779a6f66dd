"""Architecture registry (the dense configurations this slice serves)."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, reduce_for_smoke,
)

# Importing each module registers its CONFIG.
from repro_torch.configs import tinyllama_1p1b  # noqa: F401
