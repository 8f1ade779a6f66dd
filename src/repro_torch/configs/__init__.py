"""Architecture registry: every configuration of the JAX package."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, SHAPES, get_config, list_configs,
    reduce_for_smoke,
)

# Importing each module registers its CONFIG.
from repro_torch.configs import (  # noqa: F401
    dbrx_132b, granite_8b, llama3_8b, mamba2_2p7b, paligemma_3b,
    qwen1p5_4b, qwen2_moe_a2p7b, recurrentgemma_9b, seamless_m4t_medium,
    tinyllama_1p1b, yi_9b,
)
