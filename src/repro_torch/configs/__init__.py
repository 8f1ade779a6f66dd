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

#: the dry run's architectures, JAX's list in JAX's order (llama3.1-8b is
#: registered but not among them)
ARCH_IDS = [
    "seamless-m4t-medium", "dbrx-132b", "qwen2-moe-a2.7b", "granite-8b",
    "tinyllama-1.1b", "qwen1.5-4b", "yi-9b", "paligemma-3b", "mamba2-2.7b",
    "recurrentgemma-9b",
]
