"""Model configuration dataclass, the smoke-size reduction and the registry
(port of ``repro/configs/base.py`` for the dense decoder family)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.quantizers import QuantConfig


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # this slice serves "dense" only
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads
    rope_base: float = 10000.0
    rope_ntk_scale: float = 1.0       # NTK-aware context extension (App. C)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"                 # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    scale_embedding: bool = False     # gemma-style sqrt(d_model) embed scale
    # uniform key-cache policy (per-layer mixing comes in a later slice)
    quant: QuantConfig = field(default_factory=QuantConfig)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to CPU-smoke size while keeping the family topology
    (the same reduction as ``repro.configs.base.reduce_for_smoke``)."""
    small = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.num_kv_heads == cfg.num_heads:
        small["num_kv_heads"] = 4
    elif cfg.num_kv_heads == 1:
        small["num_kv_heads"] = 1
    else:
        small["num_kv_heads"] = 2
    small["quant"] = replace(cfg.quant, group_size=32)
    small.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **small)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401 — populates the registry
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
