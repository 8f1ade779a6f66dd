"""Model configuration dataclass, the shape suite, the smoke-size
reduction and the registry (port of ``repro/configs/base.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.core.codecs import CachePolicy
from repro_torch.core.paged_cache import DECODE_BACKENDS, PREFILL_BACKENDS
from repro_torch.core.quantizers import QuantConfig


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|encdec|vlm|ssm|hybrid
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
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    scale_embedding: bool = False     # gemma-style sqrt(d_model) embed scale
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden (0 => d_ff)
    capacity_factor: float = 1.25
    norm_topk: bool = True
    router_aux_loss: float = 0.01
    # --- enc-dec ---
    encoder_layers: int = 0
    # --- modality frontend (stubbed: precomputed frame / patch embeddings) ---
    frontend_dim: int = 0             # stubbed modality frontend feature dim
    frontend_tokens: int = 0          # tokens emitted by the frontend stub
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (recurrentgemma) ---
    window: int = 0                   # local-attention window (0 = global)
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv1d_width: int = 4
    # cache policy: `quant` is the uniform default; `cache_policy`
    # (optional) maps layer index -> QuantConfig for KVTuner-style mixed
    # precision. Read through the `policy` property.
    quant: QuantConfig = field(default_factory=QuantConfig)
    cache_policy: Optional[CachePolicy] = None
    # decode attention (core.paged_cache.DECODE_BACKENDS): "paged_fused"
    # walks the page table in place (paged engine) / runs the fused dense
    # kernel (dense cache); "gathered" reads a dense per-slot copy through
    # the fused kernel (paged engine; the fused kernel on a dense cache);
    # "jnp" is the score-only LUT kernel + masked softmax over a dense
    # copy. JAX defaults to "jnp"; the port to the route its paged engine
    # has always run. The tensors' device picks kernel or plain version.
    decode_backend: str = "paged_fused"
    # chunked-prefill attention (core.paged_cache.PREFILL_BACKENDS):
    # "paged_fused" walks the row's pages in place (the paged-prefill
    # kernel), "jnp" gathers them (chunk_prefill_attention). Codecs
    # without a page-native prefill take "jnp" layer by layer. JAX
    # defaults to "jnp"; the port, as for decode, to the kernel's route.
    prefill_backend: str = "paged_fused"

    def __post_init__(self):
        if self.decode_backend not in DECODE_BACKENDS:
            raise ValueError(f"unknown decode_backend {self.decode_backend!r};"
                             f" expected one of {DECODE_BACKENDS}")
        if self.prefill_backend not in PREFILL_BACKENDS:
            raise ValueError(
                f"unknown prefill_backend {self.prefill_backend!r}; "
                f"expected one of {PREFILL_BACKENDS}")
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def policy(self) -> CachePolicy:
        """The per-layer cache policy (uniform over ``quant`` unless
        ``cache_policy`` is set)."""
        if self.cache_policy is not None:
            return self.cache_policy
        return CachePolicy(default=self.quant)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        """Supports long-context decode with bounded per-token state."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count: JAX's
        ``repro.configs.base.ModelConfig.param_count``, its values kept.
        Its ssm branch leaves out ``conv_b`` and one of the three per-head
        vectors (``A_log``, ``dt_bias``, ``D``), its encdec branch
        ``frontend_proj`` and ``enc_norm``: the params drawn are that many
        more (pinned in ``tests/test_torch_ssm.py`` and
        ``tests/test_torch_encdec.py``)."""
        d, h = self.d_model, self.head_dim
        attn = d * h * self.num_heads + 2 * d * h * self.num_kv_heads + \
            self.num_heads * h * d
        if self.qkv_bias:
            attn += h * (self.num_heads + 2 * self.num_kv_heads)
        if self.family == "moe":
            eff = self.moe_d_ff or self.d_ff
            ffn = self.num_experts * 3 * d * eff + d * self.num_experts
            ffn += self.num_shared_experts * 3 * d * eff
        else:
            ffn = 3 * d * self.d_ff
        norms = 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din = self.ssm_expand * d
            nheads = din // self.ssm_headdim
            bc = 2 * self.ssm_ngroups * self.ssm_state
            in_proj = d * (2 * din + bc + nheads)
            conv = (din + bc) * self.ssm_conv
            per_layer = in_proj + conv + 2 * nheads + din + din * d + d
            return self.num_layers * per_layer + emb + d
        if self.family == "hybrid":
            w = self.lru_width or d
            # RG-LRU block: in-proj x2 (d->w), conv1d (w*width), gates
            # (block-diagonal: 2 * w * w / nheads), lambda + D, out proj w->d.
            nb = max(self.num_heads, 1)
            rec = 2 * d * w + self.conv1d_width * w + 2 * (w * w // nb) + \
                2 * w + w * d
            n_rec = sum(1 for i in range(self.num_layers)
                        if self.block_pattern[i % len(self.block_pattern)]
                        == "rec")
            n_att = self.num_layers - n_rec
            return (n_att * (attn + ffn + norms) + n_rec * (rec + ffn + norms)
                    + emb + d)
        extra = 0
        if self.family == "encdec":
            extra = self.num_layers * (attn + d)   # decoder cross-attention
        if self.family == "vlm" and self.frontend_dim:
            extra = self.frontend_dim * d          # patch projector
        return ((self.num_layers + self.encoder_layers) * (attn + ffn + norms)
                + extra + emb + d)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode
    generate_len: int = 1     # decode steps lowered (always 1 for dry-run)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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
        max_seq_len=512,
        dtype="float32",
    )
    if cfg.num_kv_heads == cfg.num_heads:
        small["num_kv_heads"] = 4
    elif cfg.num_kv_heads == 1:
        small["num_kv_heads"] = 1
    else:
        small["num_kv_heads"] = 2
    if cfg.family == "moe":
        small.update(num_experts=4, top_k=2, moe_d_ff=64,
                     num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.family == "encdec":
        small.update(encoder_layers=2, frontend_dim=32, frontend_tokens=16)
    if cfg.family == "vlm":
        small.update(frontend_dim=32, frontend_tokens=16)
    if cfg.family == "ssm":
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        # one full block pattern + tail so attn AND rec layers are exercised
        small.update(window=64, lru_width=128,
                     num_layers=len(cfg.block_pattern) + 1)
    small["quant"] = replace(cfg.quant, group_size=32)
    if cfg.cache_policy is not None:
        small["cache_policy"] = cfg.cache_policy.map(
            lambda q: replace(q, group_size=32))
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


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
