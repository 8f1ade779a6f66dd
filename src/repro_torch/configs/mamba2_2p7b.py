"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD, state-space duality).

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2*d_model = 5120, headdim=64 -> 80 SSD heads, conv width 4.
No KV cache exists; PolarQuant is inapplicable (DESIGN.md
§Arch-applicability) — the architecture runs WITHOUT the technique.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    max_seq_len=1 << 20,
))
