"""paligemma-3b [vlm] — arXiv:2407.07726 (SigLIP + gemma backbone).

18L d_model=2048 8H (GQA kv=1 = MQA) d_ff=16384 vocab=257216.
The SigLIP vision tower is STUBBED: the caller provides precomputed patch
embeddings (frontend_dim=1152, 256 patches) which the model projects into
d_model and prepends with a bidirectional prefix-LM mask (PaliGemma
attends fully over image + prefix text).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",                 # gemma GeGLU
    scale_embedding=True,
    frontend_dim=1152,          # SigLIP So400m width
    frontend_tokens=256,        # 224px / 14 patches -> 16x16
    rope_base=10000.0,
    max_seq_len=8192,
))
