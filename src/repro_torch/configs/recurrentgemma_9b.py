"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin: RG-LRU + local attn).

38L d_model=4096 16H (GQA kv=1 = MQA) d_ff=12288 vocab=256000,
block pattern 1 attention : 2 recurrent -> (rec, rec, attn) repeating,
local attention window 2048, lru_width=4096, conv1d width 4.
PolarQuant applies to the (bounded) local-attention KV ring cache;
the RG-LRU recurrence state stays fp.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    act="gelu",
    scale_embedding=True,
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv1d_width=4,
    rope_base=10000.0,
    max_seq_len=1 << 20,
))
