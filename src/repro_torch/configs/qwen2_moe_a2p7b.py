"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408/expert vocab=151936,
MoE: 60 routed experts top-4 + 4 shared expert units (always active).
QKV bias per the Qwen family.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    top_k=4,
    num_shared_experts=4,
    norm_topk=False,
    qkv_bias=True,
    rope_base=1000000.0,
    max_seq_len=32768,
))
