"""dbrx-132b [moe] — hf:databricks/dbrx-base.

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352,
MoE 16 experts top-4 (fine-grained, no shared experts).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    moe_d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    norm_topk=True,
    rope_base=500000.0,
    max_seq_len=32768,
))
