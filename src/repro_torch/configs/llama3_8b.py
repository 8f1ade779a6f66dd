"""llama3.1-8b — the paper's own primary evaluation backbone (Table 1/4).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, rope 500000.
The paper's kernel latency and throughput tables (Table 4, Figure 3) use
this configuration.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_base=500000.0,
    max_seq_len=131072,
))
