"""qwen1.5-4b [dense] — hf:Qwen/Qwen1.5-4B (QKV bias).

40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_base=1000000.0,
    max_seq_len=32768,
))
