"""seamless-m4t-medium [audio enc-dec] — arXiv:2308.11596.

12L d_model=1024 16H (GQA kv=16 = MHA) d_ff=4096 vocab=256206.
Enc-dec: 12 encoder + 12 decoder layers; the speech frontend
(conformer feature extractor) is STUBBED — ``input_specs()`` provides
precomputed frame embeddings (frontend_dim) per the assignment brief.
PolarQuant applies to decoder self-attention KV; cross-attention KV is
quantized with the same polar policy (transform is RoPE-independent).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope_base=10000.0,
    frontend_dim=160,         # stub: precomputed audio frame features
    frontend_tokens=1024,     # frames after the (stubbed) subsampler
    max_seq_len=4096,
))
