"""starcoder2-3b — dense, GQA kv=2, RoPE.

[arXiv:2402.19173; hf-tier]  Assignment config:
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

The JAX package's dense family is SwiGLU + RMSNorm, and the port follows
it: this config runs that block, not HF starcoder2's GELU MLP with
LayerNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999999.4,
    max_seq_len=16384,
)
