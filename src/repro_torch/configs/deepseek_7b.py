"""deepseek-7b — dense llama-arch.

[arXiv:2401.02954; hf-tier]  Assignment config:
30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.

The port, like the JAX package, builds every dense config as SwiGLU +
RMSNorm blocks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10000.0,
    max_seq_len=4096,
)
