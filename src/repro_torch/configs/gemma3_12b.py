"""gemma3-12b — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-*; unverified-tier]  Assignment config:
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
Pattern: 5 sliding-window (1024) local layers per 1 global layer; local
layers use rope_theta=10k, global layers 1M.  head_dim=256, qk-norm.

The dense family of both packages is SwiGLU + RMSNorm; local layers keep
a ring cache of ``sliding_window`` slots.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    qk_norm=True,
    local_global_pattern=5,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10000.0,
    max_seq_len=131072,
    tie_embeddings=True,
)
