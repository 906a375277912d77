"""zamba2-7b — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified-tier]  Assignment config:
81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
A single shared (attention + MLP) block is re-applied every 6 Mamba2
blocks, consuming [h, h_embed_orig] concat (concat_embed).  Weight sharing
means the shared block contributes ONE delta re-used at every application
point.
Mamba2: d_inner = 2·d_model = 7168, head_dim 64 → 112 SSM heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=112,
    ssm_conv=4,
    attn_every=6,
    concat_embed=True,
    max_seq_len=4096,
)
