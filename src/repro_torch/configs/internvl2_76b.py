"""internvl2-76b — InternViT + LLM backbone (the backbone; the ViT is a
stub).

[arXiv:2404.16821; unverified-tier]  Assignment config:
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision frontend is a stub: ``serving/engine`` provides precomputed
patch embeddings (num_image_tokens x d_model) that
``transformer.embed_inputs`` puts in front of the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    num_image_tokens=256,
    rope_theta=500000.0,
    max_seq_len=32768,
)
