"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf-tier]  Assignment config:
28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6.
First layer dense (first_k_dense_replace=1 in the HF config).

Expert layers run ``models/moe.py`` (capacity dispatch, shared experts
through the dense SwiGLU MLP).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_first_dense=1,
    rope_theta=10000.0,
    max_seq_len=4096,
)
