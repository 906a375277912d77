"""moonshot-v1-16b-a3b — Moonlight-16B-A3B MoE (64 routed experts, top-6).

[hf:moonshotai/Moonlight-16B-A3B; hf-tier]  Assignment config:
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
DeepSeek-V3-style fine-grained MoE: 2 shared experts + first layer dense.

Expert layers run ``models/moe.py`` (capacity dispatch, shared experts
through the dense SwiGLU MLP).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_first_dense=1,
    rope_theta=50000.0,
    max_seq_len=8192,
)
