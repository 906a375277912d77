"""Model configuration (port of ``repro.configs.base``).

The same ``ModelConfig`` fields as the JAX package, so a configuration
means the same model in both.  ``reduced()`` gives the small CPU test
variant of a family.  The port serves the dense family (local:global
layers included), the MoE family, the VLM backbone, the encoder-decoder
(audio) family and the recurrent families (``ssm``: xLSTM; ``hybrid``:
Mamba2 with a shared attention block); the distribution fields are
carried so configurations stay field-for-field equal.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    max_seq_len: int = 8192

    # --- positional / attention flavour ---
    rope_theta: float = 10000.0
    qk_norm: bool = False             # qwen3 / gemma3
    sliding_window: int = 0           # >0: local attention window
    local_global_pattern: int = 0     # gemma3: N local layers per 1 global
    rope_theta_local: float = 10000.0
    attn_logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_first_dense: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    mlstm_ratio: int = 0
    attn_every: int = 0
    concat_embed: bool = False

    # --- enc-dec ---
    encoder_layers: int = 0
    encoder_frames: int = 0
    cross_attention: bool = False

    # --- vlm ---
    num_image_tokens: int = 0

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- distribution (kept for field parity; unused by the port) ---
    remat: bool = True
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the embedding and unembedding
        tables carry the padded rows)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def reduced(self) -> "ModelConfig":
        """Same family, tiny dims — used by CPU tests only."""
        def shrink(v, lo, hi):
            return 0 if v == 0 else max(lo, min(v, hi))
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4 if self.family != "hybrid" else 7),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            moe_d_ff=64 if self.num_experts else 0,
            vocab_size=256,
            max_seq_len=128,
            num_experts=shrink(self.num_experts, 4, 8),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=shrink(self.top_k, 2, 2),
            capacity_factor=(8.0 if self.num_experts else self.capacity_factor),
            moe_first_dense=min(self.moe_first_dense, 1),
            local_global_pattern=min(self.local_global_pattern, 1),
            sliding_window=shrink(self.sliding_window, 16, 16),
            ssm_state=shrink(self.ssm_state, 16, 16),
            ssm_heads=shrink(self.ssm_heads, 2, 2),
            mlstm_ratio=shrink(self.mlstm_ratio, 3, 3),
            attn_every=shrink(self.attn_every, 3, 3),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=shrink(self.encoder_frames, 16, 16),
            num_image_tokens=shrink(self.num_image_tokens, 8, 8),
            remat=False,
            scan_layers=True,
        )
