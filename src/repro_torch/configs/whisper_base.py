"""whisper-base — encoder-decoder; the conv audio frontend is a stub.

[arXiv:2212.04356; unverified-tier]  Assignment config:
6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865; enc-dec.
The frontend stub (``serving/engine``) provides precomputed frame
embeddings (encoder_frames=1500 x d_model) standing in for the two conv1d
layers.  Positions: sinusoidal (no RoPE), as Whisper's.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,          # decoder layers
    encoder_layers=6,
    encoder_frames=1500,
    cross_attention=True,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    max_seq_len=4096,
)
