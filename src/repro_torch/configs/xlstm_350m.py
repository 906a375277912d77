"""xlstm-350m — sLSTM + mLSTM blocks (xLSTM[7:1]).

[arXiv:2405.04517; unverified-tier]  Assignment config:
24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.
d_ff=0: xLSTM blocks carry their own up/down projections (factor-2 up for
mLSTM, post-FFN 4/3 for sLSTM per the paper); no separate MLP block.
mlstm_ratio=7 → repeating pattern of 7 mLSTM blocks then 1 sLSTM block.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mlstm_ratio=7,
    ssm_conv=4,
    max_seq_len=8192,
)
