"""xlstm-350m [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

24L d_model=1024 4H d_ff=0 vocab=50304. Recurrent -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                       # xLSTM blocks carry their own projections
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=2, head_dim=256),
    supports_long_context=True,
)
