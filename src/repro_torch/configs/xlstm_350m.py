"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM recurrent blocks.

24L, d_model=1024, 4 heads, d_ff=0 (projections live inside the blocks),
vocab=50304.  We alternate mLSTM/sLSTM with period 2 (the paper mixes the
two block types; its released ratios vary by model — period-2 keeps the
scanned stack uniform).  Strictly-recurrent => long_500k native.
"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    long_context="native",
    citation="arXiv:2405.04517",
)
