"""Hymba-1.5B [arXiv:2411.13676] — hybrid-head architecture.

32L, d_model=1600, 25 heads (GQA kv=5, head_dim=64), d_ff=5504,
vocab=32001, ssm_state=16.  Every block runs attention heads and mamba
heads *in parallel* on the same input and fuses their outputs; attention
is sliding-window in most layers (we model all hybrid blocks with SWA,
which is what makes long_500k native for this arch).
"""
from ..nn.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    block_pattern=("hybrid",),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    sliding_window=2048,
    long_context="native",
    citation="arXiv:2411.13676",
)
