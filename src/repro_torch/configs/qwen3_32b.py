"""Qwen3-32B [hf:Qwen/Qwen3-8B family] — dense GQA with qk_norm.

64L, d_model=5120, 64 heads (GQA kv=8, head_dim=128), d_ff=25600,
vocab=151936.
"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    long_context="sliding_override",
    citation="hf:Qwen/Qwen3-8B",
)
