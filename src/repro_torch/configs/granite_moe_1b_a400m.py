"""Granite-3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] — MoE.

24L, d_model=1024, 16 heads (GQA kv=8, head_dim=64), per-expert d_ff=512,
vocab=49155, 32 experts top-8, tied embeddings.
"""
from ..nn.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=32, top_k=8, capacity_factor=1.25),
    tie_embeddings=True,
    long_context="sliding_override",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
