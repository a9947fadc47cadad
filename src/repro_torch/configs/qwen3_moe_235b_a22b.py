"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family] — 128-expert top-8 MoE.

94L, d_model=4096, 64 heads (GQA kv=4, head_dim=128), per-expert d_ff=1536,
vocab=151936, qk_norm, 128 experts top-8.
"""
from ..nn.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, capacity_factor=1.25),
    shard_weights_2d_infer=True,
    long_context="sliding_override",
    citation="hf:Qwen/Qwen3-30B-A3B",
)
