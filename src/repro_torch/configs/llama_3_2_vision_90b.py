"""Llama-3.2-Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision family] — VLM.

100L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=28672,
vocab=128256; cross-attention image layers every 5th layer (20 of 100).
Vision encoder + projector STUBBED per spec: input_specs() feeds projected
patch embeddings (B, 1601, 8192).
"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    num_image_tokens=1601,
    rope_theta=5e5,
    shard_weights_2d_infer=True,
    long_context="sliding_override",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
)
