"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01 family] — dense GQA.

64L, d_model=12288, 96 heads (GQA kv=8, head_dim=128), d_ff=33792,
vocab=256000, no biases, Cohere-style *parallel* attention+FFN blocks.
Large enough that weights stay 2-D sharded even when serving.
"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    parallel_block=True,
    rope_theta=75e6,
    shard_weights_2d_infer=True,
    long_context="sliding_override",
    citation="hf:CohereForAI/c4ai-command-r-v01",
)
