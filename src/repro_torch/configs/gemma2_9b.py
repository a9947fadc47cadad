"""Gemma2-9B [arXiv:2408.00118] — alternating local/global attention.

42L, d_model=3584, 16 heads (GQA kv=8, head_dim=256), d_ff=14336,
vocab=256000; sliding window 4096 on local layers, attention-logit softcap
50, final-logit softcap 30, sandwich (pre+post) norms, scaled embeddings,
tied embeddings.  long_500k runs: local layers are windowed by design and
global layers decode in O(context) with a sharded cache.
"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=("attn_local", "attn_global"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sandwich_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    ffn_activation="gelu",
    long_context="native",
    citation="arXiv:2408.00118",
)
