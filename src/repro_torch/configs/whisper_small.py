"""Whisper-small [arXiv:2212.04356] — encoder-decoder audio backbone.

12L encoder + 12L decoder, d_model=768, 12 heads (MHA kv=12), d_ff=3072,
vocab=51865, GELU.  Conv/mel frontend is STUBBED per spec: input_specs()
feeds precomputed frame embeddings (B, 1500, 768).  Decoder layers each
carry self- plus cross-attention ("cross" pattern).  long_500k is SKIPPED
(DESIGN.md): the decoder is bounded (<<4k) by construction.
"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    block_pattern=("cross",),
    encoder_layers=12,
    encoder_seq=1500,
    ffn_activation="gelu",
    long_context="skip",
    citation="arXiv:2212.04356",
)
