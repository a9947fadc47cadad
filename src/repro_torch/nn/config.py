"""Unified model configuration for the assigned architecture pool.

The port's own copy of ``repro.nn.config``: one dataclass covers dense / MoE
/ SSM / hybrid / VLM / audio backbones, and each
``src/repro_torch/configs/<id>.py`` instantiates it with the published
hyper-parameters (source cited per config).  ``block_pattern`` gives the
kind of each layer: layer ``i`` is ``block_pattern[i % len(block_pattern)]``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # expert-parallel (shard experts over "model", all-to-all dispatch) vs
    # replicated experts (no all-to-all; right answer for tiny experts —
    # see EXPERIMENTS.md §Perf granite hillclimb)
    expert_parallel: bool = True


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16          # N: per-channel recurrent state size
    conv_width: int = 4          # depthwise conv in the mamba block
    expand: int = 2              # d_inner = expand * d_model
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # block pattern, length P; num_layers % P == 0.  Kinds:
    #   attn         self-attention + MLP (or MoE) block
    #   attn_local   sliding-window self-attention + MLP
    #   attn_global  full self-attention + MLP
    #   cross        self-attention + cross-attention + MLP (vlm/enc-dec)
    #   hybrid       parallel attention + mamba heads (hymba)
    #   mlstm        xLSTM matrix-memory block
    #   slstm        xLSTM scalar-memory block
    block_pattern: Tuple[str, ...] = ("attn",)
    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 4096           # used by attn_local layers
    rope_theta: float = 10000.0
    # ffn
    ffn_activation: str = "silu"         # silu | gelu
    parallel_block: bool = False         # Cohere-style attn+ffn in parallel
    # mixture of experts (d_ff is per-expert when moe is set)
    moe: Optional[MoEConfig] = None
    # ssm / hybrid
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (audio): encoder consumes stubbed frame embeddings
    encoder_layers: int = 0
    encoder_seq: int = 0                 # e.g. whisper 1500 frames
    # vlm: image tokens cross-attended by 'cross' layers (stubbed encoder)
    num_image_tokens: int = 0
    # norms
    norm_eps: float = 1e-6
    sandwich_norm: bool = False          # gemma2 pre+post block norms
    scale_embed: bool = False            # gemma2 embeds * sqrt(d_model)
    tie_embeddings: bool = False
    # huge models: keep weights 2-D sharded (model x data) even at inference
    shard_weights_2d_infer: bool = False
    # layer-scan rematerialization: "full" (recompute everything) or
    # "dots" (save matmul outputs — ~25% fewer executed FLOPs for ~2x
    # activation memory; §Perf command-r hillclimb)
    remat_policy: str = "full"
    # long-context policy: "native" (ssm / windowed by design),
    # "sliding_override" (dense archs swap to windowed attention for the
    # long_500k shape), or "skip" (whisper)
    long_context: str = "sliding_override"
    long_context_window: int = 32768
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.pattern_period == 0, \
            (self.name, self.num_layers, self.block_pattern)
        return self.num_layers // self.pattern_period

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def scaled_down(self, *, layers: Optional[int] = None, d_model: int = 256,
                    experts: int = 4) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests (2 layers,
        d_model<=512, <=4 experts per the spec)."""
        period = self.pattern_period
        n_layers = layers or max(2, period)
        if n_layers % period:
            n_layers = period
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        hd = max(16, d_model // heads)
        moe = None
        if self.moe is not None:
            n_exp = min(self.moe.num_experts, experts)
            # cf >= E makes routing lossless: smoke tests stay deterministic
            moe = MoEConfig(num_experts=n_exp,
                            top_k=min(self.moe.top_k, 2),
                            capacity_factor=max(self.moe.capacity_factor,
                                                float(n_exp)))
        return dataclasses.replace(
            self, num_layers=n_layers, d_model=d_model, num_heads=heads,
            num_kv_heads=kv, head_dim=hd,
            d_ff=max(32, d_model * 2 if self.d_ff else 0),
            vocab_size=min(self.vocab_size, 1024),
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            num_image_tokens=min(self.num_image_tokens, 16) if self.num_image_tokens else 0,
            sliding_window=min(self.sliding_window, 64),
            long_context_window=min(self.long_context_window, 64),
            moe=moe)
