"""Model assembly for the dense family: params, prefill and decode.

The port of ``repro.nn.model`` for the configs whose blocks are all
``attn`` / ``attn_local`` / ``attn_global`` and that have no MoE, SSM,
encoder or image tokens: Qwen2-7B, Qwen3-32B, Command R+ and Gemma-2-9B.
Any other config raises ``NotImplementedError`` (ROADMAP.md queue 1), never
a partial model.

The reference scans a stack of ``(G, ...)`` parameters over pattern periods;
the port keeps one parameter dict per layer (``params["layers"][i]``, of
kind ``cfg.block_pattern[i % P]``) and runs them in a Python loop.
:func:`params_from_reference` unstacks the reference's tree into that form,
which is how the tests run both packages on the same weights.  The
reference's sharding constraints are the identity on one card and are not
ported.  Training (``forward``/``loss_fn``) waits for the training slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.precision import ComputeMode
from .attention import KVCache, self_attention
from .config import ModelConfig
from .layers import embed, mlp, rms_norm, unembed

DENSE_KINDS = ("attn", "attn_local", "attn_global")

Params = Dict[str, Any]


def require_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run whole."""
    missing = [what for what, present in (
        ("MoE", cfg.moe is not None), ("SSM", cfg.ssm is not None),
        ("an encoder", cfg.is_encoder_decoder),
        ("image tokens", cfg.num_image_tokens > 0)) if present]
    missing += [f"block kind {k!r}" for k in dict.fromkeys(cfg.block_pattern)
                if k not in DENSE_KINDS]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense family only; "
            f"{', '.join(missing)} is not ported yet (ROADMAP.md queue 1)")


# ---------------------------------------------------------------------------
# Parameters: name -> (shape, fan_in); fan_in 0 = zero-initialized
# ---------------------------------------------------------------------------

def _layer_defs(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {"ln1": ((d,), 0),
         "wq": ((d, h * hd), d), "wk": ((d, kv * hd), d),
         "wv": ((d, kv * hd), d), "wo": ((h * hd, d), h * hd)}
    if cfg.qkv_bias:
        p.update(bq=((h * hd,), 0), bk=((kv * hd,), 0), bv=((kv * hd,), 0))
    if cfg.qk_norm:
        p.update(qnorm=((hd,), 0), knorm=((hd,), 0))
    if cfg.sandwich_norm:
        p["ln1_post"] = ((d,), 0)
    if not cfg.parallel_block:
        p["ln2"] = ((d,), 0)
        if cfg.sandwich_norm:
            p["ln2_post"] = ((d,), 0)
    if cfg.d_ff > 0:
        f = cfg.d_ff
        p.update(wg=((d, f), d), wu=((d, f), d), wd=((f, d), f))
    return p


def _top_defs(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    d, v = cfg.d_model, cfg.vocab_size
    p = {"embed": ((v, d), d), "final_norm": ((d,), 0)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((d, v), d)
    return p


def layer_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.block_pattern[i % cfg.pattern_period]


def init_params(cfg: ModelConfig, generator: Union[torch.Generator, int],
                device: "str | torch.device" = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights drawn on ``device``: normal with the reference's
    ``1/sqrt(fan_in)`` scale, norms and biases zero.  ``generator`` is a
    ``torch.Generator`` on that device, or a seed for one."""
    require_dense(cfg)
    device = torch.device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))

    def draw(shape, fan_in):
        if fan_in == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * (1.0 / math.sqrt(fan_in))

    params: Params = {n: draw(*d) for n, d in _top_defs(cfg).items()}
    params["layers"] = [{n: draw(*d) for n, d in _layer_defs(cfg).items()}
                        for _ in range(cfg.num_layers)]
    return params


def num_params(cfg: ModelConfig) -> int:
    count = lambda defs: sum(math.prod(s) for s, _ in defs.values())
    return count(_top_defs(cfg)) + cfg.num_layers * count(_layer_defs(cfg))


def _as_tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":           # ml_dtypes: through the bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_reference(cfg: ModelConfig, np_params: Dict[str, Any], *,
                          device: "str | torch.device" = "cuda",
                          dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's parameter tree (``repro.nn.model.init_params``
    layout; arrays as numpy or anything ``np.asarray`` takes) as the port's.

    ``np_params["blocks"]`` holds one dict per pattern position, each leaf
    stacked ``(G, ...)`` over the groups; layer ``g * P + p`` of the port is
    entry ``g`` of position ``p``.
    """
    require_dense(cfg)
    out: Params = {n: _as_tensor(np_params[n], device, dtype)
                   for n in _top_defs(cfg)}
    blocks = np_params["blocks"]
    period = cfg.pattern_period
    out["layers"] = [
        {n: _as_tensor(np.asarray(blocks[i % period][n])[i // period],
                       device, dtype)
         for n in _layer_defs(cfg)}
        for i in range(cfg.num_layers)]
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def resolve_window(cfg: ModelConfig, kind: str, window_override: int) -> int:
    if kind == "attn_local":
        return cfg.sliding_window
    if window_override > 0:
        return window_override
    return 0


def apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, mode: ComputeMode,
                window_override: int = 0, cache: Optional[KVCache] = None,
                cache_pos: Optional[int] = None, return_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One dense block; returns (x, the layer's cache or None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, new_cache = self_attention(
        p, h, cfg, positions=positions, causal=True,
        window=resolve_window(cfg, kind, window_override), cache=cache,
        cache_pos=cache_pos, return_cache=return_cache, mode=mode)
    if cfg.sandwich_norm:
        attn_out = rms_norm(attn_out, p["ln1_post"], cfg.norm_eps)
    if cfg.parallel_block:
        f = mlp(p, h, activation=cfg.ffn_activation, mode=mode)
        return x + attn_out + f, new_cache
    x = x + attn_out
    if cfg.d_ff > 0:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        f = mlp(p, h2, activation=cfg.ffn_activation, mode=mode)
        if cfg.sandwich_norm:
            f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
        x = x + f
    return x, new_cache


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  mode: ComputeMode) -> torch.Tensor:
    x = embed(params["embed"], tokens).to(mode.operand_dtype)
    if cfg.scale_embed:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    return x


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig,
            mode: ComputeMode) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, head, tied=cfg.tie_embeddings,
                   final_cap=cfg.final_logit_softcap, mode=mode)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, kind: str, seq_len: int,
                   window_override: int) -> int:
    w = resolve_window(cfg, kind, window_override)
    return min(seq_len, w) if w > 0 else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               window_override: int = 0, dtype: torch.dtype = torch.bfloat16,
               device: "str | torch.device" = "cuda") -> List[KVCache]:
    """A zero decode cache for a context of ``seq_len``, one per layer."""
    require_dense(cfg)
    width = cfg.num_kv_heads * cfg.resolved_head_dim

    def kv(kind):
        cap = cache_capacity(cfg, kind, seq_len, window_override)
        return KVCache(*(torch.zeros((batch, cap, width), dtype=dtype,
                                     device=device) for _ in range(2)))
    return [kv(layer_kind(cfg, i)) for i in range(cfg.num_layers)]


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            capacity: Optional[int] = None,
            mode: ComputeMode = ComputeMode.RELAXED,
            window_override: int = 0
            ) -> Tuple[torch.Tensor, List[KVCache]]:
    """Process the prompt: (B, S) tokens -> (last-token logits (B, V) in f32,
    one decode cache per layer).  ``capacity`` (>= S, default S) sizes the
    caches; a windowed layer keeps its last ``window`` tokens at slots
    ``pos % window``."""
    require_dense(cfg)
    b, s = tokens.shape
    capacity = capacity or s
    if capacity < s:
        raise ValueError(f"prefill of {s} tokens is longer than the cache "
                         f"capacity {capacity}")
    x = _embed_tokens(params, tokens, cfg, mode)
    positions = torch.arange(s, device=x.device)

    def expand_kv(kvc: KVCache, kind: str) -> KVCache:
        cap = cache_capacity(cfg, kind, capacity, window_override)
        if cap >= s:
            pad = lambda a: torch.cat(
                [a, a.new_zeros((b, cap - s, a.shape[2]))], dim=1)
            return KVCache(pad(kvc.k), pad(kvc.v))
        ring = lambda a: torch.roll(a[:, -cap:], s % cap, dims=1)
        return KVCache(ring(kvc.k), ring(kvc.v))

    caches = []
    for i, p in enumerate(params["layers"]):
        kind = layer_kind(cfg, i)
        x, kvc = apply_block(kind, p, x, cfg, positions=positions, mode=mode,
                             window_override=window_override,
                             return_cache=True)
        caches.append(expand_kv(kvc, kind))
    return _logits(params, x[:, -1:], cfg, mode)[:, 0], caches


def decode_step(params: Params, caches: List[KVCache], token: torch.Tensor,
                pos: int, cfg: ModelConfig, *,
                mode: ComputeMode = ComputeMode.RELAXED,
                window_override: int = 0
                ) -> Tuple[torch.Tensor, List[KVCache]]:
    """One serving step: the (B, 1) token at position ``pos`` -> (B, V)
    logits in f32.  Writes each layer's new K/V into ``caches`` in place and
    returns them."""
    require_dense(cfg)
    pos = int(pos)
    x = _embed_tokens(params, token, cfg, mode)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    for i, (p, cache) in enumerate(zip(params["layers"], caches)):
        x, _ = apply_block(layer_kind(cfg, i), p, x, cfg, positions=positions,
                           mode=mode, window_override=window_override,
                           cache=cache, cache_pos=pos)
    return _logits(params, x, cfg, mode)[:, 0], caches
