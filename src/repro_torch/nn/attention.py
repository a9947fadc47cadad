"""Attention: GQA with rope / qk-norm / bias / softcap, causal and
sliding-window masks, chunked (online-softmax) execution, KV-cache decode.

The port of ``repro.nn.attention``: self-attention and cross-attention to
encoder or image tokens.  The chunked formulation walks key blocks with a running (max, denominator,
accumulator) triple, so the S x S score matrix is never materialized.  It is
plain tensor code of the reference's ``_chunk_attn`` arithmetic, not
``F.scaled_dot_product_attention``, which has neither the logit softcap nor
the reference's invalid-slot semantics:

* the KV heads are never repeated: each KV head is contracted against its
  ``rep`` query heads;
* operands keep their incoming dtype (bf16 under RELAXED) and products
  accumulate in f32, as the reference's ``preferred_element_type=f32``
  does: bf16 operands are widened (exactly) and multiplied in f32 with
  TF32 off (:func:`f32_matmul`, the backward's products too);
* where autograd records, each query chunk and, inside it, each key chunk
  is checkpointed, as the reference's nested ``jax.checkpoint``: the
  backward keeps no (B, KV, rep, q_chunk, k_chunk) score block;
* a masked score is ``NEG_INF = -0.7 * f32max``, a slot at position < 0 is
  unwritten and never attended to, and a fully masked row divides by
  ``max(l, 1e-30)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.precision import ComputeMode, f32_matmul, mode_dot
from .layers import checkpoint_if_recording, rms_norm, rope, softcap

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class KVCache(NamedTuple):
    """Fixed-capacity cache of one layer.  For sliding-window layers the
    capacity is the window and writes wrap (a ring buffer).  Storage is
    fused (B, C, KV*hd), as in the reference."""
    k: torch.Tensor            # (B, C, KV*hd)
    v: torch.Tensor            # (B, C, KV*hd)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def _pad_dim1(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with ``n`` zero rows appended along dim 1."""
    if n == 0:
        return t
    shape = list(t.shape)
    shape[1] = n
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def _chunk_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: int, logit_cap: float, scale: float,
                q_chunk: int = 256, k_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention, GQA-native and double-chunked.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0; q_pos: (Sq,),
    k_pos: (Sk,) absolute positions (pos < 0 = an invalid slot).  Returns
    (B, Sq, H, hd) in q's dtype.
    """
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    k_chunk = min(k_chunk, sk)
    q_chunk = min(q_chunk, sq)
    dev = q.device
    q_pos = q_pos.to(dev)
    k_pos = k_pos.to(dev)

    kpad = (-sk) % k_chunk
    k, v = _pad_dim1(k, kpad), _pad_dim1(v, kpad)
    k_pos = torch.cat([k_pos, torch.full((kpad,), -1, dtype=k_pos.dtype,
                                         device=dev)])
    qpad = (-sq) % q_chunk
    q = _pad_dim1(q, qpad)
    q_pos = torch.cat([q_pos, torch.zeros((qpad,), dtype=q_pos.dtype,
                                          device=dev)])
    n_k = k.shape[1] // k_chunk
    n_q = q.shape[1] // q_chunk

    cdt = q.dtype                                         # compute dtype
    # (B, KV, rep, Sq', hd): head j = g*rep + r, matching fused storage.
    qg = (q * scale).to(cdt).reshape(b, q.shape[1], kv, rep, hd) \
        .permute(0, 2, 3, 1, 4).float()
    kg = k.to(cdt).permute(0, 2, 1, 3).float()           # (B, KV, Sk', hd)
    vg = v.to(cdt).permute(0, 2, 1, 3).float()

    def key_step(q_blk, kg, vg, qp, m, l, acc, j):
        k_blk = kg[:, :, j * k_chunk:(j + 1) * k_chunk]
        v_blk = vg[:, :, j * k_chunk:(j + 1) * k_chunk]
        kp = k_pos[j * k_chunk:(j + 1) * k_chunk]
        s = f32_matmul(q_blk, k_blk[:, :, None].transpose(-1, -2))
        s = softcap(s, logit_cap)
        valid = (kp[None, :] >= 0)
        if causal:
            valid = valid & (kp[None, :] <= qp[:, None])
        if window > 0:
            valid = valid & (kp[None, :] > qp[:, None] - window)
        s = s.masked_fill(~valid, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + f32_matmul(p.to(cdt).float(),
                                                  v_blk[:, :, None])
        return m_cur, l, acc

    def query_rows(q_blk, kg, vg, i):
        qp = q_pos[i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((b, kv, rep, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kv, rep, q_chunk), device=dev)
        acc = torch.zeros((b, kv, rep, q_chunk, hd), device=dev)
        for j in range(n_k):
            m, l, acc = checkpoint_if_recording(key_step, q_blk, kg, vg, qp,
                                                m, l, acc, j)
        return acc / torch.clamp(l, min=1e-30)[..., None]

    outs = [checkpoint_if_recording(
        query_rows, qg[:, :, :, i * q_chunk:(i + 1) * q_chunk], kg, vg, i)
        for i in range(n_q)]
    out = torch.cat(outs, dim=3)                          # (B,KV,rep,Sq',hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq + qpad, h, hd)[:, :sq]
    return out.to(q.dtype)


def _project_qkv(params: dict, x: torch.Tensor, cfg, mode: ComputeMode):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = mode_dot(x, params["wq"].reshape(cfg.d_model, h * hd), mode)
    k = mode_dot(x, params["wk"].reshape(cfg.d_model, kv * hd), mode)
    v = mode_dot(x, params["wv"].reshape(cfg.d_model, kv * hd), mode)
    if cfg.qkv_bias:
        q = q + params["bq"].reshape(-1).to(q.dtype)
        k = k + params["bk"].reshape(-1).to(k.dtype)
        v = v + params["bv"].reshape(-1).to(v.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["qnorm"], cfg.norm_eps)
        k = rms_norm(k, params["knorm"], cfg.norm_eps)
    return q, k, v


def ring_positions(capacity: int, pos: int,
                   device: "torch.device | str") -> torch.Tensor:
    """Absolute position of each slot of a ring of ``capacity`` slots once
    position ``pos`` is written there (slot ``pos % capacity``); -1 for a
    slot not written yet."""
    idx = torch.arange(capacity, device=device)
    slot, wraps = pos % capacity, pos // capacity
    pos_abs = torch.where(idx <= slot, wraps * capacity + idx,
                          (wraps - 1) * capacity + idx)
    return torch.where(pos_abs <= pos, pos_abs, torch.full_like(pos_abs, -1))


def self_attention(params: dict, x: torch.Tensor, cfg, *,
                   positions: torch.Tensor,
                   causal: bool = True, window: int = 0,
                   cache: Optional[KVCache] = None,
                   cache_pos: Optional[int] = None,
                   return_cache: bool = False,
                   mode: ComputeMode = ComputeMode.RELAXED
                   ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention for prefill (``return_cache=True``) and decode
    (``cache`` given; ``x`` is the one new token at ``cache_pos``).

    Decode writes the new K/V into ``cache`` in place, at slot
    ``cache_pos % capacity`` (a ring for sliding-window layers), and returns
    it.  Returns (out, cache or None).
    """
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    q, k, v = _project_qkv(params, x, cfg, mode)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    b, s = x.shape[0], x.shape[1]
    new_cache = None
    if cache is not None:
        cap = cache.capacity
        slot = cache_pos % cap
        cache.k[:, slot:slot + s] = k.reshape(b, s, kv * hd).to(cache.k.dtype)
        cache.v[:, slot:slot + s] = v.reshape(b, s, kv * hd).to(cache.v.dtype)
        new_cache = cache
        k_pos = ring_positions(cap, cache_pos, x.device)
        out = _chunk_attn(q, cache.k.reshape(b, cap, kv, hd),
                          cache.v.reshape(b, cap, kv, hd),
                          q_pos=positions, k_pos=k_pos, causal=causal,
                          window=window, logit_cap=cfg.attn_logit_softcap,
                          scale=scale)
    else:
        out = _chunk_attn(q, k, v, q_pos=positions, k_pos=positions,
                          causal=causal, window=window,
                          logit_cap=cfg.attn_logit_softcap, scale=scale)
        if return_cache:
            # The cache dtype follows the mode (bf16 unless PRECISE).
            new_cache = KVCache(
                k.reshape(b, s, kv * hd).to(mode.operand_dtype),
                v.reshape(b, s, kv * hd).to(mode.operand_dtype))

    out = mode_dot(out.reshape(b, s, h * hd),
                   params["wo"].reshape(h * hd, cfg.d_model), mode)
    return out, new_cache


def cross_attention(params: dict, x: torch.Tensor,
                    kv_src: Optional[torch.Tensor], cfg, *,
                    mode: ComputeMode = ComputeMode.RELAXED,
                    precomputed_kv: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None):
    """Cross-attention to encoder / image tokens: no mask, no rope.

    kv_src: (B, S_enc, d), or None when ``precomputed_kv`` (the fused
    (B, S_enc, KV*hd) K and V a prefill returned) is given; ``knorm`` is
    applied only where the keys are computed.  Returns (out, (k, v)) with
    k and v fused, in the projection's dtype.
    """
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(hd)
    q = mode_dot(x, params["wq"].reshape(cfg.d_model, h * hd), mode) \
        .reshape(b, s, h, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["qnorm"], cfg.norm_eps)
    if precomputed_kv is not None:
        kf, vf = precomputed_kv
        se = kf.shape[1]
        k, v = kf.reshape(b, se, kvh, hd), vf.reshape(b, se, kvh, hd)
    else:
        se = kv_src.shape[1]
        k = mode_dot(kv_src, params["wk"].reshape(cfg.d_model, kvh * hd),
                     mode).reshape(b, se, kvh, hd)
        v = mode_dot(kv_src, params["wv"].reshape(cfg.d_model, kvh * hd),
                     mode).reshape(b, se, kvh, hd)
        if cfg.qk_norm:
            k = rms_norm(k, params["knorm"], cfg.norm_eps)
    zeros = lambda n: torch.zeros((n,), dtype=torch.int64, device=x.device)
    out = _chunk_attn(q, k, v, q_pos=zeros(s), k_pos=zeros(se), causal=False,
                      window=0, logit_cap=cfg.attn_logit_softcap, scale=scale)
    out = mode_dot(out.reshape(b, s, h * hd),
                   params["wo"].reshape(h * hd, cfg.d_model), mode)
    return out, (k.reshape(b, se, kvh * hd), v.reshape(b, se, kvh * hd))
