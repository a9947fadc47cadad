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

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.precision import ComputeMode, f32_matmul, mode_dot
from . import sharding as S
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

    On DTensors it runs on the local shards (:func:`sharding.local_map`),
    batch over the batch axes and, on 'model', the reference's choice: the
    KV-head groups where they divide it, else each group's query heads,
    else the head dim (each rank's partial scores summed over 'model'
    before the softmax), else none.
    """
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, scale=scale,
              q_chunk=q_chunk, k_chunk=k_chunk)
    if not isinstance(q, S.DTensor):
        return _chunk_attn_local(q, k, v, q_pos, k_pos, **kw)
    mesh = q.device_mesh
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    split = _model_split(h, kv, hd, S.axis_size(mesh, "model"))
    bx = S.BATCH
    if split == "groups":
        spec = (bx, None, "model", None)
        return S.local_map(functools.partial(_chunk_attn_local, **kw),
                           [q, k, v, q_pos, k_pos],
                           [_r(q, spec), _r(k, spec), _r(v, spec), None, None],
                           _r(q, spec))
    if split == "rep":
        q5 = S.reshape(q, (b, sq, kv, h // kv, hd))
        spec5 = (bx, None, None, "model", None)

        def by_rep(q5, k, v, q_pos, k_pos):
            bl, sl = q5.shape[:2]
            out = _chunk_attn_local(q5.reshape(bl, sl, -1, hd), k, v,
                                    q_pos, k_pos, **kw)
            return out.reshape(q5.shape)
        rest = (bx, None, None, None)
        out = S.local_map(by_rep, [q5, k, v, q_pos, k_pos],
                          [_r(q5, spec5), _r(k, rest), _r(v, rest), None, None],
                          _r(q5, spec5))
        return S.reshape(out, (b, sq, h, hd))
    spec = (bx, None, None, "model" if split == "hd" else None)
    # Each rank's scores are a partial sum over its slice of the head dim;
    # what follows (p @ v) is split over 'model' again, so the gradient of
    # the sum is the sum of the ranks' gradients.
    score_sum = (functools.partial(S.psum, mesh=mesh, axes=("model",), grad_sum=True)
                 if spec[3] else None)
    return S.local_map(functools.partial(_chunk_attn_local, score_sum=score_sum,
                                         **kw),
                       [q, k, v, q_pos, k_pos],
                       [_r(q, spec), _r(k, spec), _r(v, spec), None, None],
                       _r(q, spec))


def _model_split(h: int, kv: int, hd: int, msize: int) -> Optional[str]:
    """The reference's split of attention over 'model' (of size ``msize``):
    ``"groups"`` (the KV heads), ``"rep"`` (each group's query heads),
    ``"hd"`` (the head dim) or None, the first that 'model' divides."""
    rep = h // kv
    if kv % msize == 0 and kv >= msize:
        return "groups"
    if rep % msize == 0 and rep >= msize:
        return "rep"
    return "hd" if hd % msize == 0 else None


def _split_heads(fused: torch.Tensor, shape, h: int) -> torch.Tensor:
    """Fused (B, S, KV*hd) K or V as ``shape`` (B, S, KV, hd), laid out as
    :func:`_chunk_attn` asks for it: under the head-dim split, each rank's
    lanes of every head by one all-to-all (:func:`sharding.split_lanes`),
    where reshaping the fused shard would gather it whole."""
    if isinstance(fused, S.DTensor) and _model_split(
            h, shape[2], shape[3], S.axis_size(fused.device_mesh, "model")) == "hd":
        return S.split_lanes(fused, shape)
    return S.reshape(fused, shape)


def _r(t, axes):
    """The constraint ``axes`` of DTensor ``t`` as a spec on its mesh."""
    return S.resolve(t.shape, axes, t.device_mesh)


def _chunk_attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int, logit_cap: float,
                      scale: float, q_chunk: int, k_chunk: int,
                      score_sum=None) -> torch.Tensor:
    """:func:`_chunk_attn` on plain tensors.  ``score_sum``: applied to each
    block of scores before the softmax (the sum over the ranks that hold
    the other slices of the head dim).  ``q_pos`` and ``k_pos`` may be
    ``range``s (positions the host knows): where autograd does not record,
    a query chunk then skips the key chunks that none of its rows may
    attend to (after the causal mask or before the window), whose blocks
    would change nothing (see :func:`_live_key_chunks`)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    k_chunk = min(k_chunk, sk)
    q_chunk = min(q_chunk, sq)
    dev = q.device
    live = None
    if isinstance(q_pos, range) and isinstance(k_pos, range) and not (
            torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        live = _live_key_chunks(q_pos, k_pos, q_chunk, k_chunk, causal, window)
    as_tensor = lambda p: torch.arange(p.start, p.stop, p.step, device=dev) \
        if isinstance(p, range) else p.to(dev)
    q_pos, k_pos = as_tensor(q_pos), as_tensor(k_pos)

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
        if score_sum is not None:
            s = score_sum(s)
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
        for j in (live[i] if live is not None else range(n_k)):
            m, l, acc = checkpoint_if_recording(key_step, q_blk, kg, vg, qp,
                                                m, l, acc, j)
        return acc / torch.clamp(l, min=1e-30)[..., None]

    outs = [checkpoint_if_recording(
        query_rows, qg[:, :, :, i * q_chunk:(i + 1) * q_chunk], kg, vg, i)
        for i in range(n_q)]
    out = torch.cat(outs, dim=3)                          # (B,KV,rep,Sq',hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq + qpad, h, hd)[:, :sq]
    return out.to(q.dtype)


def _live_key_chunks(q_pos: range, k_pos: range, q_chunk: int, k_chunk: int,
                     causal: bool, window: int):
    """For each query chunk, the key chunks where some row has a key it may
    attend to, in order; every chunk for a query chunk that would have
    none.  The rest need not run: a block masked for every row adds
    ``exp(NEG_INF - m) = 0`` with ``alpha = 1`` once a row has seen a valid
    key, and before that it only feeds the running sums that the first
    valid block multiplies by ``alpha = exp(NEG_INF - m) = 0``.  Padded
    query rows sit at position 0, padded key slots at -1."""
    if q_pos.step != 1 or k_pos.step != 1 or len(k_pos) == 0 or k_pos.start < 0:
        return None
    sq, sk = len(q_pos), len(k_pos)
    n_q, n_k = -(-sq // q_chunk), -(-sk // k_chunk)

    def meets(a, b, klo, khi):      # rows at [a, b], keys at [klo, khi]
        if causal and window > 0:
            return max(a, klo) <= min(b, khi + window - 1)
        if causal:
            return b >= klo
        if window > 0:
            return a < khi + window
        return True
    live = []
    for i in range(n_q):
        rows = [(q_pos[i * q_chunk], q_pos[min((i + 1) * q_chunk, sq) - 1])]
        if (i + 1) * q_chunk > sq:
            rows.append((0, 0))
        js = [j for j in range(n_k)
              if any(meets(a, b, k_pos[j * k_chunk], k_pos[min((j + 1) * k_chunk, sk) - 1])
                     for a, b in rows)]
        live.append(js or list(range(n_k)))
    return live


def _project_qkv(params: dict, x: torch.Tensor, cfg, mode: ComputeMode):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = mode_dot(x, params["wq"].reshape(cfg.d_model, h * hd), mode)
    k = mode_dot(x, params["wk"].reshape(cfg.d_model, kv * hd), mode)
    v = mode_dot(x, params["wv"].reshape(cfg.d_model, kv * hd), mode)
    if cfg.qkv_bias:
        # On a mesh the products may come back as pending sums; the biases
        # add to the fused heads sharded on 'model', as they are.
        q, k, v = (S.constrain(t, S.BATCH, None, "model") for t in (q, k, v))
        q = q + params["bq"].reshape(-1).to(q.dtype)
        k = k + params["bk"].reshape(-1).to(k.dtype)
        v = v + params["bv"].reshape(-1).to(v.dtype)
    q = S.reshape(q, (b, s, h, hd))
    k = S.reshape(k, (b, s, kv, hd))
    v = S.reshape(v, (b, s, kv, hd))
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
                   positions: "torch.Tensor | range",
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
    q = S.constrain_heads(rope(q, positions, cfg.rope_theta))
    k = S.constrain_heads(rope(k, positions, cfg.rope_theta))
    v = S.constrain_heads(v)

    b, s = x.shape[0], x.shape[1]
    new_cache = None
    if cache is not None:
        cap = cache.capacity
        slot = cache_pos % cap
        cache.k[:, slot:slot + s] = S.reshape(k, (b, s, kv * hd)).to(cache.k.dtype)
        cache.v[:, slot:slot + s] = S.reshape(v, (b, s, kv * hd)).to(cache.v.dtype)
        new_cache = cache
        k_pos = ring_positions(cap, cache_pos, x.device)
        out = _chunk_attn(q, _split_heads(cache.k, (b, cap, kv, hd), h),
                          _split_heads(cache.v, (b, cap, kv, hd), h),
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
                S.reshape(k, (b, s, kv * hd)).to(mode.operand_dtype),
                S.reshape(v, (b, s, kv * hd)).to(mode.operand_dtype))

    out = S.constrain_heads(out)
    out = mode_dot(S.reshape(out, (b, s, h * hd)),
                   params["wo"].reshape(h * hd, cfg.d_model), mode)
    return S.constrain(out, S.BATCH, None, None), new_cache


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
    q = S.reshape(mode_dot(x, params["wq"].reshape(cfg.d_model, h * hd), mode),
                  (b, s, h, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["qnorm"], cfg.norm_eps)
    if precomputed_kv is not None:
        kf, vf = precomputed_kv
        se = kf.shape[1]
        k, v = (_split_heads(t, (b, se, kvh, hd), h) for t in (kf, vf))
    else:
        se = kv_src.shape[1]
        k = S.reshape(mode_dot(kv_src, params["wk"].reshape(cfg.d_model, kvh * hd),
                               mode), (b, se, kvh, hd))
        v = S.reshape(mode_dot(kv_src, params["wv"].reshape(cfg.d_model, kvh * hd),
                               mode), (b, se, kvh, hd))
        if cfg.qk_norm:
            k = rms_norm(k, params["knorm"], cfg.norm_eps)
    zeros = lambda n: torch.zeros((n,), dtype=torch.int64, device=x.device)
    out = _chunk_attn(q, k, v, q_pos=zeros(s), k_pos=zeros(se), causal=False,
                      window=0, logit_cap=cfg.attn_logit_softcap, scale=scale)
    out = mode_dot(S.reshape(out, (b, s, h * hd)),
                   params["wo"].reshape(h * hd, cfg.d_model), mode)
    if precomputed_kv is not None:
        return out, precomputed_kv
    return out, (S.reshape(k, (b, se, kvh * hd)), S.reshape(v, (b, se, kvh * hd)))
