"""Mamba-style selective SSM (the hymba hybrid blocks).

The port of ``repro.nn.ssm``.  Per-channel state h (N-dim) with
input-dependent gates::

    h_t = exp(-dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

Prefill walks the prompt in chunks of 256 steps and scans each chunk's
(decay, increment) pairs with :func:`_ssm_scan`, the reference's
``jax.lax.associative_scan`` (log depth) restated step for step, so the f32
products are taken in the reference's order.  Decode carries a
(B, d_inner, N) state and takes one recurrence step.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ..core.precision import ComputeMode, f32_einsum, mode_dot
from .layers import checkpoint_if_recording
from .sharding import BATCH, constrain, local_map, resolve, zeros_placed_like


class SSMState(NamedTuple):
    h: torch.Tensor            # (B, d_inner, N) f32
    conv: torch.Tensor         # (B, conv_width - 1, d_inner) rolling input tail


def _combine(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    d1, i1 = a
    d2, i2 = b
    return [d1 * d2, d2 * i1 + i2]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ... (even may be one longer)."""
    shape = list(even.shape)
    shape[1] = even.shape[1] + odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.associative_scan(_combine, elems, axis=1)``, the same
    recursion: combine adjacent pairs, scan the half, then fill in the
    even positions from the odd ones."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([o[:, :-1] for o in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _ssm_scan(decay: torch.Tensor, inc: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scan of h_t = decay_t * h_{t-1} + inc_t over dim 1 (time).

    decay, inc: (B, S, d_inner, N).  Returns h for every t.
    """
    if h0 is not None:
        inc = torch.cat([inc[:, :1] + decay[:, :1] * h0[:, None], inc[:, 1:]],
                        dim=1)
    return _associative_scan([decay, inc])[1]


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor]):
    """Depthwise causal conv as the reference's sum of shifted taps (no
    cuDNN: an f32 ``conv1d`` on the card would run in TF32).
    x: (B, S, di); w: (cw, di); tail: (B, cw-1, di)."""
    cw = w.shape[0]
    if tail is None:
        tail = zeros_placed_like(x, (x.shape[0], cw - 1, x.shape[-1]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)          # (B, S+cw-1, di)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * w[i]
    new_tail = xp[:, -(cw - 1):] if cw > 1 else tail
    return out, new_tail


def _pad_time(t: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """``t`` with ``n`` steps of ``value`` appended along dim 1 (time)."""
    if n == 0:
        return t
    shape = list(t.shape)
    shape[1] = n
    return torch.cat([t, t.new_full(shape, value)], dim=1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_mixer(params: dict, x: torch.Tensor, cfg, *,
                state: Optional[SSMState] = None,
                mode: ComputeMode = ComputeMode.RELAXED):
    """x: (B, S, d) -> ((B, S, d), the state after the last step).
    ``state`` given: continue from it.

    params: w_in (d, 2*di), conv_w (cw, di), w_dt (di, di), dt_bias (di,),
    A_log (di, N), w_B / w_C (di, N), D (di,), w_out (di, d).
    """
    ssm = cfg.ssm
    b, s, _ = x.shape
    di = ssm.expand * cfg.d_model
    n = ssm.state_dim

    xz = mode_dot(x, params["w_in"], mode)                # (B, S, 2di)
    xin, z = torch.chunk(xz, 2, dim=-1)
    xin, new_tail = _causal_conv(xin, params["conv_w"].to(xin.dtype),
                                 state.conv if state is not None else None)
    xin = F.silu(xin)

    a = -torch.exp(params["A_log"].float())               # (di, N), negative
    # On a mesh: d_inner on 'model' (the product may be a pending sum).
    dt = softplus(constrain(mode_dot(xin, params["w_dt"], mode), BATCH, None, "model")
                  .float() + params["dt_bias"].float())   # (B, S, di)
    bmat = mode_dot(xin, params["w_B"], mode).float()     # (B, S, N)
    cmat = mode_dot(xin, params["w_C"], mode).float()
    xf = xin.float()

    args = (a, dt, xf, bmat, cmat, state.h if state is not None else None)
    if isinstance(x, DTensor):
        # Channels (d_inner) on 'model', as the reference constrains the
        # chunk's decay and increment; the recurrence is per channel.
        mesh = x.device_mesh
        chan = resolve((b, s, di), (BATCH, None, "model"), mesh)
        vec = chan[:2] + (None,)
        st = (chan[0], chan[2], None)
        y, h = local_map(_scan, list(args),
                         [(chan[2], None), chan, chan, vec, vec, st], [chan, st])
    else:
        y, h = _scan(*args)
    y = y + xf * params["D"].float()
    y = y.to(mode.operand_dtype) * F.silu(z)
    return mode_dot(y, params["w_out"], mode), SSMState(h=h, conv=new_tail)


def _scan(a: torch.Tensor, dt: torch.Tensor, xf: torch.Tensor,
          bmat: torch.Tensor, cmat: torch.Tensor, h: Optional[torch.Tensor]):
    """The selective scan of :func:`mamba_mixer` on plain tensors: (y before
    the skip term (B, S, di), the state after the last step)."""
    b, s, di = dt.shape
    if h is None:
        h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                        device=dt.device)
    if s == 1:   # decode: one recurrence step
        decay = torch.exp(dt[..., None] * a)                     # (B, 1, di, N)
        inc = (dt * xf)[..., None] * bmat[:, :, None, :]
        h = decay[:, 0] * h + inc[:, 0]
        y = f32_einsum("bdn,bn->bd", h, cmat[:, 0])[:, None]
    else:
        # One chunk's (B, chunk, di, N) gate tensors at a time; the last
        # chunk is zero-padded (decay 1, increment 0), as the reference
        # pads it, so its state is the scan's last element.  Where autograd
        # records, each chunk is checkpointed (the reference's
        # ``jax.checkpoint`` on ``chunk_body``): the backward keeps no
        # chunk's h_all, decay or increment.
        chunk = min(256, s)
        pad = (-s) % chunk
        dt_c, x_c, b_c, c_c = (_pad_time(t, pad) for t in (dt, xf, bmat, cmat))

        def chunk_body(h, a, dt_b, x_b, bm_b, cm_b):
            decay = torch.exp(dt_b[..., None] * a)
            inc = (dt_b * x_b)[..., None] * bm_b[:, :, None, :]
            h_all = _ssm_scan(decay, inc, h)
            return h_all[:, -1], f32_einsum("bsdn,bsn->bsd", h_all, cm_b)

        ys = []
        for c0 in range(0, s + pad, chunk):
            sl = slice(c0, c0 + chunk)
            h, y_b = checkpoint_if_recording(chunk_body, h, a, dt_c[:, sl],
                                             x_c[:, sl], b_c[:, sl], c_c[:, sl])
            ys.append(y_b)
        y = torch.cat(ys, dim=1)[:, :s]
    return y, h
