"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrence), after Beck et al., arXiv:2405.04517.

The port of ``repro.nn.xlstm``.  Both use exponential gating with the
max-stabilizer m_t; states start at ``m = -1e30``.  Prefill runs the mLSTM
chunkwise (:func:`_mlstm_cell`: matmuls and cumulative sums inside a chunk,
the (C, n, m) state carried across chunks), decode takes one step of the
recurrence (:func:`_mlstm_step`).  The sLSTM is a step-by-step recurrence
over time in both.

Shapes: B batch, S time, H heads, hd = 2*d/H head dim, di = 2*d inner.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ..core.precision import ComputeMode, f32_einsum, f32_scalar, mode_dot
from .layers import checkpoint_if_recording, rms_norm
from .sharding import BATCH, local_map, reshape, resolve
from .ssm import _causal_conv, _pad_time

#: The stabilizer's start and the log input gate of a padded step.
NEG_BIG = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor        # (B, H, hd, hd) matrix memory
    n: torch.Tensor        # (B, H, hd) normalizer
    m: torch.Tensor        # (B, H) stabilizer
    conv: torch.Tensor     # (B, cw-1, di) conv tail


class SLSTMState(NamedTuple):
    c: torch.Tensor        # (B, d)
    n: torch.Tensor        # (B, d)
    h: torch.Tensor        # (B, d)
    m: torch.Tensor        # (B, d)


def _mlstm_step(carry, xs):
    """One step of the stabilized mLSTM recurrence (the decode path).
    carry: (c, n, m); xs: q, k, v (B, H, hd) and log_i, log_f (B, H)."""
    c, n, m = carry
    qt, kt, vt, li, lf = xs
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)[..., None]                # (B, H, 1)
    f_p = torch.exp(lf + m - m_new)[..., None]
    c = f_p[..., None] * c + i_p[..., None] * (vt[..., :, None] * kt[..., None, :])
    n = f_p * n + i_p * kt
    denom = torch.maximum(torch.abs(torch.sum(n * qt, dim=-1, keepdim=True)),
                          torch.exp(-m_new)[..., None])
    y = f32_einsum("bhvk,bhk->bhv", c, qt) / denom
    return (c, n, m_new), y


def _mlstm_chunk(carry, qc, kc, vc, lic, lfc):
    """One chunk of the chunkwise-parallel mLSTM (the reference's
    ``chunk_body``): carry (c0, n0, m0); qc, kc, vc (B, L, H, hd); lic, lfc
    (B, L, H).  Returns the chunk-end state and y (B, L, H, hd)."""
    c0, n0, m0 = carry
    f_cum = torch.cumsum(lfc, dim=1)                      # F_t (B, L, H)
    a = lic - f_cum                                       # a_tau
    m0r = m0[:, None]                                     # (B, 1, H)
    m_run = torch.maximum(torch.cummax(a, dim=1).values, m0r)   # M_t
    # Pairwise coefficient exp(a_tau - M_t) for tau <= t: (B, t, tau, H).
    # The exponent is masked before exp (the reference masks after it): the
    # values are the same, but exp(a_tau - M_t) for tau > t overflows to inf
    # over a long chunk, and its gradient through the mask is then 0 * inf.
    L = qc.shape[1]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=qc.device))
    e = torch.exp((a[:, None, :, :] - m_run[:, :, None, :])
                  .masked_fill(~tri[None, :, :, None], NEG_BIG))
    scores = f32_einsum("bthd,bshd->btsh", qc, kc)        # q_t . k_tau
    sv = f32_einsum("btsh,bshd->bthd", scores * e, vc)
    inter = torch.exp(m0r - m_run)                        # (B, t, H)
    q_c0 = f32_einsum("bthk,bhvk->bthv", qc, c0)          # q_t C0
    y_num = sv + inter[..., None] * q_c0
    n_t = inter[..., None] * n0[:, None] + f32_einsum("btsh,bshd->bthd", e, kc)
    m_t = f_cum + m_run
    denom = torch.maximum(torch.abs(torch.sum(n_t * qc, dim=-1, keepdim=True)),
                          torch.exp(-m_t)[..., None])
    y = y_num / denom
    # Chunk-end state: coefficients exp(a_tau - M_L).
    end = torch.exp(m0 - m_run[:, -1])                    # (B, H)
    e_l = torch.exp(a - m_run[:, -1:, :])                 # (B, L, H)
    c_new = end[..., None, None] * c0 + \
        f32_einsum("bshv,bshk->bhvk", e_l[..., None] * vc, kc)
    n_new = end[..., None] * n0 + f32_einsum("bsh,bshk->bhk", e_l, kc)
    return (c_new, n_new, m_t[:, -1]), y


def _mlstm_cell(q, k, v, log_i, log_f, state, *, chunk: int = 256):
    """Chunkwise-parallel stabilized mLSTM, an exact reformulation of the
    recurrence (see the reference's docstring for the algebra).

    q, k, v: (B, S, H, hd); log_i, log_f: (B, S, H); ``state`` carries
    (c, n, m).  S == 1 takes :func:`_mlstm_step`.  Otherwise the time axis is
    padded to a multiple of the chunk with inert steps (log_i = -1e30,
    log_f = 0).  Returns (y, c, n, m).
    """
    b, s, h, hd = q.shape
    if s == 1:
        (c, n, m), y = _mlstm_step((state.c, state.n, state.m),
                                   (q[:, 0], k[:, 0], v[:, 0],
                                    log_i[:, 0], log_f[:, 0]))
        return y[:, None], c, n, m

    chunk = min(chunk, s)
    pad = (-s) % chunk
    q, k, v, log_f = (_pad_time(t, pad) for t in (q, k, v, log_f))
    log_i = _pad_time(log_i, pad, NEG_BIG)
    carry = (state.c, state.n, state.m)
    ys = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        # Checkpointed where autograd records (the reference's
        # ``jax.checkpoint`` on ``chunk_body``).
        carry, y = checkpoint_if_recording(_mlstm_chunk, carry, q[:, sl], k[:, sl],
                                           v[:, sl], log_i[:, sl], log_f[:, sl])
        ys.append(y)
    c, n, m = carry
    return torch.cat(ys, dim=1)[:, :s], c, n, m


def mlstm_block(params: dict, x: torch.Tensor, cfg, *,
                state: Optional[MLSTMState] = None,
                mode: ComputeMode = ComputeMode.RELAXED):
    """Pre-LN mLSTM block with x2 up-projection and gated output; returns
    (out, the state after the last step)."""
    b, s, d = x.shape
    h = cfg.num_heads
    di = 2 * d
    hd = di // h
    dev = x.device

    xz = mode_dot(x, params["w_in"], mode)                # (B, S, 2di)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc, new_tail = _causal_conv(xi, params["conv_w"].to(xi.dtype),
                                state.conv if state is not None else None)
    xc = F.silu(xc)

    q = reshape(mode_dot(xc, params["wq"], mode), (b, s, h, hd)).float()
    k = reshape(mode_dot(xc, params["wk"], mode), (b, s, h, hd)).float() \
        / f32_scalar(math.sqrt(hd), dev)
    v = reshape(mode_dot(xi, params["wv"], mode), (b, s, h, hd)).float()
    log_i = reshape(mode_dot(xi, params["w_i"], ComputeMode.PRECISE).float(),
                    (b, s, h))
    f_pre = reshape(mode_dot(xi, params["w_f"], ComputeMode.PRECISE).float(),
                    (b, s, h))

    carry = (state.c, state.n, state.m) if state is not None else (None,) * 3
    args = (q, k, v, log_i, f_pre) + carry
    if isinstance(x, DTensor):
        # Over the batch axes only: the cell mixes each head's channels.
        mesh = x.device_mesh
        rows = resolve((b,), (BATCH,), mesh)
        y, c, n, m = local_map(_mlstm_cell_local, list(args), [rows] * 8, rows)
    else:
        y, c, n, m = _mlstm_cell_local(*args)
    y = reshape(rms_norm(y, params["cell_norm"], cfg.norm_eps), (b, s, di))
    y = y.to(mode.operand_dtype) * F.silu(z)
    state = MLSTMState(c=c, n=n, m=m, conv=new_tail)
    return mode_dot(y, params["w_out"], mode), state


def _mlstm_cell_local(q, k, v, log_i, f_pre, c, n, m):
    """:func:`_mlstm_cell` on plain tensors, with the forget gate's
    pre-activation ``f_pre`` (its log is taken here), from the zero state
    (``m`` at ``NEG_BIG``) where ``c`` is None."""
    log_f = F.logsigmoid(f_pre)
    if c is None:
        b, _, h, hd = q.shape
        c = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, h), NEG_BIG, dtype=torch.float32, device=q.device)
    return _mlstm_cell(q, k, v, log_i, log_f, MLSTMState(c, n, m, None))


def slstm_block(params: dict, x: torch.Tensor, cfg, *,
                state: Optional[SLSTMState] = None,
                mode: ComputeMode = ComputeMode.RELAXED):
    """sLSTM with diagonal recurrent gate weights + a 4/3 gated FFN;
    returns (out, the state after the last step)."""
    b, s, d = x.shape
    gates = mode_dot(x, params["w_gates"], mode).float()  # (B, S, 4d)
    gates = reshape(gates, (b, s, 4, d))
    r = params["r_gates"].float()                          # (4, d)
    args = (gates, r) + (tuple(state) if state is not None else (None,) * 4)
    if isinstance(x, DTensor):
        # Over the batch axes only (the reference names no sharding here).
        mesh = x.device_mesh
        rows = resolve((b,), (BATCH,), mesh)
        y, st = local_map(_slstm_cell, list(args), [rows, (None, None)] + [rows] * 4,
                          rows)
    else:
        y, st = _slstm_cell(*args)
    y = rms_norm(y.to(mode.operand_dtype), params["cell_norm"], cfg.norm_eps)
    # The post-cell gated FFN, factor 4/3 (the xLSTM paper's sLSTM block).
    hgate = F.gelu(mode_dot(y, params["w_ff_g"], mode), approximate="tanh") \
        * mode_dot(y, params["w_ff_u"], mode)
    return mode_dot(hgate, params["w_ff_d"], mode), SLSTMState(*st)


def _slstm_cell(gates, r, c, n, h_prev, m):
    """The sLSTM recurrence over time on plain tensors: gates (B, S, 4, d)
    and r (4, d) -> (h for every step (B, S, d) f32, (c, n, h, m)); from the
    zero state (``m`` at ``NEG_BIG``) where ``c`` is None."""
    b, s, _, d = gates.shape
    if c is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=gates.device)
        c = n = h_prev = zeros
        m = torch.full((b, d), NEG_BIG, dtype=torch.float32, device=gates.device)
    hs = []
    for t in range(s):
        # The four gates' recurrent terms in one product and one sum (the
        # same elementwise arithmetic as four): each (B, d).
        gz, gi, gf, go = torch.unbind(gates[:, t] + r * h_prev[:, None], dim=1)
        log_f = F.logsigmoid(gf)
        lfm = log_f + m
        m_new = torch.maximum(lfm, gi)
        i_p = torch.exp(gi - m_new)
        f_p = torch.exp(lfm - m_new)
        c = f_p * c + i_p * torch.tanh(gz)
        n = f_p * n + i_p
        h_prev = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h_prev)
    return torch.stack(hs, dim=1), (c, n, h_prev, m)
