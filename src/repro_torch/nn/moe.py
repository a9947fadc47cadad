"""Mixture-of-Experts FFN: top-k routing, capacity-bounded grouped GEMM.

The port of ``repro.nn.moe``.  Dispatch is scatter-based: each (token,
choice) pair gets a slot in its expert's buffer, counted over the flattened
``(token, choice)`` order, and a pair whose slot is past the capacity is
dropped (it adds zeros at the last slot and its gate weight is zeroed).
The experts then run as one batched product over ``(E, C, d)`` buffers and
the results gather back weighted by the router's probabilities.

Precision: the router product is PRECISE (f32, TF32 off), as in the
reference.  The expert products are ``torch.matmul`` on the mode's operand
dtype: under RELAXED a bf16 product that accumulates in f32 and rounds its
(E, C, f) and (E, C, d) results to bf16, where the reference's einsum keeps
them in f32 (``preferred_element_type``).  Widening the expert weights to
f32 instead would copy 9.7 GB a layer per call at Qwen3-MoE's width.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.precision import ComputeMode, f32_matmul, mode_dot
from . import sharding as S
from .layers import _activation


def route(router_w: torch.Tensor, x: torch.Tensor, num_experts: int,
          top_k: int, mode: ComputeMode
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (top_probs (T, k), top_idx (T, k), router_probs (T, E)).
    ``mode`` is unused: the router is PRECISE in every mode."""
    logits = mode_dot(x, router_w, ComputeMode.PRECISE).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, probs


def load_balance_loss(router_probs: torch.Tensor, top_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * P_e."""
    frac_tokens = torch.nn.functional.one_hot(
        top_idx[:, 0], num_experts).float().mean(0)
    frac_probs = router_probs.mean(0)
    return num_experts * torch.sum(frac_tokens * frac_probs)


def expert_capacity(tokens: int, seq_len: int, moe) -> int:
    """Slots per expert: lossless (``tokens * top_k``) at decode, where
    dropping a request's token would corrupt its generation; else
    ``max(int(tokens * top_k * capacity_factor / E), 1)``."""
    if seq_len == 1:
        return tokens * moe.top_k
    return max(int(tokens * moe.top_k * moe.capacity_factor / moe.num_experts), 1)


def assign_slots(top_idx: torch.Tensor, num_experts: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, choice) pair's slot in its expert's buffer, counted in
    the flattened (token, choice) order, and whether it is kept
    (slot < capacity).  Returns (slot (T*k,), keep (T*k,))."""
    e_flat = top_idx.reshape(-1)
    counts = torch.cumsum(
        torch.nn.functional.one_hot(e_flat, num_experts), dim=0)
    slot = counts.gather(1, e_flat[:, None])[:, 0] - 1
    return slot, slot < capacity


def moe_ffn(params: dict, x: torch.Tensor, cfg, *,
            mode: ComputeMode = ComputeMode.RELAXED) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  params: router (d, E), wg/wu (E, d, f),
    wd (E, f, d).  The reference's ``return_aux`` (the load-balance term)
    is not ported: nothing in the reference calls it, and its ``loss_fn``
    is cross-entropy only.

    On DTensors the tokens split over the batch axes and the experts over
    'model' (where ``expert_parallel`` and the count divides), with the
    reference's global semantics: see :func:`_moe_local`.  Each token's
    output is then a sum over the expert shards left pending."""
    names = ("router", "wg", "wu", "wd")
    if not isinstance(x, S.DTensor):
        return _moe_local(x, *(params[n] for n in names), cfg=cfg, mode=mode)
    moe = cfg.moe
    mesh = x.device_mesh
    x_spec = S.resolve(x.shape, (S.BATCH, None, None), mesh)
    e_spec = S.resolve((moe.num_experts,),
                       ("model" if moe.expert_parallel else None,), mesh)
    rows, ex = S.entry_axes(x_spec[0]), S.entry_axes(e_spec[0])
    out_pl = list(S.placements(x_spec, mesh))
    for a in ex:
        out_pl[S.mesh_axes(mesh).index(a)] = S.Partial()
    w_spec = e_spec + (None, None)
    return S.local_map(
        lambda *a: _moe_local(*a, cfg=cfg, mode=mode, mesh=mesh, rows=rows, ex=ex),
        [x] + [params[n] for n in names], [x_spec, (None, None), w_spec, w_spec, w_spec],
        tuple(out_pl))


def _moe_local(x, router, wg, wu, wd, *, cfg, mode: ComputeMode, mesh=None,
               rows=(), ex=()):
    """The layer on one rank's tokens ``x`` and experts ``wg/wu/wd``: the
    tokens split over the mesh axes ``rows``, the experts over ``ex``; with
    neither it is the whole layer and runs no collective.

    Each rank routes its own tokens.  A pair's slot in its expert's buffer
    counts the pairs of the ranks before it (an all-gather of per-expert
    counts over ``rows``), so the capacity and the drops are those of the
    whole batch.  Each rank fills its experts' (E_l, C, d) buffers with its
    own pairs, the buffers are summed over ``rows``, and the expert
    products run on the local experts."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    n_rows, n_ex = S.group_size(mesh, rows), S.group_size(mesh, ex)
    xf = x.reshape(t, d)
    top_p, top_i, _ = route(router, xf, e, k, mode)

    capacity = expert_capacity(t * n_rows, s, moe)
    e_flat = top_i.reshape(-1)                                  # (T*k,)
    slot, keep = assign_slots(top_i, e, capacity)
    if n_rows > 1:
        # Pairs of the same expert on the ranks before this one.
        counts = torch.nn.functional.one_hot(e_flat, e).sum(0)
        every = S.all_gather(counts[None], 0, mesh, rows)
        slot = slot + every[:S.coordinate(mesh, rows)].sum(0)[e_flat]
        keep = slot < capacity
    slot_c = torch.clamp(slot, 0, capacity - 1)
    e_l, e_loc = e, e_flat
    if n_ex > 1:
        e_l = e // n_ex
        lo = S.coordinate(mesh, ex) * e_l
        mine = (e_flat >= lo) & (e_flat < lo + e_l)
        e_loc = torch.where(mine, e_flat - lo, torch.zeros_like(e_flat))
        keep = keep & mine

    # Scatter into per-expert buffers; a dropped pair adds zeros at slot C-1.
    x_rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)    # jnp.repeat
    contrib = torch.where(keep[:, None], x_rep,
                          torch.zeros_like(x_rep)).to(mode.operand_dtype)
    buf = torch.zeros((e_l, capacity, d), dtype=mode.operand_dtype,
                      device=x.device)
    buf.index_put_((e_loc, slot_c), contrib, accumulate=True)
    buf = S.psum(buf, mesh, rows, grad_sum=True)

    # Grouped GEMM across experts (a gated MLP per expert).
    act = _activation(cfg.ffn_activation)
    wg, wu, wd = (w.to(mode.operand_dtype) for w in (wg, wu, wd))
    hg = f32_matmul(buf, wg).to(mode.accum_dtype)               # (E, C, f)
    hu = f32_matmul(buf, wu).to(mode.accum_dtype)
    hout = (act(hg) * hu).to(mode.operand_dtype)
    yb = f32_matmul(hout, wd)                                   # (E, C, d)

    # Gather back, weighted by the router's probabilities.
    y_tok = yb[e_loc, slot_c]                                   # (T*k, d)
    w_tok = (top_p.reshape(-1) * keep.float())[:, None]
    y = (y_tok.float() * w_tok).reshape(t, k, d).sum(dim=1)
    return y.reshape(b, s, d).to(mode.out_dtype)
