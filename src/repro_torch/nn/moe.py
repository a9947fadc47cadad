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
    is cross-entropy only."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    xf = x.reshape(t, d)
    top_p, top_i, _ = route(params["router"], xf, e, k, mode)

    capacity = expert_capacity(t, s, moe)
    e_flat = top_i.reshape(-1)                                  # (T*k,)
    slot, keep = assign_slots(top_i, e, capacity)
    slot_c = torch.clamp(slot, 0, capacity - 1)

    # Scatter into per-expert buffers; a dropped pair adds zeros at slot C-1.
    x_rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)    # jnp.repeat
    contrib = torch.where(keep[:, None], x_rep,
                          torch.zeros_like(x_rep)).to(mode.operand_dtype)
    buf = torch.zeros((e, capacity, d), dtype=mode.operand_dtype,
                      device=x.device)
    buf.index_put_((e_flat, slot_c), contrib, accumulate=True)

    # Grouped GEMM across experts (a gated MLP per expert).
    act = _activation(cfg.ffn_activation)
    wg, wu, wd = (params[n].to(mode.operand_dtype) for n in ("wg", "wu", "wd"))
    hg = f32_matmul(buf, wg).to(mode.accum_dtype)               # (E, C, f)
    hu = f32_matmul(buf, wu).to(mode.accum_dtype)
    hout = (act(hg) * hu).to(mode.operand_dtype)
    yb = f32_matmul(hout, wd)                                   # (E, C, d)

    # Gather back, weighted by the router's probabilities.
    y_tok = yb[e_flat, slot_c]                                  # (T*k, d)
    w_tok = (top_p.reshape(-1) * keep.float())[:, None]
    y = (y_tok.float() * w_tok).reshape(t, k, d).sum(dim=1)
    return y.reshape(b, s, d).to(mode.out_dtype)
