"""AdamW with decoupled weight decay and global-norm clipping.

The port of ``repro.optim.adamw``.  The moments are f32 and have the
parameters' tree structure (``nn.model.tree_map``), so a checkpoint names
them ``mu/...`` and ``nu/...`` after the parameters.
"""
from __future__ import annotations

from typing import Any, Iterator, NamedTuple

import torch

from ..nn.model import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-dim int32, on the parameters' device
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    """Zero moments in f32, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(tree_leaves(params))).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _zip_leaves(tree, *others) -> Iterator[tuple]:
    """The leaves of ``tree`` and, at the same place (dict key, index or
    field), of each of ``others``: trees of one structure whose dicts may
    list their keys in another order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zip_leaves(v, *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _zip_leaves(v, *(o[i] for o in others))
    else:
        yield (tree,) + others


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step: the gradients scaled by ``min(1, clip_norm /
    max(|g|, 1e-9))`` (``|g|`` the global norm), the moments updated, bias
    correction, the decoupled decay ``weight_decay * p``, and each parameter
    cast back to its dtype.  ``lr``: a number, or a 0-dim tensor (a schedule
    value computed from ``state.step`` by the caller).

    Updates ``params`` and the state's moments in place (a second copy of
    an f32 model is 4 bytes a parameter: 11.8 GB at 2.95 B parameters) and
    returns them, as ``(params, AdamWState(step + 1, mu, nu))``.  The
    gradients are left as they are."""
    step = state.step + 1
    scale = torch.clamp(clip_norm / torch.clamp(global_norm(grads), min=1e-9),
                        max=1.0)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in _zip_leaves(params, grads, state.mu, state.nu):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        delta = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(eps))
        delta.add_(p.float(), alpha=weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float() - delta.mul_(lr))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
