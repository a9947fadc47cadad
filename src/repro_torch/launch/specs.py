"""Step functions of the training path.

The port of the training part of ``repro.launch.specs``:
:func:`make_train_step` and :func:`default_microbatches`.  What the
reference lowers for meshes (input specs with shardings, the dry-run's
prefill and serve steps) waits for ROADMAP.md queue 1's mesh slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.precision import ComputeMode
from ..nn import model as M
from ..nn.config import ModelConfig
from ..optim import AdamWState, adamw_update, cosine_schedule


def default_microbatches(cfg: ModelConfig, global_batch: int,
                         seq_len: int, batch_width: int = 1) -> int:
    """Gradient-accumulation factor: the fewest microbatches (a divisor of
    ``global_batch // batch_width``) that keep one microbatch's layer
    checkpoints, ``L x B x S x d x 2`` bytes, under 3 GiB.  ``batch_width``:
    the devices the batch is split over (1 on one card; the reference's
    default is its pod's 16)."""
    b_unit = max(global_batch // batch_width, 1)
    act = cfg.num_layers * b_unit * seq_len * cfg.d_model * 2
    for mb in sorted(d for d in range(1, b_unit + 1) if b_unit % d == 0):
        if act / mb <= 3 * 1024 ** 3:
            return mb
    return b_unit


def make_train_step(cfg: ModelConfig, mode: ComputeMode = ComputeMode.RELAXED,
                    microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``batch``: ``tokens`` and ``labels`` (B, S), and ``aux`` for a config
    with ``cross`` layers.  The parameters are f32 leaves with
    ``requires_grad`` (``init_params(..., dtype=torch.float32)``).  The
    gradients of :func:`repro_torch.nn.model.loss_fn` come from
    ``torch.autograd.grad`` over the leaves; with ``microbatches > 1`` the
    batch is split along B and the losses and f32 gradients are summed,
    each divided by ``microbatches``.  Then one :func:`adamw_update` at
    ``cosine_schedule(step, peak_lr=3e-4, warmup=100, total=10000)`` (a
    fixed schedule, as the reference's), which updates the parameters and
    moments in place.  The loss is returned detached."""
    def grads_of(leaves, params, tokens, labels, aux):
        loss = M.loss_fn(params, tokens, labels, cfg, aux=aux, mode=mode)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss does not reach has a zero gradient, as in JAX.
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(params, opt_state: AdamWState, batch: dict):
        leaves = list(M.tree_leaves(params))
        if microbatches <= 1:
            loss, grads = grads_of(leaves, params, batch["tokens"],
                                   batch["labels"], batch.get("aux"))
        else:
            if batch["tokens"].shape[0] % microbatches:
                raise ValueError(f"batch {batch['tokens'].shape[0]} does not split "
                                 f"into {microbatches} microbatches")
            split = {k: torch.chunk(v, microbatches, dim=0)
                     for k, v in batch.items()}
            loss, grads = 0.0, None
            for i in range(microbatches):
                mb = {k: v[i] for k, v in split.items()}
                l, g = grads_of(leaves, params, mb["tokens"], mb["labels"],
                                mb.get("aux"))
                g = [x.float() for x in g]
                loss = loss + l
                grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        it = iter(grads)
        grads = M.tree_map(lambda _: next(it), params)
        lr = cosine_schedule(opt_state.step, peak_lr=3e-4, warmup=100,
                             total=10000)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, loss
    return train_step
