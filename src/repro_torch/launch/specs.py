"""Input specifications and step functions for every (arch x shape) pair.

The port of ``repro.launch.specs``.  :func:`build_lowering` returns the
step function of a pair and its arguments as DTensors with the reference's
placements on a mesh (``meta`` local shards by default: nothing allocated),
the contract the dry run (``launch/dryrun.py``) and the sharded tests
share.  Every argument's local shape is the reference's ``shard_shape``;
the port's parameter tree keeps one dict per layer where the reference
stacks ``(G, ...)``, which its rules never shard.

Shapes:
  train_4k     seq 4096   global batch 256   train_step
  prefill_32k  seq 32768  global batch 32    prefill
  decode_32k   seq 32768  global batch 128   serve_step (1 token, full cache)
  long_500k    seq 524288 global batch 1     serve_step (sub-quadratic policy)

A decode step's position is the last slot of the context (``seq - 1``, the
reference's "full cache"): an int32 0-dim tensor argument, as the
reference's, which the step reads on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..core.precision import ComputeMode
from ..nn import model as M
from ..nn import sharding as S
from ..nn.config import ModelConfig
from ..optim import AdamWState, adamw_update, cosine_schedule

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def shape_skipped(cfg: ModelConfig, shape: str) -> Optional[str]:
    """A reason string if this (arch, shape) pair is a documented skip,
    else None."""
    if shape == "long_500k" and cfg.long_context == "skip":
        return (f"{cfg.name}: encoder-decoder with bounded decoder; 524k "
                "decode has no semantics (DESIGN.md)")
    return None


def window_override_for(cfg: ModelConfig, shape: str) -> int:
    if shape == "long_500k" and cfg.long_context == "sliding_override":
        return cfg.long_context_window
    return 0


def _shardable(n: int, axes: Tuple[str, ...], mesh: DeviceMesh) -> Tuple[str, ...]:
    size = math.prod(S.axis_size(mesh, a) for a in axes) if axes else 1
    return axes if axes and n % size == 0 and n >= size else ()


def param_shardings(cfg: ModelConfig, mesh: DeviceMesh, mode: str):
    """The parameter tree's specs under the rules of ``mode`` ("train" or
    "infer"), before the divisibility check."""
    return S.shard_params_tree(M.param_axes(cfg), mode, cfg)


def abstract_sharded_params(cfg: ModelConfig, mesh: DeviceMesh, mode: str,
                            dtype: torch.dtype = torch.bfloat16,
                            device: "str | torch.device" = "meta"):
    """The parameter tree as DTensors with the rules' placements (a mesh axis
    that does not divide its dimension replicated), local shards
    ``torch.empty`` on ``device``."""
    abstract = M.abstract_params(cfg, dtype)
    specs = iter(S.axes_leaves(param_shardings(cfg, mesh, mode)))
    return M.tree_map(lambda a: S.abstract(a.shape, dtype, mesh, next(specs),
                                           device), abstract)


def _aux_spec(cfg: ModelConfig, batch: int, mesh: DeviceMesh, baxes,
              device) -> Optional[DTensor]:
    seq = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.num_image_tokens
    if not seq:
        return None
    return S.abstract((batch, seq, cfg.d_model), torch.bfloat16, mesh,
                      (baxes or None, None, None), device)


def _cache_specs(cfg: ModelConfig, batch: int, seq_len: int, mesh: DeviceMesh,
                 window_override: int, device):
    """The decode cache as DTensors in the reference's layout
    (:func:`sharding.cache_spec`)."""
    return M.tree_map(
        lambda leaf: S.abstract(leaf.shape, leaf.dtype, mesh,
                                S.cache_spec(leaf.shape, mesh), device),
        M.init_cache(cfg, batch, seq_len, window_override=window_override,
                     abstract=True))


@dataclass
class LoweringSpec:
    """Everything needed to run one (arch x shape) pair on a mesh."""
    name: str
    fn: Callable                   # the step function
    args: Tuple[Any, ...]          # its arguments (DTensors)
    donate: Tuple[int, ...] = ()   # arguments the step updates in place


def default_microbatches(cfg: ModelConfig, global_batch: int,
                         seq_len: int, batch_width: int = 1) -> int:
    """Gradient-accumulation factor: the fewest microbatches (a divisor of
    ``global_batch // batch_width``) that keep one microbatch's layer
    checkpoints, ``L x B_dev x S x d x 2`` bytes per device, under 3 GiB.
    ``batch_width``: the devices the batch is split over (1 on one card,
    16 on the pod mesh, 32 on the multi-pod one)."""
    b_unit = max(global_batch // batch_width, 1)
    act = cfg.num_layers * b_unit * seq_len * cfg.d_model * 2
    for mb in sorted(d for d in range(1, b_unit + 1) if b_unit % d == 0):
        if act / mb <= 3 * 1024 ** 3:
            return mb
    return b_unit


def _split_batch(v: torch.Tensor, microbatches: int):
    """``v`` split into ``microbatches`` along B.  A DTensor is split on
    each rank's own rows (microbatch i holds every rank's i-th local chunk),
    which moves nothing; the sum over microbatches is the same."""
    if isinstance(v, DTensor):
        return S.local_map(lambda t: list(torch.chunk(t, microbatches, dim=0)),
                           [v], [None], v.placements)
    return torch.chunk(v, microbatches, dim=0)


def make_train_step(cfg: ModelConfig, mode: ComputeMode = ComputeMode.RELAXED,
                    microbatches: int = 1, param_shardings=None) -> Callable:
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
    moments in place.  The loss is returned detached.

    ``param_shardings``: the parameters' specs (a tree like the params').
    The gradients, and their accumulators, are then kept sharded like the
    parameters (the reference's ``pin_grads``), and each microbatch's
    batch re-pinned to the batch axes."""
    specs = (list(S.axes_leaves(param_shardings))
             if param_shardings is not None else None)

    def pin_grads(grads):
        if specs is None:
            return grads
        out = []
        for g, spec in zip(grads, specs):
            if isinstance(g, DTensor):
                target = S.placements(S.divisible(g.shape, spec, g.device_mesh),
                                      g.device_mesh)
                if tuple(g.placements) != target:
                    g = g.redistribute(g.device_mesh, target)
            out.append(g)
        return out

    def grads_of(leaves, params, tokens, labels, aux):
        loss = M.loss_fn(params, tokens, labels, cfg, aux=aux, mode=mode)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss does not reach has a zero gradient, as in JAX.
        return loss.detach(), pin_grads([torch.zeros_like(p) if g is None else g
                                         for p, g in zip(leaves, grads)])

    def train_step(params, opt_state: AdamWState, batch: dict):
        leaves = list(M.tree_leaves(params))
        if microbatches <= 1:
            loss, grads = grads_of(leaves, params, batch["tokens"],
                                   batch["labels"], batch.get("aux"))
        else:
            if batch["tokens"].shape[0] % microbatches:
                raise ValueError(f"batch {batch['tokens'].shape[0]} does not split "
                                 f"into {microbatches} microbatches")
            split = {k: _split_batch(v, microbatches) for k, v in batch.items()}
            loss, grads = 0.0, None
            for i in range(microbatches):
                # Re-pin the batch axes (a split may lose them on a mesh).
                mb = {k: S.constrain(v[i], S.BATCH, *([None] * (v[i].ndim - 1)))
                      for k, v in split.items()}
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


def host_int(pos) -> int:
    """A position argument as a Python int: a number, or a 0-dim tensor
    (read on the host; a real tensor even under a ``FakeTensorMode``)."""
    if isinstance(pos, DTensor):
        pos = pos.to_local()
    if isinstance(pos, torch.Tensor):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            return int(pos)
    return int(pos)


def make_prefill_step(cfg: ModelConfig, window_override: int,
                      mode: ComputeMode = ComputeMode.RELAXED) -> Callable:
    def prefill_step(params, tokens, aux=None):
        return M.prefill(params, tokens, cfg, aux=aux, mode=mode,
                         window_override=window_override)
    return prefill_step


def make_serve_step(cfg: ModelConfig, window_override: int,
                    mode: ComputeMode = ComputeMode.RELAXED) -> Callable:
    def serve_step(params, caches, token, pos):
        return M.decode_step(params, caches, token, host_int(pos), cfg,
                             mode=mode, window_override=window_override)
    return serve_step


def build_lowering(cfg: ModelConfig, shape, mesh: DeviceMesh,
                   mode: ComputeMode = ComputeMode.RELAXED, *,
                   device: "str | torch.device" = "meta") -> LoweringSpec:
    """The step of pair (``cfg``, ``shape``) and its arguments on ``mesh``
    (``shape``: a key of :data:`SHAPES`, or a dict of ``seq_len``,
    ``global_batch``, ``kind`` and optionally ``window_override``): f32
    parameters with AdamW moments for ``train``, bf16 parameters for
    ``prefill`` and ``decode``; every local shard ``torch.empty`` on
    ``device`` (the decode position is a real int32 0-dim tensor on the
    host)."""
    if isinstance(shape, str):
        info, name = SHAPES[shape], f"{cfg.name}:{shape}"
        reason = shape_skipped(cfg, shape)
        if reason:
            raise ValueError(f"skipped pair: {reason}")
        wo = window_override_for(cfg, shape)
    else:           # a shape of one's own: {"seq_len", "global_batch", "kind"}
        info, name = shape, f"{cfg.name}:{shape['kind']}"
        wo = shape.get("window_override", 0)
    seq, gbatch, kind = info["seq_len"], info["global_batch"], info["kind"]
    baxes = _shardable(gbatch, S.batch_axes(mesh), mesh) or None

    def batch_input(shape_):
        return S.abstract(shape_, torch.int32, mesh, (baxes, None), device)

    if kind == "train":
        params = abstract_sharded_params(cfg, mesh, "train", torch.float32, device)
        params = M.tree_map(lambda p: p.requires_grad_(True), params)

        def as_moment(p):
            return DTensor.from_local(
                torch.empty(p.to_local().shape, dtype=torch.float32,
                            device=device),
                mesh, p.placements, run_check=False, shape=p.shape,
                stride=p.stride())
        opt = AdamWState(step=S.abstract((), torch.int32, mesh, (), device),
                         mu=M.tree_map(as_moment, params),
                         nu=M.tree_map(as_moment, params))
        batch: Dict[str, Any] = {"tokens": batch_input((gbatch, seq)),
                                 "labels": batch_input((gbatch, seq))}
        aux = _aux_spec(cfg, gbatch, mesh, baxes, device)
        if aux is not None:
            batch["aux"] = aux
        bw = math.prod(S.axis_size(mesh, a) for a in S.batch_axes(mesh))
        mb = default_microbatches(cfg, gbatch, seq, batch_width=bw)
        return LoweringSpec(name, make_train_step(
            cfg, mode, microbatches=mb,
            param_shardings=param_shardings(cfg, mesh, "train")),
            (params, opt, batch), donate=(0, 1))

    params = abstract_sharded_params(cfg, mesh, "infer", torch.bfloat16, device)
    if kind == "prefill":
        aux = _aux_spec(cfg, gbatch, mesh, baxes, device)
        args = (params, batch_input((gbatch, seq))) + \
            ((aux,) if aux is not None else ())
        return LoweringSpec(name, make_prefill_step(cfg, wo, mode), args)

    caches = _cache_specs(cfg, gbatch, seq, mesh, wo, device)
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        pos = torch.tensor(seq - 1, dtype=torch.int32)
    return LoweringSpec(name, make_serve_step(cfg, wo, mode),
                        (params, caches, batch_input((gbatch, 1)), pos),
                        donate=(1,))


def shard_like(abstract, full):
    """The full tensors of ``full`` (a tree like ``abstract``, the same on
    every rank) as DTensors with the placements and dtypes of
    ``abstract``'s: each rank keeps its own slice.  A leaf of ``abstract``
    that is not a DTensor takes ``full``'s as it is."""
    leaves = iter(list(M.tree_leaves(full)))

    def one(a):
        t = next(leaves)
        if not isinstance(a, DTensor):
            return t
        mesh = a.device_mesh
        return S.distribute(t.to(a.dtype), mesh, S.spec_of(a.placements, a.ndim, mesh))
    return M.tree_map(one, abstract)


def argument_bytes(args) -> int:
    """Bytes of the arguments' local shards (one device's share)."""
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    return sum(local(t).numel() * local(t).element_size()
               for t in M.tree_leaves(args) if isinstance(t, torch.Tensor))
