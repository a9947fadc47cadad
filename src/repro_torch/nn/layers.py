"""Shared transformer building blocks: norms, rope, embeddings, MLP.

The port of ``repro.nn.layers``.  Everything is functional (params are plain
dicts of tensors).  Every product goes through
:func:`repro_torch.core.precision.mode_dot`, which threads the layer's
compute mode into the projection and rounds its result to ``mode.out_dtype``
as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Partial, Shard

from ..core.precision import ComputeMode, mode_dot
from .sharding import (BATCH, axis_size, carry_mesh, constrain, coordinate,
                       entry_axes, local_map, mesh_axes, placements, replicated,
                       resolve)


def checkpoint_if_recording(fn, *args):
    """``fn(*args)``, checkpointed where autograd records through an
    argument: the backward recomputes ``fn`` instead of keeping its
    intermediates (the reference's inner ``jax.checkpoint``).  Elsewhere
    (serving, ``inference_mode``) the plain call."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(carry_mesh(fn), *args, use_reentrant=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain (zero-initialized scales
    are the identity), back in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split, with f32 angles.  x: (..., S, H, hd);
    positions: (S,) or (B, S), or a ``range``."""
    hd = x.shape[-1]
    half = hd // 2
    # theta stays a Python number: a tensor made from it on the card would
    # be a host-to-device copy, which waits for the stream.
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    if isinstance(positions, range):
        positions = torch.arange(positions.start, positions.stop, positions.step,
                                 device=x.device)
    if isinstance(positions, DTensor):
        positions = positions.to_local()
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    cos, sin = replicated(cos, x), replicated(sin, x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return torch.tanh(logits / cap) * cap


def _activation(name: str):
    # The reference's jax.nn.gelu is the tanh approximation by default.
    if name == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, *, activation: str = "silu",
        mode: ComputeMode = ComputeMode.RELAXED) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU), or a plain 2-layer one without a gate."""
    act = _activation(activation)
    if "wg" in params:
        h = act(mode_dot(x, params["wg"], mode)) * mode_dot(x, params["wu"], mode)
    else:
        h = act(mode_dot(x, params["wu"], mode))
    h = constrain(h, BATCH, None, "model")      # hidden sharded over d_ff
    return mode_dot(h, params["wd"], mode)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On DTensors a vocabulary-parallel lookup: each
    rank looks up the tokens of its slice of the vocabulary ('model'),
    zeros elsewhere, and the sum over 'model' is left pending.  A split of
    the table's embed dim (weights sharded in 2-D) stays on the mesh axes
    the tokens' batch does not use: there each rank looks up its slice of
    the embed dim, where gathering the table would move all of it."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tok_spec = resolve(tokens.shape, (BATCH,), mesh)
    vocab = resolve(table.shape, ("model",), mesh)[0]
    used = set(entry_axes(tok_spec[0]))
    keep = tuple(a for a, p in zip(mesh_axes(mesh), table.placements)
                 if p == Shard(1) and a not in used)
    dim = keep[0] if len(keep) == 1 else (keep or None)
    out_spec = tok_spec + (dim,)
    if vocab is None or axis_size(mesh, "model") == 1:
        return local_map(lambda t, i: t[i], [table, tokens],
                         [(None, dim), tok_spec], out_spec)
    n = table.shape[0] // axis_size(mesh, "model")

    def lookup(t, i):
        lo = coordinate(mesh, ("model",)) * n
        mine = (i >= lo) & (i < lo + n)
        rows = t[torch.where(mine, i - lo, torch.zeros_like(i))]
        return torch.where(mine[..., None], rows, torch.zeros_like(rows))
    pl = list(placements(out_spec, mesh))
    pl[mesh_axes(mesh).index("model")] = Partial()
    return local_map(lookup, [table, tokens], [("model", dim), tok_spec],
                     tuple(pl))


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, *, tied: bool,
            final_cap: float = 0.0,
            mode: ComputeMode = ComputeMode.RELAXED) -> torch.Tensor:
    """Logits in f32: a RELAXED product unless the mode is PRECISE."""
    w = table_or_head.T if tied else table_or_head
    logits = mode_dot(x, w, ComputeMode.RELAXED if mode is not ComputeMode.PRECISE
                      else mode).float()
    return softcap(logits, final_cap)
