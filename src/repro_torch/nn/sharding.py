"""Logical-axis -> mesh-axis sharding rules, on ``torch.distributed`` DTensor.

The port of ``repro.nn.sharding``.  Every parameter leaf carries a tuple of
logical axis names (``model.param_axes``); a rule table maps them to mesh
axes per execution mode:

  train:     FSDP on "data" (the embed dim) x tensor-parallel on "model"
             (heads / ffn / experts / vocab); the AdamW moments shard the
             same way.
  inference: tensor-parallel on "model", weights replicated across "data";
             configs with ``shard_weights_2d_infer`` keep the FSDP axis too.

A *spec* is the port's ``PartitionSpec``: a tuple with one entry per tensor
dimension, each ``None``, a mesh-axis name, or a tuple of names (a dimension
split over several mesh axes, the first major).  :func:`placements` turns a
spec into DTensor placements on a ``DeviceMesh``; a dimension on
``("pod", "data")`` is ``Shard(dim)`` on both mesh dimensions, pod major.
A mesh axis that does not divide its dimension is dropped (replicated), as
the reference's ``_validate_divisible`` does, so DTensor's uneven shards are
never used and every local shape is the reference's ``shard_shape``.

Model code emits constraints only under an active mesh
(:func:`activate_mesh`); with none, or given a plain tensor, :func:`constrain`
and :func:`constrain_heads` return their input object, so the one-card
serving and training paths are unchanged.  The parts of a block whose work
is independent per shard (attention's chunk loop, the recurrences, the MoE
dispatch) run on the local shards through :func:`local_map`, the
counterpart of a ``shard_map``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import _pytree as pytree

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# Active-mesh context
# ---------------------------------------------------------------------------

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None)


@contextlib.contextmanager
def activate_mesh(mesh: DeviceMesh):
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE_MESH.get()


#: logical batch marker used in constraint specs
BATCH = ("pod", "data")


def carry_mesh(fn: Callable) -> Callable:
    """``fn``, run under the mesh active now wherever it is called: a
    checkpoint's recompute runs in autograd's thread for the device, which
    does not see this thread's context.  ``fn`` itself with no mesh."""
    mesh = active_mesh()
    if mesh is None:
        return fn

    def under_mesh(*args, **kwargs):
        with activate_mesh(mesh):
            return fn(*args, **kwargs)
    return under_mesh

# logical axis vocabulary of model.param_axes:
#   vocab    vocabulary dim
#   embed    d_model dim (FSDP'd in training)
#   heads    fused H*hd projection dim
#   kv       fused KV*hd projection dim
#   mlp      d_ff dim
#   experts  MoE expert dim
#   inner    SSM / xLSTM expanded inner dim
#   state    SSM state dim N, conv taps, gate count: tiny, never sharded


def rules(mode: str, cfg) -> dict:
    two_d = mode != "train" and getattr(cfg, "shard_weights_2d_infer", False)
    fsdp = "data" if (mode == "train" or two_d) else None
    moe = getattr(cfg, "moe", None)
    expert_ax = "model" if (moe is None or moe.expert_parallel) else None
    return {
        "layers": None,
        "vocab": "model",
        "embed": fsdp,
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "experts": expert_ax,
        "inner": "model",
        "state": None,
        None: None,
    }


def spec_for(axes: Tuple[Optional[str], ...], mode: str, cfg) -> Spec:
    r = rules(mode, cfg)
    return tuple(r[a] for a in axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def map_axes_tree(fn: Callable, tree):
    """``fn`` of every logical-axes tuple of a nest of dicts and lists."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes_tree(fn, v) for k, v in tree.items()}
    return type(tree)(map_axes_tree(fn, v) for v in tree)


def axes_leaves(tree):
    """The logical-axes tuples (or specs) of a tree, in the order of
    ``model.tree_leaves`` over the parameters."""
    if _is_axes(tree):
        yield tree
        return
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from axes_leaves(v)


def shard_params_tree(axes_tree, mode: str, cfg):
    """Map a tree of logical-axes tuples to specs."""
    return map_axes_tree(lambda axes: spec_for(axes, mode, cfg), axes_tree)


def mesh_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 where the mesh has no such axis."""
    names = mesh_axes(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes the global batch shards over: ('pod','data') when a pod axis
    exists, else ('data',)."""
    return tuple(a for a in BATCH if a in mesh_axes(mesh))


def data_spec(mesh: DeviceMesh, *, batch_rank_pos: int = 0,
              ndim: int = 2) -> Spec:
    """Spec of a (B, ...) input batch: batch over pod+data."""
    parts: list = [None] * ndim
    parts[batch_rank_pos] = batch_axes(mesh)
    return tuple(parts)


def divisible(shape: Sequence[int], spec: Spec, mesh: DeviceMesh) -> Spec:
    """``spec`` padded to ``len(shape)`` with every entry whose mesh axes do
    not divide its dimension dropped (the reference's
    ``_validate_divisible``)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        size = math.prod(axis_size(mesh, a) for a in entry_axes(entry))
        out.append(entry if entry is not None and dim % size == 0 else None)
    return tuple(out)


def resolve(shape: Sequence[int], axes: Sequence, mesh: DeviceMesh) -> Spec:
    """A constraint's spec: each entry's axes that the mesh has, kept when
    their product divides the dimension and is not larger than it (the
    reference's ``constrain`` rule)."""
    parts = []
    for dim, ax in zip(shape, axes):
        cand = tuple(a for a in entry_axes(ax) if a in mesh_axes(mesh))
        size = math.prod(axis_size(mesh, a) for a in cand) if cand else 0
        ok = cand and dim % size == 0 and dim >= size
        parts.append((cand if len(cand) > 1 else cand[0]) if ok else None)
    return tuple(parts) + (None,) * (len(shape) - len(parts))


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec``: mesh dimension ``n`` is ``Shard(i)``
    where entry ``i`` names it, else ``Replicate()``."""
    names = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {names}")
        for a in axes:
            if a in names:
                out[names.index(a)] = Shard(i)
    return tuple(out)


def cache_spec(shape: Sequence[int], mesh: DeviceMesh) -> Spec:
    """The reference's layout of a decode-cache leaf (B, ...): B over the
    batch axes where their product divides it, and the widest trailing
    dimension 'model' divides on 'model'."""
    baxes = batch_axes(mesh)
    size = math.prod(axis_size(mesh, a) for a in baxes)
    spec: list = [None] * len(shape)
    if baxes and shape[0] % size == 0 and shape[0] >= size:
        spec[0] = baxes if len(baxes) > 1 else baxes[0]
    msize = axis_size(mesh, "model")
    for i in range(len(shape) - 1, 0, -1):
        if shape[i] % msize == 0 and shape[i] >= msize:
            spec[i] = "model"
            break
    return tuple(spec)


def spec_of(placements_: Sequence[Any], ndim: int, mesh: DeviceMesh) -> Spec:
    """The spec of DTensor ``placements_`` (no ``Partial``) on ``mesh``."""
    entries: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh_axes(mesh), placements_):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"no spec for placement {p}")
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh: DeviceMesh) -> Tuple[int, ...]:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(axis_size(mesh, a) for a in entry_axes(e))
                 for d, e in zip(shape, spec))


def abstract(shape: Sequence[int], dtype: torch.dtype, mesh: DeviceMesh,
             spec: Spec, device: "str | torch.device" = "meta") -> DTensor:
    """A DTensor of global ``shape`` whose local shard is
    ``torch.empty`` on ``device`` (``meta``: nothing allocated; under a
    ``FakeTensorMode``: a fake tensor)."""
    spec = divisible(shape, spec, mesh)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def zeros_sharded(shape: Sequence[int], dtype: torch.dtype, mesh: DeviceMesh,
                  spec: Spec, device: "str | torch.device") -> DTensor:
    """Zeros of global ``shape`` as a DTensor with ``spec``: each rank
    allocates its own shard."""
    spec = divisible(shape, spec, mesh)
    local = torch.zeros(local_shape(shape, spec, mesh), dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def distribute(t: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> DTensor:
    """The DTensor of full tensor ``t`` (the same on every rank) with
    ``spec``: each rank keeps its own slice, no communication."""
    spec = divisible(t.shape, spec, mesh)
    coord = mesh.get_coordinate()
    names = mesh_axes(mesh)
    local = t
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            k = names.index(a)
            idx = idx * mesh.size(k) + coord[k]
            n *= mesh.size(k)
        step = t.shape[i] // n
        local = local.narrow(i, idx * step, step)
    local = local.detach().clone().requires_grad_(t.requires_grad)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------

def constrain(x, *axes):
    """Redistribute ``x`` to the spec ``axes`` (entries None, "model", or
    BATCH, resolved by :func:`resolve`) under the active mesh; ``x`` itself
    when no mesh is active or ``x`` is not a DTensor."""
    if not isinstance(x, DTensor):
        return x
    mesh = active_mesh()
    if mesh is None:
        return x
    spec = resolve(x.shape, axes, mesh)
    target = placements(spec, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def heads_axes(h: int, hd: int, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """(B, S, H, hd) axes: heads on 'model' when H divides; else the head
    dim; else neither."""
    msize = axis_size(mesh, "model")
    if h % msize == 0 and h >= msize:
        return (BATCH, None, "model", None)
    if hd % msize == 0:
        return (BATCH, None, None, "model")
    return (BATCH, None, None, None)


def constrain_heads(x):
    """(B, S, H, hd): shard heads on 'model' when H divides, else the head
    dim; ``x`` itself with no active mesh or a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    mesh = active_mesh()
    if mesh is None:
        return x
    return constrain(x, *heads_axes(x.shape[-2], x.shape[-1], mesh))


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor whose shape splits one dimension into
    several (or merges several into one) keeps a shard on that dimension
    only where DTensor's view rules can: a split dimension stays sharded on
    its first part when the shard count divides it, a merged one when the
    shard is on the first of the merged dimensions.  Any other shard of the
    reshaped dimensions is gathered first (an all-gather over that mesh
    dimension)."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    old, new = tuple(x.shape), tuple(shape)
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi_o, hi_n = len(old), len(new)
    while hi_o > lo and hi_n > lo and old[hi_o - 1] == new[hi_n - 1]:
        hi_o, hi_n = hi_o - 1, hi_n - 1
    mesh = x.device_mesh
    target = []
    for n, p in enumerate(x.placements):
        if isinstance(p, Shard) and lo <= p.dim < max(hi_o, lo + 1):
            count = mesh.size(n) * math.prod(
                mesh.size(m) for m, q in enumerate(x.placements)
                if m != n and isinstance(q, Shard) and q.dim == p.dim)
            keep = (p.dim == lo and hi_n > lo and new[lo] % count == 0)
            target.append(p if keep else Replicate())
        else:
            target.append(p)
    if tuple(target) != tuple(x.placements):
        x = x.redistribute(mesh, target)
    return _Reshape.apply(x, new)


def split_lanes(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)`` where ``shape`` splits ``x``'s last dimension F
    into (G, L), sharded on L where ``x`` is a DTensor with F sharded over
    'model' alone: rank r of m holds columns [r F/m, (r+1) F/m) and gets
    lanes [r L/m, (r+1) L/m) of every group, by one all-to-all over
    'model'.  With w = L/m, a rank's F/m = G w columns are G whole runs of
    w lanes; global run j belongs to group j // m and goes to rank j % m,
    so each rank receives its G runs in group order.  Where ``L % m != 0``,
    F is not sharded so, or autograd records (the all-to-all has no
    gradient): :func:`reshape` (which gathers F)."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    mesh, names = x.device_mesh, mesh_axes(x.device_mesh)
    g, lanes = shape[-2], shape[-1]
    d = x.ndim - 1
    n = names.index("model") if "model" in names else -1
    m = mesh.size(n) if n >= 0 else 1
    on_f = [k for k, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == d]
    if (tuple(shape[:-2]) != tuple(x.shape[:-1]) or g * lanes != x.shape[-1]
            or on_f != [n] or lanes % m
            or (torch.is_grad_enabled() and x.requires_grad)):
        return reshape(x, shape)
    from torch.distributed import _functional_collectives as funcol
    r = mesh.get_coordinate()[n]
    dest = [(r * g + i) % m for i in range(g)]          # each local run's rank
    order = sorted(range(g), key=lambda i: dest[i])
    runs = x.to_local().unflatten(-1, (g, lanes // m)).movedim(-2, 0)
    pieces, start = [], 0
    for k in range(1, g + 1):                           # consecutive runs at once
        if k == g or order[k] != order[k - 1] + 1:
            pieces.append(runs[order[start]:order[k - 1] + 1])
            start = k
    send = torch.cat(pieces) if len(pieces) > 1 else runs.contiguous()
    recv = funcol.all_to_all_single(
        send, [sum((j * m + r) // g == s for j in range(g)) for s in range(m)],
        [dest.count(t) for t in range(m)], mesh.get_group("model"))
    if isinstance(recv, funcol.AsyncCollectiveTensor):
        recv = recv.wait()
    pl = [Shard(d + 1) if k == n else p for k, p in enumerate(x.placements)]
    return DTensor.from_local(recv.movedim(0, -2).contiguous(), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the gradient back by the
    same rule (the gradient may be sharded where the forward was not)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return reshape(g, ctx.shape), None


def zeros_placed_like(x: torch.Tensor, shape: Sequence[int],
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x.new_zeros(shape)``; for a DTensor, zeros with ``x``'s placements
    (``shape`` differs from ``x``'s only in dimensions ``x`` is not sharded
    on), where DTensor's own ``new_zeros`` would replicate them."""
    dtype = dtype or x.dtype
    if not isinstance(x, DTensor):
        return x.new_zeros(shape, dtype=dtype)
    mesh = x.device_mesh
    local = list(shape)
    for n, p in enumerate(x.placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(n)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=x.to_local().device), mesh,
        x.placements, run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(shape))


# ---------------------------------------------------------------------------
# Local regions and their collectives
# ---------------------------------------------------------------------------

def local_map(fn: Callable, args: Sequence, in_specs: Sequence,
              out_specs, split_axes: Sequence[str] = ()) -> Any:
    """``fn`` on the local shards of ``args``, the port's ``shard_map``.

    Each DTensor argument is redistributed to its entry of ``in_specs`` (a
    spec, or placements; ``None`` keeps its placements) and handed to ``fn``
    as its local tensor; other arguments pass as they are.  Every tensor of
    ``fn``'s result becomes a DTensor with its entry of ``out_specs`` (a
    list, or one spec or placements for all; a ``Partial()`` marks a sum
    still to be taken over that mesh dimension).  Without a DTensor
    argument this is ``fn(*args)``.

    Differentiable: ``redistribute``, ``to_local`` and ``from_local`` carry
    the gradients.  An argument replicated over a mesh dimension on which
    the ranks do different work gets its gradient as a pending sum
    (``Partial``) there: the dimensions where a result is split, and
    ``split_axes`` (work split inside ``fn``, e.g. a vocabulary slice whose
    partial results ``fn`` sums itself)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    names = mesh_axes(mesh)
    outs = out_specs if isinstance(out_specs, list) else None
    split = {names.index(a) for a in split_axes if a in names}
    for o in (outs if outs is not None else [out_specs]):
        split |= {n for n, p in enumerate(_as_placements(o, None, mesh))
                  if not isinstance(p, Replicate)}
    local = []
    for a, s in zip(args, in_specs):
        if isinstance(a, DTensor):
            if s is not None:
                target = _as_placements(s, a.ndim, mesh)
                if tuple(a.placements) != target:
                    a = a.redistribute(mesh, target)
            grad_pl = [Partial() if n in split and isinstance(p, Replicate)
                       else p for n, p in enumerate(a.placements)]
            a = a.to_local(grad_placements=grad_pl)
        local.append(a)
    out = fn(*local)
    leaves, treedef = pytree.tree_flatten(out)
    it = iter(outs if outs is not None else [out_specs] * len(leaves))
    wrapped = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            pl = _as_placements(next(it), leaf.ndim, mesh)
            leaf = DTensor.from_local(leaf, mesh, pl, run_check=False)
        wrapped.append(leaf)
    return pytree.tree_unflatten(wrapped, treedef)


def _as_placements(s, ndim: Optional[int], mesh: DeviceMesh) -> Tuple[Any, ...]:
    """``s`` as placements: placements already, or a spec (padded to
    ``ndim`` entries)."""
    if len(s) == mesh.ndim and all(
            isinstance(p, (Shard, Replicate, Partial)) for p in s):
        return tuple(s)
    return placements(tuple(s) + (None,) * ((ndim or len(s)) - len(s)), mesh)


def group_size(mesh: Optional[DeviceMesh], axes: Sequence[str]) -> int:
    """The number of ranks over ``axes`` of ``mesh`` (1 with no mesh)."""
    if mesh is None:
        return 1
    return math.prod(axis_size(mesh, a) for a in axes)


def _all_reduce(t: torch.Tensor, op: str, mesh: DeviceMesh,
                axes: Sequence[str]) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    for a in axes:
        if axis_size(mesh, a) > 1:
            t = funcol.all_reduce(t, op, mesh.get_group(a))
            if isinstance(t, funcol.AsyncCollectiveTensor):
                t = t.wait()
    return t


class _PSum(torch.autograd.Function):
    """An all-reduce sum over mesh axes.  Its gradient is the incoming one
    when what follows is replicated over those axes (each rank's gradient
    of the sum is the same and is its gradient of its own summand), or the
    sum of the incoming ones (``grad_sum``) when the ranks go on to use the
    sum differently."""

    @staticmethod
    def forward(ctx, t, mesh, axes, grad_sum):
        ctx.mesh, ctx.axes, ctx.grad_sum = mesh, axes, grad_sum
        return _all_reduce(t, "sum", mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = _all_reduce(g, "sum", ctx.mesh, ctx.axes)
        return g, None, None, None


def psum(t: torch.Tensor, mesh: Optional[DeviceMesh], axes: Sequence[str],
         grad_sum: bool = False) -> torch.Tensor:
    """Sum of local ``t`` over the mesh ``axes`` (``t`` itself where they
    hold one rank); ``grad_sum``: see :class:`_PSum`."""
    if group_size(mesh, axes) == 1:
        return t
    return _PSum.apply(t, mesh, tuple(axes), grad_sum)


def pmax(t: torch.Tensor, mesh: Optional[DeviceMesh],
         axes: Sequence[str]) -> torch.Tensor:
    """Max of local ``t`` over the mesh ``axes``, without a gradient."""
    if group_size(mesh, axes) == 1:
        return t
    return _all_reduce(t.detach(), "max", mesh, axes)


def all_gather(t: torch.Tensor, dim: int, mesh: Optional[DeviceMesh],
               axes: Sequence[str]) -> torch.Tensor:
    """Local ``t`` concatenated along ``dim`` over the mesh ``axes`` (the
    first axis major), without a gradient."""
    from torch.distributed import _functional_collectives as funcol
    if group_size(mesh, axes) == 1:
        return t
    for a in reversed(tuple(axes)):
        if axis_size(mesh, a) > 1:
            t = funcol.all_gather_tensor(t.contiguous(), dim, mesh.get_group(a))
            if isinstance(t, funcol.AsyncCollectiveTensor):
                t = t.wait()
    return t


def coordinate(mesh: Optional[DeviceMesh], axes: Sequence[str]) -> int:
    """This rank's index over the mesh ``axes`` (the first axis major)."""
    if mesh is None:
        return 0
    names, coord = mesh_axes(mesh), mesh.get_coordinate()
    idx = 0
    for a in axes:
        if a in names:
            k = names.index(a)
            idx = idx * mesh.size(k) + coord[k]
    return idx


def replicated(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor (positions, masks: what every rank holds whole), else ``t``."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
