"""Multi-pod dry run: one (arch x shape) pair's step, run once under fake
tensors on the production mesh, as rank 0 of 256 or 512.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles the
pair with XLA on 512 placeholder host devices and reads XLA's cost and
memory analysis.  Here the process joins ``torch.distributed``'s fake
process group at the mesh's world size (``launch/mesh.py``), builds the
arguments as DTensors with fake local shards (``launch/specs.py``), and
runs the step once under ``FakeTensorMode``: nothing is allocated and no
collective moves data, but every op and every collective of rank 0 runs
with its real local shapes.  :class:`LocalCost`, a dispatch mode under
DTensor, records per device:

* FLOPs (torch's ``flop_counter`` formulas) and operand bytes (inputs read
  and outputs written by each op that is not a view) of the *local* ops;
* the collectives by the reference's kinds, with count and result bytes;
* the peak of live local bytes (every storage from its first op's output
  to its last reference), from the arguments up.

Sharding mismatches and unsupported collectives surface as errors.

Differences from the reference's numbers: every layer is counted (the
port loops in Python; XLA's cost analysis counts a scan body once, hence
the reference's ``--variants`` G=1/G=2 correction, which the port's
numbers do not need); nothing is compiled (``compile_seconds`` 0.0,
``generated_code_bytes`` 0); the collectives are those of DTensor's
sharding propagation and the port's constraint points, not XLA's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--multipod] [--json out.json] [--layers-override N] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: collective ops -> the reference's kinds
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


#: queries of a tensor's metadata, which move nothing (as FlopCounterMode)
_METADATA_OPS = {torch.ops.prim.device.default, torch.ops.prim.layout.default,
                 torch.ops.aten.is_contiguous.default,
                 torch.ops.aten.is_contiguous.memory_format,
                 torch.ops.aten.sym_size.default, torch.ops.aten.sym_stride.default,
                 torch.ops.aten.sym_numel.default,
                 torch.ops.aten.sym_storage_offset.default,
                 torch.ops.aten.size.default, torch.ops.aten.stride.default,
                 torch.ops.aten.numel.default, torch.ops.aten.dim.default,
                 torch.ops.aten.storage_offset.default}


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts (an op's arguments
    or results, a step's arguments)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalCost(TorchDispatchMode):
    """Per-device cost of what runs under it: the ops on local tensors (a
    DTensor op is handed back to DTensor, whose local ops then come here).

    ``flops`` (torch's formulas; an op without one is decomposed as
    ``FlopCounterMode`` does), ``bytes_accessed``, ``collectives``
    ({kind: {"count", "bytes"}}), and ``peak_bytes`` of live storages, from
    ``track(args)`` up."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, Dict[str, int]] = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0})
        self.ops = collections.Counter()
        self.op_flops = collections.Counter()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, Any] = {}
        self._suspended = 0
        self._depth = 0
        self._decomposable: Dict[Any, bool] = {}

    def __enter__(self):
        # DTensor's sharding propagation runs an op on global-shape fake
        # tensors to learn its output's shape (once per signature); that is
        # not work a rank does.
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        if self._depth == 0:
            self._prop = prop = ShardingPropagator._propagate_tensor_meta_non_cached
            mode = self

            def propagate(sp, op_schema):
                mode._suspended += 1
                try:
                    return prop(sp, op_schema)
                finally:
                    mode._suspended -= 1
            ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._depth -= 1
        if self._depth == 0:
            ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def _decomposes(self, func, packet) -> bool:
        """Whether ``func`` has no FLOP formula but a decomposition into
        ops (``FlopCounterMode``'s rule), cached per op."""
        known = self._decomposable.get(func)
        if known is None:
            known = (func not in self.registry and packet not in self.registry
                     and func is not torch.ops.prim.device.default
                     and torch._C._dispatch_has_kernel_for_dispatch_key(
                         func.name(), "CompositeImplicitAutograd"))
            self._decomposable[func] = known
        return known

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s local tensors as live; their
        bytes."""
        from torch.distributed.tensor import DTensor
        before = self.live
        for t in _tensors(tree):
            self._add(t.to_local() if isinstance(t, DTensor) else t)
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            self._seen.pop(key, None)
            self.live -= n
        self._seen[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func in _METADATA_OPS:
            return NotImplemented
        if DTensor in types:
            return NotImplemented
        if self._suspended:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if self._decomposes(func, packet):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = packet.__name__
        self.ops[name] += 1
        if packet in self.registry:
            f = self.registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.op_flops[name] += f
        outs = _tensors(out)
        if name in COLLECTIVES:
            c = self.collectives[COLLECTIVES[name]]
            c["count"] += 1
            c["bytes"] += sum(_nbytes(t) for t in outs)
        if not (func.is_view or name in ("wait_tensor", "detach", "alias")):
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes_accessed += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._add(t)
        return out


def apply_layers_override(cfg, layers_override: int):
    """The same-width config at ``layers_override`` pattern periods (and as
    many encoder layers)."""
    if not layers_override:
        return cfg
    enc = layers_override if cfg.encoder_layers else 0
    return dataclasses.replace(cfg, num_layers=layers_override * cfg.pattern_period,
                               encoder_layers=enc)


def run_step(spec, mesh, *, trace_out: str = "") -> Dict[str, Any]:
    """Run ``spec.fn(*spec.args)`` once under an active ``mesh`` with
    :class:`LocalCost`; the cost figures, the output and the recorded op
    and collective counts.  The caller provides the arguments (fake or real
    local shards)."""
    from ..nn.sharding import activate_mesh
    cost = LocalCost()
    arg_bytes = cost.track(spec.args)
    t0 = time.time()
    with activate_mesh(mesh), cost:
        out = spec.fn(*spec.args)
        out_bytes = sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
                        for t in _tensors(out))
    seconds = time.time() - t0
    if trace_out:
        with open(trace_out, "w") as f:
            for name, n in sorted(cost.ops.items()):
                f.write(f"op {name} {n} {cost.op_flops.get(name, 0)}\n")
            for kind, c in sorted(cost.collectives.items()):
                f.write(f"collective {kind} {c['count']} {c['bytes']}\n")
    return {"seconds": seconds, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "peak_bytes": cost.peak,
            "flops": cost.flops, "bytes_accessed": cost.bytes_accessed,
            "collectives": {k: dict(v) for k, v in cost.collectives.items()},
            "out": out}


def run_pair(arch: str, shape, *, multi_pod: bool = False,
             layers_override: int = 0, hlo_out: str = "", mesh=None,
             device: str = "cuda", cfg=None, mode=None) -> dict:
    """The dry run of one pair.  ``mesh``: a mesh to run on instead of the
    production one (the tests' and the card's host meshes); ``device``: the
    production mesh's device type (a "cuda" mesh records a MoE's
    all-to-all as one, where a CPU group gathers); ``cfg``: a config to run
    instead of ``arch``'s; ``shape``: as :func:`specs.build_lowering`
    takes it; ``mode``: the compute mode (RELAXED)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import get_config
    from .mesh import make_production_mesh
    from .specs import argument_bytes, build_lowering, shape_skipped

    from ..core.precision import ComputeMode
    cfg = cfg or get_config(arch)
    reason = shape_skipped(cfg, shape) if isinstance(shape, str) else None
    if reason:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    cfg = apply_layers_override(cfg, layers_override)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    mesh_name = "x".join(str(n) for n in mesh.mesh.shape)
    t0 = time.time()
    with FakeTensorMode():
        spec = build_lowering(cfg, shape, mesh, mode or ComputeMode.RELAXED,
                              device=mesh.device_type)
        t_build = time.time() - t0
        res = run_step(spec, mesh, trace_out=hlo_out)
        del res["out"]
    assert res["argument_bytes"] == argument_bytes(spec.args)
    return {
        "arch": arch, "shape": shape if isinstance(shape, str) else shape["kind"],
        "multi_pod": multi_pod,
        "mesh": mesh_name,
        "status": "ok",
        "layers_override": layers_override,
        "lower_seconds": round(t_build + res["seconds"], 1),
        "compile_seconds": 0.0,
        "flops_per_device": float(res["flops"]),
        "bytes_accessed_per_device": float(res["bytes_accessed"]),
        "memory": {
            "argument_bytes": res["argument_bytes"],
            "output_bytes": res["output_bytes"],
            "temp_bytes": res["peak_bytes"] - res["argument_bytes"],
            "generated_code_bytes": 0,
        },
        "collectives": res["collectives"],
    }


def host_mesh(data: int, model: int, device: str = "cuda"):
    """A (data, model) mesh on the fake process group (world data x model),
    as rank 0."""
    import torch.distributed as dist

    from .mesh import _fake_store, make_host_mesh
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=data * model)
    return make_host_mesh(data=data, model=model, device_type=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--layers-override", type=int, default=0)
    ap.add_argument("--json", default="")
    ap.add_argument("--hlo-out", default="",
                    help="write the recorded op and collective counts here")
    ap.add_argument("--batch-out", default="",
                    help="directory: run all shapes/meshes, write per-pair JSONs")
    ap.add_argument("--variants", action="store_true",
                    help="also the G=1/G=2 depths (kept for the reference's "
                         "CLI; the port counts every layer)")
    ap.add_argument("--skip-multipod", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake mesh")
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL: a fake (data, model) host mesh of that size "
                         "instead of the production one (e.g. 1x1, one device)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        mesh = host_mesh(*(int(n) for n in args.mesh.split("x")), device=args.device)

    if args.batch_out:
        # One process runs one mesh size: the fake group's world size is
        # fixed at its first use.
        os.makedirs(args.batch_out, exist_ok=True)
        shapes = [args.shape] if args.shape else list(
            ("train_4k", "prefill_32k", "decode_32k", "long_500k"))
        meshes = [False] if args.skip_multipod else [args.multipod]
        jobs = []
        for shape in shapes:
            for mp in meshes:
                jobs.append((shape, mp, 0))
                if args.variants and not mp:
                    jobs += [(shape, mp, 1), (shape, mp, 2)]
        for shape, mp, g in jobs:
            tag = f"{args.arch}.{shape}.{'2x16x16' if mp else '16x16'}"
            if g:
                tag += f".g{g}"
            out = os.path.join(args.batch_out, tag + ".json")
            if os.path.exists(out):
                with open(out) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        print(f"{tag}: cached", flush=True)
                        continue
            t0 = time.time()
            try:
                result = run_pair(args.arch, shape, multi_pod=mp,
                                  layers_override=g, device=args.device)
            except Exception as e:  # reported as data
                result = {"arch": args.arch, "shape": shape, "multi_pod": mp,
                          "mesh": "2x16x16" if mp else "16x16",
                          "layers_override": g, "status": "error",
                          "error": f"{type(e).__name__}: {e}",
                          "traceback": traceback.format_exc()[-4000:]}
            with open(out, "w") as f:
                json.dump(result, f, indent=1, default=str)
            print(f"{tag}: {result['status']} ({time.time() - t0:.0f}s)",
                  flush=True)
        return 0

    try:
        result = run_pair(args.arch, args.shape, multi_pod=args.multipod,
                          layers_override=args.layers_override,
                          hlo_out=args.hlo_out, device=args.device, mesh=mesh)
    except Exception as e:  # report failures as data, exit nonzero
        result = {"arch": args.arch, "shape": args.shape,
                  "multi_pod": args.multipod, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    print(json.dumps(result, indent=1, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return 0 if result["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
