"""The port's shardings against the reference's.

For every config and shape, on the two production meshes (16x16 and
2x16x16) and on a 1x1 and a 2x2 mesh, every argument of
``repro_torch.launch.specs.build_lowering`` (parameters, AdamW moments,
batch, decode caches, position) has the local shape and dtype that
``repro.launch.specs.build_lowering`` gives it on a
``jax.sharding.AbstractMesh`` (no devices, no compile), and the per-device
argument bytes are equal.  The reference stacks each pattern position's
parameters and caches ``(G, ...)``; the port keeps one leaf a layer, so
layer ``g * P + p`` of the port is entry ``g`` of the reference's position
``p`` with the (never sharded) stacking axis dropped.

The port's side runs in one child process a mesh: a process has one fake
process group, whose world size is the mesh's.  The rule tables, specs,
skips, window overrides, microbatch counts and logical axes are held
against the reference's directly; ``constrain`` with no mesh returns its
input object.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["granite-moe-1b-a400m", "xlstm-350m", "whisper-small", "hymba-1.5b",
         "qwen2-7b", "gemma2-9b", "qwen3-32b", "command-r-plus-104b",
         "llama-3.2-vision-90b", "qwen3-moe-235b-a22b"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _port_leaves(tree, prefix=()):
    """(path, local shape, dtype) of every tensor of a port argument tree."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _port_leaves(v, prefix + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, prefix + (i,))
    elif isinstance(tree, torch.Tensor):
        local = tree.to_local() if isinstance(tree, DTensor) else tree
        yield (prefix, tuple(local.shape), str(local.dtype).replace("torch.", ""))


def _worker(mesh_name: str) -> None:
    """The port's side for one mesh, printed as JSON."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.specs import (SHAPES, argument_bytes, build_lowering,
                                          shape_skipped)
    shape, _ = MESHES[mesh_name]
    if mesh_name in ("16x16", "2x16x16"):
        mesh = make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        mesh = make_host_mesh(data=shape[0], model=shape[1], device_type="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        out[arch] = {}
        for sh in SHAPES:
            if shape_skipped(cfg, sh):
                continue
            spec = build_lowering(cfg, sh, mesh)
            out[arch][sh] = {
                "bytes": argument_bytes(spec.args),
                "leaves": [[list(map(str, p)), list(s), d]
                           for p, s, d in _port_leaves(spec.args)]}
    print(json.dumps(out))


@pytest.fixture(scope="module")
def port_side():
    # One thread a child: four run at once, and the work is fake tensors.
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), name], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in MESHES}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _abstract_mesh(shape, names):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(shape, names)
    except TypeError:           # older jax: ((name, size), ...)
        return AbstractMesh(tuple(zip(names, shape)))


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _reference_leaves(cfg, lowering, kind):
    """The reference's arguments as the port lays them out: (path, local
    shape, dtype), one entry per layer where the reference stacks them."""
    import jax
    period = cfg.pattern_period
    flat, _ = jax.tree_util.tree_flatten_with_path(lowering.args)
    out = []
    for path, leaf in flat:
        keys = [_key(k) for k in path]
        local = tuple(leaf.sharding.shard_shape(leaf.shape))
        dtype = str(np.dtype(leaf.dtype))
        if "blocks" in keys or "enc_blocks" in keys:
            at = keys.index("blocks") if "blocks" in keys else keys.index("enc_blocks")
            if keys[at] == "blocks":
                groups, name = cfg.num_groups, "layers"
                layer = lambda g: g * period + int(keys[at + 1])
            else:
                groups, name = cfg.encoder_layers, "enc_layers"
                layer = lambda g: g
            for g in range(groups):
                out.append((keys[:at] + [name, str(layer(g))] + keys[at + 2:],
                            local[1:], dtype))
        elif kind == "decode" and keys[0] == "1":        # caches: (G, B, ...)
            for g in range(cfg.num_groups):
                out.append(([keys[0], str(g * period + int(keys[1]))] + keys[2:],
                            local[1:], dtype))
        else:
            out.append((keys, local, dtype))
    return out


@pytest.fixture(scope="module")
def reference_side():
    import jax
    from repro.configs import get_config
    from repro.launch import specs as JS
    out = {}
    for name, (shape, names) in MESHES.items():
        mesh = _abstract_mesh(shape, names)
        out[name] = {}
        for arch in ARCHS:
            cfg = get_config(arch)
            out[name][arch] = {}
            for sh, info in JS.SHAPES.items():
                if JS.shape_skipped(cfg, sh):
                    continue
                low = JS.build_lowering(cfg, sh, mesh)
                leaves = _reference_leaves(cfg, low, info["kind"])
                nbytes = sum(math.prod(s) * np.dtype(d).itemsize for _, s, d in leaves)
                # The stacked layout's bytes are the same count.
                assert nbytes == sum(
                    math.prod(leaf.sharding.shard_shape(leaf.shape))
                    * np.dtype(leaf.dtype).itemsize
                    for leaf in jax.tree.leaves(low.args))
                out[name][arch][sh] = {"bytes": nbytes, "leaves": leaves}
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_and_argument_bytes_equal_the_reference(port_side, reference_side,
                                                             mesh, arch):
    port, ref = port_side[mesh][arch], reference_side[mesh][arch]
    assert sorted(port) == sorted(ref)
    for sh in ref:
        want = {tuple(p): (tuple(s), d) for p, s, d in ref[sh]["leaves"]}
        got = {tuple(p): (tuple(s), d) for p, s, d in port[sh]["leaves"]}
        assert len(want) == len(ref[sh]["leaves"]) and len(got) == len(port[sh]["leaves"])
        assert got == want, (sh, sorted(set(got.items()) ^ set(want.items()))[:6])
        assert port[sh]["bytes"] == ref[sh]["bytes"], sh


@pytest.mark.parametrize("mesh,arch,shape,gb", [
    ("16x16", "qwen2-7b", "decode_32k", 1.89), ("2x16x16", "qwen2-7b", "decode_32k", 1.42),
    ("16x16", "command-r-plus-104b", "train_4k", 5.02),
    ("2x16x16", "command-r-plus-104b", "train_4k", 5.02),
    ("2x16x16", "qwen3-moe-235b-a22b", "train_4k", 11.06)])
def test_argument_bytes_of_named_pairs(port_side, mesh, arch, shape, gb):
    assert round(port_side[mesh][arch][shape]["bytes"] / 1e9, 2) == gb


def test_rules_specs_skips_windows_and_microbatches_equal_the_reference():
    from repro.configs import get_config as jget
    from repro.launch import specs as JS
    from repro.nn import sharding as JSH

    from repro_torch.configs import get_config as tget
    from repro_torch.launch import specs as TS
    from repro_torch.nn import sharding as TSH
    assert TSH.BATCH == JSH.BATCH
    assert TS.SHAPES == JS.SHAPES
    for arch in ARCHS:
        jc, tc = jget(arch), tget(arch)
        for mode in ("train", "infer"):
            assert TSH.rules(mode, tc) == JSH.rules(mode, jc)
            for axes in [("embed", "heads"), ("vocab", "embed"), ("experts", "embed", None),
                         ("inner", "state"), (None,), ("mlp", "embed")]:
                assert TSH.spec_for(axes, mode, tc) == tuple(JSH.spec_for(axes, mode, jc))
        for sh in JS.SHAPES:
            assert TS.shape_skipped(tc, sh) == JS.shape_skipped(jc, sh)
            assert TS.window_override_for(tc, sh) == JS.window_override_for(jc, sh)
            for width in (1, 16, 32):
                info = JS.SHAPES[sh]
                assert TS.default_microbatches(
                    tc, info["global_batch"], info["seq_len"], batch_width=width) == \
                    JS.default_microbatches(jc, info["global_batch"], info["seq_len"],
                                            batch_width=width)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_are_the_reference_s_without_the_layers_axis(arch):
    import jax
    from repro.configs import get_config as jget
    from repro.nn.model import param_axes as jaxes

    from repro_torch.configs import get_config as tget
    from repro_torch.nn.model import param_axes as taxes
    from repro_torch.nn.sharding import axes_leaves
    cfg = jget(arch)
    is_axes = lambda x: isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                                     for a in x)
    want = {}
    for path, axes in jax.tree_util.tree_flatten_with_path(jaxes(cfg), is_leaf=is_axes)[0]:
        keys = [_key(k) for k in path]
        if keys[0] == "blocks":
            assert axes[0] == "layers"
            for g in range(cfg.num_groups):
                want[("layers", str(g * cfg.pattern_period + int(keys[1])))
                     + tuple(keys[2:])] = axes[1:]
        elif keys[0] == "enc_blocks":
            assert axes[0] == "layers"
            for g in range(cfg.encoder_layers):
                want[("enc_layers", str(g)) + tuple(keys[2:])] = axes[1:]
        else:
            want[tuple(keys)] = axes
    got = {}

    def walk(tree, prefix=()):
        if is_axes(tree):
            got[prefix] = tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, prefix + (k,))
        else:
            for i, v in enumerate(tree):
                walk(v, prefix + (str(i),))
    axes_tree = taxes(tget(arch))
    walk(axes_tree)
    assert got == want
    assert len(list(axes_leaves(axes_tree))) == len(got)


def test_importing_the_mesh_modules_starts_no_process_group_and_no_jax():
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.nn.sharding, repro_torch.launch.mesh\n"
            "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.sweep\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "print(dist.is_initialized(), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False []"


def test_checkpoint_recompute_sees_the_mesh_from_another_thread():
    """On the card autograd runs a checkpoint's recompute in its device
    thread, which does not inherit the context: the recompute must still
    see the mesh the forward ran under (its constraints are the forward's)."""
    import threading

    import torch

    from repro_torch.nn import sharding as S
    from repro_torch.nn.layers import checkpoint_if_recording
    seen = []

    def fn(t):
        seen.append(S.active_mesh())
        return torch.sin(t)           # saves t: the backward recomputes
    mesh = object()
    x = torch.ones(3, requires_grad=True)
    with S.activate_mesh(mesh):
        y = checkpoint_if_recording(fn, x).sum()
    worker = threading.Thread(target=lambda: torch.autograd.grad(y, [x]))
    worker.start()
    worker.join()
    assert seen == [mesh, mesh]
    assert checkpoint_if_recording(fn, x) is not None and seen[-1] is None


def test_constrain_returns_its_input_without_a_mesh():
    import torch

    from repro_torch.nn import sharding as S
    x = torch.zeros(4, 8, 16)
    assert S.active_mesh() is None
    assert S.constrain(x, S.BATCH, None, "model") is x
    assert S.constrain_heads(x.reshape(4, 8, 2, 8)).shape == (4, 8, 2, 8)
    h = x.reshape(4, 8, 2, 8)
    assert S.constrain_heads(h) is h
    assert S.reshape(x, (4, 8, 2, 8)).shape == (4, 8, 2, 8)
    assert S.local_map(lambda a: a + 1, [x], [None], None).sum() == x.numel()


def test_specs_map_to_placements_pod_major_and_drop_what_does_not_divide():
    """Without a process group: a stand-in with a DeviceMesh's names and
    sizes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.nn import sharding as S

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        ndim = 3

        def size(self, i):
            return (2, 16, 16)[i]
    m = Mesh()
    assert S.placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements((None, None), m) == (Replicate(),) * 3
    assert S.divisible((64, 28 * 128), (("pod", "data"), "model"), m) == \
        (("pod", "data"), "model")
    assert S.divisible((8, 100), (("pod", "data"), "model"), m) == (None, None)
    assert S.resolve((1, 7), (S.BATCH, "model"), m) == (None, None)
    assert S.resolve((32, 16), (S.BATCH, "model"), m) == (("pod", "data"), "model")
    assert S.local_shape((64, 4096), (("pod", "data"), "model"), m) == (2, 256)
    assert S.heads_axes(28, 128, m) == (S.BATCH, None, None, "model")
    assert S.heads_axes(64, 128, m) == (S.BATCH, None, "model", None)
    with pytest.raises(ValueError):
        S.placements((("data", "pod"),), m)


if __name__ == "__main__":
    _worker(sys.argv[1])
