"""The dry run (``repro_torch.launch.dryrun``) and the sharded step it
costs, on the CPU.

* The fake-group dry run of a small config (2 layers, d_model 64) on the
  16x16 production mesh, in a child process (so no test process keeps a
  default process group): the reference's JSON keys, ``status: "ok"``, and
  argument bytes equal to the reference's ``build_lowering`` on an
  ``AbstractMesh`` for the same config.
* A real run on 4 gloo ranks (``mp.spawn``, ``file://`` rendezvous) on a 2x2
  (data, model) mesh: decode, prefill and one train step of a small config
  of each family, in PRECISE, against the port's unsharded run on the same
  weights.  Sharding changes the order of f32 sums, so the limits are the
  training checks' of the port: logits and loss within 1e-5 of the row's
  largest |value|; each gradient leaf within a relative L2 error of 1e-4,
  and each AdamW moment after the step within 2e-4 (a gradient's first
  and second powers); each parameter's AdamW update (its change over the
  step) within 1e-2 (a first AdamW step passes gradient errors near its
  eps straight through).  The dense configs cover the three ways
  attention splits over 'model' (KV-head groups, a group's query heads,
  the head dim with its scores summed over 'model'); the MoE drops pairs
  (capacity factor 0.5).  One rank a step
  (in turn) also runs the step's dry run on the same mesh under fake
  tensors: its per-device argument bytes and FLOPs equal that rank's real
  run's local ones.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("decode", "prefill", "train")
SEQ, BATCH = 16, 4
LOGIT_RTOL = 1e-5
GRAD_L2 = 1e-4
ADAMW_L2 = 1e-2
#: The moments are the gradients' first and second powers (their error at
#: most twice the gradients').
MOMENT_L2 = 2 * GRAD_L2


def _cases():
    """(name, config) of the small configs the gloo run covers."""
    import dataclasses

    from repro_torch.configs import get_config
    small = lambda arch, **kw: dataclasses.replace(
        get_config(arch).scaled_down(layers=None, d_model=64), **kw)
    qwen = small("qwen2-7b")
    granite = small("granite-moe-1b-a400m")
    return [
        ("dense-kv-groups", qwen),
        ("dense-query-heads", dataclasses.replace(qwen, num_heads=4, num_kv_heads=1)),
        ("dense-head-dim", dataclasses.replace(qwen, num_heads=3, num_kv_heads=3,
                                               head_dim=16)),
        ("moe", dataclasses.replace(granite, moe=dataclasses.replace(
            granite.moe, capacity_factor=0.5))),
        ("hybrid-ssm", small("hymba-1.5b")),
        ("xlstm", small("xlstm-350m")),
        ("encoder-decoder", small("whisper-small")),
        ("cross-attention", small("llama-3.2-vision-90b")),
    ]


def _child_env() -> dict:
    """A child process's environment: the port on its path, and one thread
    per process (the steps are small; a loaded host stalls the threads of
    a wider pool at every op)."""
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")


def _rel_l2(a, b) -> float:
    import torch
    a, b = a.detach().float(), b.detach().float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _row_err(got, want) -> float:
    """max over rows of max |got - want| / max |want| (the row's)."""
    got, want = got.detach().float(), want.detach().float()
    if got.ndim == 0:
        return float((got - want).abs() / want.abs().clamp_min(1e-30))
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1).clamp_min(1e-30)).max())


def _gloo_worker(rank, world, init_file, out_path):
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core.precision import ComputeMode
    from repro_torch.launch import specs as SP
    from repro_torch.launch.dryrun import run_pair, run_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import model as M
    from repro_torch.optim import adamw_init
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    precise = ComputeMode.PRECISE
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    results = {}
    for i, (name, cfg) in enumerate(_cases()):
        g = torch.Generator().manual_seed(3)
        aux = None
        seq_aux = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.num_image_tokens
        if seq_aux:
            aux = (torch.randn((BATCH, seq_aux, cfg.d_model), generator=g) * 0.5) \
                .to(torch.bfloat16)
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                               dtype=torch.int32)
        for kind in KINDS:
            shape = dict(seq_len=SEQ, global_batch=BATCH, kind=kind)
            spec = SP.build_lowering(cfg, shape, mesh, precise)
            out = {}
            if kind == "train":
                params = M.tree_map(lambda t: t.requires_grad_(True),
                                    M.init_params(cfg, 0, "cpu", torch.float32))
                opt = adamw_init(params)
                opt = opt._replace(step=torch.full((), 50, dtype=torch.int32))
                batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
                if aux is not None:
                    batch["aux"] = aux
                args = (params, opt, batch)
            else:
                params = M.init_params(cfg, 0, "cpu", torch.bfloat16)
                if kind == "prefill":
                    args = (params, tokens) + ((aux,) if aux is not None else ())
                else:
                    _, caches = M.prefill(params, tokens[:, :SEQ - 1], cfg,
                                          capacity=SEQ, aux=aux, mode=precise)
                    args = (params, caches, tokens[:, SEQ - 1:], spec.args[3])
            # Both runs take the arguments in the dtypes the lowering gives
            # them (the PRECISE prefill's f32 K/V become the cache's bf16).
            dtypes = iter([a.dtype for a in M.tree_leaves(spec.args)])
            args = M.tree_map(lambda t: t.to(next(dtypes)).requires_grad_(t.requires_grad),
                              args)
            sharded = SP.shard_like(spec.args, args)
            plain = M.tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad)
                               if isinstance(t, torch.Tensor) else t, args)
            if kind == "train":
                # The gradients, then the step (which moves the params in place).
                def grads(p, b):
                    loss = M.loss_fn(p, b["tokens"], b["labels"], cfg, aux=b.get("aux"),
                                     mode=precise)
                    return torch.autograd.grad(loss, list(M.tree_leaves(p)))
                from repro_torch.nn.sharding import activate_mesh
                with activate_mesh(mesh):
                    g_sh = [full(x) for x in grads(sharded[0], sharded[2])]
                g_pl = grads(plain[0], plain[2])
                out["grad_l2"] = max(_rel_l2(a, b) for a, b in zip(g_sh, g_pl))
                # The step moves the params in place: keep where they start.
                start = [[full(t).detach().clone() for t in M.tree_leaves(a[0])]
                         for a in (sharded, plain)]
            real = run_step(dataclasses.replace(spec, args=sharded), mesh)
            ref = spec.fn(*plain)
            if kind == "train":
                out["loss_err"] = _row_err(full(real["out"][2]), ref[2])
                out["update_l2"] = max(
                    _rel_l2(full(a) - a0, b - b0) for a, b, a0, b0 in zip(
                        M.tree_leaves(real["out"][0]), M.tree_leaves(ref[0]), *start))
                out["moment_l2"] = max(_rel_l2(full(a), b) for a, b in zip(
                    M.tree_leaves((real["out"][1].mu, real["out"][1].nu)),
                    M.tree_leaves((ref[1].mu, ref[1].nu))))
            else:
                out["logit_err"] = _row_err(full(real["out"][0]), ref[0])
            if (3 * i + KINDS.index(kind)) % world == rank:   # the dry runs, shared out
                res = run_pair(cfg.name, shape, mesh=mesh, cfg=cfg, mode=precise)
                out["dry"] = {"argument_bytes": res["memory"]["argument_bytes"],
                              "flops": res["flops_per_device"], "status": res["status"]}
                out["real"] = {"argument_bytes": real["argument_bytes"],
                               "flops": float(real["flops"])}
            results[f"{name}/{kind}"] = out
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(gathered, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    out = tmp / "out.json"
    env = _child_env()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--gloo",
                           str(tmp / "rendezvous"), str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


CASE_NAMES = ["dense-kv-groups", "dense-query-heads", "dense-head-dim", "moe",
              "hybrid-ssm", "xlstm", "encoder-decoder", "cross-attention"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_sharded_run_matches_the_unsharded_port(gloo_run, case, kind):
    for rank, res in enumerate(gloo_run):
        r = res[f"{case}/{kind}"]
        if kind == "train":
            assert r["loss_err"] <= LOGIT_RTOL, (rank, r)
            assert r["grad_l2"] <= GRAD_L2, (rank, r)
            assert r["update_l2"] <= ADAMW_L2, (rank, r)
            assert r["moment_l2"] <= MOMENT_L2, (rank, r)
        else:
            assert r["logit_err"] <= LOGIT_RTOL, (rank, r)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_dry_run_counts_the_real_run_s_local_bytes_and_flops(gloo_run, case, kind):
    ranks = [res[f"{case}/{kind}"] for res in gloo_run if "dry" in res[f"{case}/{kind}"]]
    assert len(ranks) == 1
    r = ranks[0]
    assert r["dry"]["status"] == "ok"
    assert r["dry"]["argument_bytes"] == r["real"]["argument_bytes"]
    assert r["dry"]["flops"] == r["real"]["flops"] > 0


ONE_RANK_CHILD = r"""
import json, os, sys
import torch, torch.distributed as dist
sys.path.insert(0, os.getcwd())
import chip_smoke
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1), rank=0, world_size=1)
mesh = make_host_mesh(data=1, model=1, device_type="cpu")
out = {}
for arch in ("qwen2-7b", "granite-moe-1b-a400m", "hymba-1.5b", "xlstm-350m",
             "whisper-small"):
    cfg = get_config(arch).scaled_down(layers=None, d_model=64)
    for kind in ("decode", "prefill", "train"):
        out[f"{arch}/{kind}"] = chip_smoke.mesh_pair(
            cfg, dict(seq_len=16, global_batch=2, kind=kind), mesh, device="cpu")
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_one_device_mesh_step_is_the_plain_step_bit_for_bit(tmp_path):
    """chip_smoke.py's phase 13(a) on a one-rank gloo group (CPU): the
    step of ``build_lowering`` on DTensors over a 1x1 mesh, bit for bit
    the plain step; the dry run's argument bytes and FLOPs equal the real
    step's (``FlopCounterMode``)."""
    env = _child_env()
    proc = subprocess.run([sys.executable, "-c", ONE_RANK_CHILD, str(tmp_path / "store")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out) == 15
    for name, res in out.items():
        assert res["bit_equal"], name
        assert res["flops"] == res["dry_flops"] > 0, name
        assert res["argument_bytes"] == res["dry_argument_bytes"], name


@pytest.mark.parametrize("window", [0, 5, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_skips_only_key_chunks_that_change_nothing(causal, window):
    """Positions the host knows (``range``s) let a query chunk skip the key
    chunks no row of it may attend to: the result equals the full walk's
    over the same positions as tensors bit for bit, in f32 and bf16, with
    padded query and key chunks, and fewer chunks run."""
    import itertools

    import torch

    from repro_torch.nn import attention as A
    torch.manual_seed(0)
    # Hundreds of tiny ops: one thread each, or a loaded host's other
    # processes stall every op's thread barrier.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for sq, dt, qc, kc in itertools.product([7, 100, 257],
                                                [torch.float32, torch.bfloat16],
                                                [16, 256], [8, 32]):
            q, k, v = (torch.randn(2, sq, n, 8).to(dt) for n in (4, 2, 2))
            kw = dict(causal=causal, window=window, logit_cap=0.0, scale=0.3,
                      q_chunk=qc, k_chunk=kc)
            with torch.no_grad():
                full = A._chunk_attn_local(q, k, v, torch.arange(sq), torch.arange(sq),
                                           **kw)
                skip = A._chunk_attn_local(q, k, v, range(sq), range(sq), **kw)
            assert torch.equal(full, skip), (sq, dt, qc, kc)
    finally:
        torch.set_num_threads(threads)
    live = A._live_key_chunks(range(1024), range(1024), 256, 128, causal, window)
    assert sum(map(len, live)) < 4 * 8 if causal or window else sum(map(len, live)) == 32


DRY_CHILD = r"""
import json, sys, dataclasses
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_pair
cfg = get_config("qwen2-7b").scaled_down(layers=2, d_model=64)
out = {sh: run_pair("qwen2-7b", sh, cfg=cfg, device="cpu")
       for sh in ("decode_32k", "long_500k")}
# A cache made on the mesh has the lowering's layout, shard for shard.
import torch.distributed as dist
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_lowering
from repro_torch.nn import model as M
mesh = make_production_mesh(device_type="cpu")
want = [(tuple(a.placements), tuple(a.to_local().shape))
        for a in M.tree_leaves(build_lowering(cfg, "decode_32k", mesh).args[1])]
got = [(tuple(a.placements), tuple(a.to_local().shape))
       for a in M.tree_leaves(M.init_cache(cfg, 128, 32768, device="cpu", mesh=mesh))]
out["init_cache_on_mesh"] = got == want and any(p != want[0][0][0] for p in want[0][0])
print(json.dumps(out))
"""


def test_fake_group_dry_run_on_the_production_mesh_gives_the_reference_s_keys_and_bytes():
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config
    from repro.launch import specs as JS
    env = _child_env()
    proc = subprocess.run([sys.executable, "-c", DRY_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("init_cache_on_mesh") is True
    cfg = get_config("qwen2-7b").scaled_down(layers=2, d_model=64)
    try:
        mesh = AbstractMesh((16, 16), ("data", "model"))
    except TypeError:
        mesh = AbstractMesh((("data", 16), ("model", 16)))
    keys = {"arch", "shape", "multi_pod", "mesh", "status", "layers_override",
            "lower_seconds", "compile_seconds", "flops_per_device",
            "bytes_accessed_per_device", "memory", "collectives"}
    for sh, res in out.items():
        assert set(res) == keys
        assert set(res["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "generated_code_bytes"}
        assert res["status"] == "ok" and res["mesh"] == "16x16"
        assert res["compile_seconds"] == 0.0 and res["memory"]["generated_code_bytes"] == 0
        low = JS.build_lowering(cfg, sh, mesh)
        want = sum(int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
                   * np.dtype(leaf.dtype).itemsize for leaf in jax.tree.leaves(low.args))
        assert res["memory"]["argument_bytes"] == want, sh
        assert res["flops_per_device"] > 0 and res["memory"]["temp_bytes"] > 0
        for kind, c in res["collectives"].items():
            assert kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                            "collective-permute") and c["count"] > 0 and c["bytes"] > 0


if __name__ == "__main__":
    if sys.argv[1] == "--gloo":
        import torch.multiprocessing as mp
        mp.spawn(_gloo_worker, args=(4, sys.argv[2], sys.argv[3]), nprocs=4, join=True)
