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
        ("encoder-decoder-head-dim", dataclasses.replace(
            small("whisper-small"), num_heads=3, num_kv_heads=3, head_dim=16)),
    ]


#: Cases whose attention splits the head dim over 'model': their decode
#: moves the fused K/V cache (and the cross-attention's K/V) onto the
#: head-dim split by one all-to-all each (``sharding.split_lanes``).
HEAD_DIM_CASES = ("dense-head-dim", "encoder-decoder-head-dim")
#: (mesh (data, model), KV heads, head dim) of the lane-split exactness
#: checks: groups that straddle ranks, more groups than ranks, and a head
#: dim 'model' does not divide (the gather path).
LANE_SHAPES = [((2, 2), 3, 16), ((2, 2), 5, 8), ((1, 4), 3, 16), ((1, 4), 5, 8),
               ((1, 4), 2, 6)]


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
    results = {**_lane_checks(rank), **_embed_checks(rank)}
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    precise = ComputeMode.PRECISE
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
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
            if kind == "decode" and name in HEAD_DIM_CASES:
                out.update(_against_the_gather_path(spec, args, mesh, full))
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


def _lane_checks(rank) -> dict:
    """``sharding.split_lanes`` on each of LANE_SHAPES: this rank's result
    against the slice of the full reshape it should hold, bit for bit, its
    placements, and the collectives it made."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.dryrun import LocalCost
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import sharding as S
    out = {}
    for (data, model), kv, hd in LANE_SHAPES:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        b, cap = 4, 5
        g = torch.Generator().manual_seed(kv * hd)
        for dt in (torch.float32, torch.bfloat16):
            whole = torch.randn((b, cap, kv * hd), generator=g).to(dt)
            x = S.distribute(whole, mesh, S.cache_spec(whole.shape, mesh))
            cost = LocalCost()
            with cost:
                y = S.split_lanes(x, (b, cap, kv, hd))
            want = whole.reshape(b, cap, kv, hd)
            coord = mesh.get_coordinate()
            if data > 1:
                want = want.narrow(0, coord[0] * (b // data), b // data)
            lanes = hd % model == 0
            if lanes:
                want = want.narrow(3, coord[1] * (hd // model), hd // model)
            out[f"lanes/{data}x{model}/{kv}x{hd}/{dt}"] = {
                "equal": torch.equal(y.to_local(), want),
                "placements": tuple(y.placements) == (
                    x.placements[0], Shard(3) if lanes else Replicate()),
                "split": lanes,
                "collectives": {k: dict(v) for k, v in cost.collectives.items()},
                "rank": rank}
    return out


def _embed_checks(rank) -> dict:
    """``layers.embed`` of a table sharded in 2-D (vocab on 'model', embed
    on 'data') on the 2x2 mesh, for a batch of 1 (not split: the lookup
    keeps the embed split) and of 2 (split over 'data': the table's embed
    dim is gathered): the looked-up rows bit for bit, and the collectives
    of the lookup itself."""
    import torch

    from repro_torch.launch.dryrun import LocalCost
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import layers as L
    from repro_torch.nn import sharding as S
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    g = torch.Generator().manual_seed(7)
    table = torch.randn((8, 6), generator=g).to(torch.bfloat16)
    out = {}
    for b in (1, 2):
        tokens = torch.randint(0, 8, (b, 3), generator=g, dtype=torch.int32)
        t = S.distribute(table, mesh, ("model", "data"))
        ids = S.distribute(tokens, mesh, S.resolve(tokens.shape, (S.BATCH,), mesh))
        cost = LocalCost()
        with cost:
            x = L.embed(t, ids)
        out[f"embed/{b}"] = {"equal": torch.equal(x.full_tensor(), table[tokens.long()]),
                             "collectives": {k: dict(v) for k, v in cost.collectives.items()},
                             "rank": rank}
    return out


def _against_the_gather_path(spec, args, mesh, full) -> dict:
    """The sharded decode with its K/V moved by all-to-all against the
    same decode with them gathered (``sharding.reshape``): logits and every
    cache leaf bit for bit."""
    import dataclasses

    from repro_torch.launch import specs as SP
    from repro_torch.launch.dryrun import run_step
    from repro_torch.nn import attention as A
    from repro_torch.nn import model as M
    from repro_torch.nn import sharding as S
    runs, colls = [], []
    for split in (S.split_lanes, S.reshape):
        A.S.split_lanes, keep = split, S.split_lanes
        try:
            res = run_step(dataclasses.replace(spec, args=SP.shard_like(spec.args, args)),
                           mesh)
        finally:
            A.S.split_lanes = keep
        runs.append([full(t) for t in M.tree_leaves(res["out"])])
        colls.append(res["collectives"])
    return {"gather_path_equal": all(a.equal(b) for a, b in zip(*runs))
            and len(runs[0]) == len(runs[1]) > 1,
            "collectives": colls[0], "gather_path_collectives": colls[1]}


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
              "hybrid-ssm", "xlstm", "encoder-decoder", "cross-attention",
              "encoder-decoder-head-dim"]


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


@pytest.mark.parametrize("shape", LANE_SHAPES, ids=lambda s: "{}x{}-kv{}-hd{}".format(*s[0], *s[1:]))
def test_split_lanes_holds_each_rank_s_lanes_bit_for_bit(gloo_run, shape):
    """Every rank's result is its slice of the full reshape: its batch rows
    and, where 'model' divides the head dim, its lanes of every head, moved
    by one all-to-all and nothing else; else the whole head dim, gathered."""
    (data, model), kv, hd = shape
    rows = [r for res in gloo_run for k, r in res.items()
            if k.startswith(f"lanes/{data}x{model}/{kv}x{hd}/")]
    assert len(rows) == 4 * 2
    for r in rows:
        assert r["equal"] and r["placements"], r
        kinds = r["collectives"]
        if r["split"]:
            assert set(kinds) == {"all-to-all"} and kinds["all-to-all"]["count"] == 1, r
        else:
            assert "all-to-all" not in kinds and kinds["all-gather"]["count"] >= 1, r


@pytest.mark.parametrize("batch", [1, 2])
def test_embedding_lookup_keeps_the_embed_split_the_batch_does_not_use(gloo_run, batch):
    """A batch of 1 looks up each rank's slice of the 2-D-sharded table's
    embed dim with no gather; a batch split over 'data' gathers that dim
    (the FSDP gather); both give the table's rows bit for bit."""
    rows = [res[f"embed/{batch}"] for res in gloo_run]
    for r in rows:
        assert r["equal"], r
        assert ("all-gather" in r["collectives"]) is (batch == 2), r


@pytest.mark.parametrize("case", HEAD_DIM_CASES)
def test_head_dim_decode_moves_the_cache_by_all_to_all(gloo_run, case):
    """The decode of a config whose attention splits the head dim moves
    each layer's K and V cache (and a cross-attention's K and V) by one
    all-to-all of the local shard where the gather path gathered them
    whole, makes every other collective as that path does, and gives its
    logits and caches bit for bit."""
    cfg = dict(_cases())[case]
    n, fused = cfg.num_layers, cfg.num_kv_heads * cfg.resolved_head_dim
    seqs = [SEQ] + ([cfg.encoder_seq] if cfg.is_encoder_decoder else [])
    shard = sum((BATCH // 2) * s * (fused // 2) * 2 for s in seqs)    # bf16, 2x2 mesh
    for res in gloo_run:
        r = res[f"{case}/decode"]
        assert r["gather_path_equal"], r
        new, old = r["collectives"], r["gather_path_collectives"]
        assert new.pop("all-to-all") == {"count": 2 * n * len(seqs), "bytes": 2 * n * shard}
        assert "all-to-all" not in old
        gathered = old.pop("all-gather")
        assert new.pop("all-gather") == {"count": gathered["count"] - 2 * n * len(seqs),
                                         "bytes": gathered["bytes"] - 2 * n * 2 * shard}
        assert new == old


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


PRODUCTION_CHILD = r"""
import json
from repro_torch.launch.dryrun import run_pair
print(json.dumps({f"{a}/{sh}": run_pair(a, sh, layers_override=1, device="cpu")
                  for a, sh in (("qwen2-7b", "decode_32k"),
                                ("command-r-plus-104b", "long_500k"))}))
"""


@pytest.fixture(scope="module")
def production_runs():
    """One pattern period, full width, on the fake 16x16 group (CPU)."""
    proc = subprocess.run([sys.executable, "-c", PRODUCTION_CHILD], cwd=ROOT,
                          env=_child_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_qwen2_decode_dry_run_moves_the_cache_by_all_to_all_on_the_production_mesh(
        production_runs):
    """Qwen2-7B decode_32k: KV = 4 and a group's 7 query heads do not
    divide 'model' = 16, so attention splits the head dim.  Each of K and V
    moves its local shard (8 x 32,768 x 32 bf16) by one all-to-all; what
    is still gathered is the new token's (six small gathers, where the
    whole cache was 537,018,368 B); the all-reduces, the arguments and the
    FLOPs are unchanged."""
    res = production_runs["qwen2-7b/decode_32k"]
    c = res["collectives"]
    assert res["status"] == "ok" and res["mesh"] == "16x16"
    assert c["all-gather"]["bytes"] <= 200_000, c
    assert c["all-to-all"] == {"count": 2, "bytes": 2 * 16_777_216}, c
    assert c["all-reduce"] == {"count": 68, "bytes": 29_532_192}, c
    assert res["memory"]["argument_bytes"] == 198_956_644
    assert res["flops_per_device"] == 1_012_924_416


def test_batch_of_one_looks_up_its_slice_of_a_2d_sharded_embedding(production_runs):
    """Command-R+ long_500k: the tied embedding is sharded (vocab on
    'model', embed on 'data') and the batch of 1 does not split, so each
    rank looks up its slice of the embed dim as the reference does, where
    gathering the table's shard over 'data' moved 393,216,000 B."""
    res = production_runs["command-r-plus-104b/long_500k"]
    c = res["collectives"]
    assert res["status"] == "ok"
    assert c["all-gather"]["bytes"] < 1_000_000, c
    assert c["all-to-all"] == {"count": 2, "bytes": 2 * 4_194_304}, c


if __name__ == "__main__":
    if sys.argv[1] == "--gloo":
        import torch.multiprocessing as mp
        mp.spawn(_gloo_worker, args=(4, sys.argv[2], sys.argv[3]), nprocs=4, join=True)
