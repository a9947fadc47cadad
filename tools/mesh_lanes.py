"""The decode cache's move onto attention's head-dim split, on real cards.

Spawns one process per card (NCCL, a file rendezvous in a temporary
directory) and, on each (data, model) mesh the cards allow:

* checks ``sharding.split_lanes`` on small fused shards, f32 and bf16: every
  rank's result is its slice of the full reshape, bit for bit (groups that
  straddle ranks, more groups than ranks, and a head dim 'model' does not
  divide, which takes the gather);
* times it at a full-width cache shard, Qwen2-7B's fused K of 4 KV heads x
  128 lanes for 8 sequences x 32,768 slots a card, against the gather it
  replaces (``sharding.reshape``, which gathers the fused dim over 'model'
  and keeps it whole): CUDA events around 20 calls after 3, the median of
  five such runs, and each rank's result bytes.

Exits 1 if a check fails.

  python3 tools/mesh_lanes.py [--out chiprun_out/mesh_lanes.json]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
#: (KV heads, head dim) of the exactness checks
SHAPES = [(3, 16), (5, 8), (2, 6)]
#: (batch, slots, KV heads, head dim) of the timed shard
TIMED = (8, 32768, 4, 128)


def _meshes(world):
    return [(world // m, m) for m in (2, 4, 8) if world % m == 0 and m <= world]


def worker(rank, world, tmp, out_path):
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import sharding as S
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    res = {"checks": [], "timed": []}
    for data, model in _meshes(world):
        mesh = make_host_mesh(data=data, model=model, device_type="cuda")
        coord = mesh.get_coordinate()
        for kv, hd in SHAPES:
            b, cap = 2 * data, 5
            g = torch.Generator(device="cuda").manual_seed(kv * hd)
            for dt in (torch.float32, torch.bfloat16):
                whole = torch.randn((b, cap, kv * hd), generator=g, device="cuda").to(dt)
                spec = S.cache_spec(whole.shape, mesh)
                if spec[2] != "model":
                    continue
                y = S.split_lanes(S.distribute(whole, mesh, spec), (b, cap, kv, hd))
                want = whole.reshape(b, cap, kv, hd).narrow(0, coord[0] * 2, 2)
                if hd % model == 0:
                    want = want.narrow(3, coord[1] * (hd // model), hd // model)
                res["checks"].append({"mesh": f"{data}x{model}", "kv": kv, "hd": hd,
                                      "dtype": str(dt),
                                      "equal": bool(torch.equal(y.to_local(), want))})
        b, cap, kv, hd = TIMED
        whole_shape = (b * data, cap, kv * hd)
        local = torch.randn((b, cap, kv * hd // model), device="cuda").to(torch.bfloat16)
        x = S.DTensor.from_local(local, mesh, S.placements(S.cache_spec(whole_shape, mesh), mesh),
                                 run_check=False, shape=torch.Size(whole_shape),
                                 stride=S._contiguous_stride(whole_shape))
        shape4 = (b * data, cap, kv, hd)
        for name, fn in (("all-to-all", S.split_lanes), ("gather", S.reshape)):
            runs = []
            for _ in range(5):
                for _ in range(3):
                    fn(x, shape4)
                torch.cuda.synchronize()
                dist.barrier()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    y = fn(x, shape4)
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end) / 20)
            res["timed"].append({"mesh": f"{data}x{model}", "path": name,
                                 "ms": statistics.median(runs), "runs_ms": runs,
                                 "result_bytes_per_rank": y.to_local().numel() * 2,
                                 "placements": [str(p) for p in y.placements]})
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(gathered, f, indent=1)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    if world < 2:
        print("needs two or more CUDA cards", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or os.path.join(tmp, "out.json")
        mp.spawn(worker, args=(world, tmp, out), nprocs=world, join=True)
        with open(out) as f:
            ranks = json.load(f)
    ok = all(c["equal"] for r in ranks for c in r["checks"]) and ranks[0]["checks"]
    for t in ranks[0]["timed"]:
        ms = [r["timed"][ranks[0]["timed"].index(t)]["ms"] for r in ranks]
        print(f"{t['mesh']} {t['path']:10s} median over ranks of medians {statistics.median(ms):.4f} ms, "
              f"ranks {min(ms):.4f}-{max(ms):.4f}; result {t['result_bytes_per_rank']} B a rank")
    print(f"checks: {sum(len(r['checks']) for r in ranks)} on {world} ranks, "
          f"{'all equal' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
