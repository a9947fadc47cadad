"""Dry-run sweep: every (arch x shape x mesh), optionally with the
reduced-depth variants.

The port of ``repro.launch.sweep``.  Each pair runs in a fresh process
(``python -m repro_torch.launch.dryrun``; the fake process group's world
size is fixed at its first use, and a process bounds the pair's memory).
Results land in ``results/dryrun_torch/<arch>.<shape>.<mesh>[.gN].json``,
apart from the reference's ``results/dryrun``; a pair whose file says
``ok`` or ``skipped`` is not run again, so the sweep is resumable.  As
many pairs run at once as the process may use CPUs; a slow arch gets a
longer limit in a run of its own (``--arch qwen2-7b --timeout 2700``).

  PYTHONPATH=src python -m repro_torch.launch.sweep [--only-mesh pod|multipod]
      [--arch A] [--shape S] [--variants | --layers-override N]
      [--timeout 1500] [--device cuda|cpu] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = ["granite-moe-1b-a400m", "xlstm-350m", "whisper-small", "hymba-1.5b",
         "qwen2-7b", "gemma2-9b", "qwen3-32b", "command-r-plus-104b",
         "llama-3.2-vision-90b", "qwen3-moe-235b-a22b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

OUT_DIR = "results/dryrun_torch"


def run_one(arch, shape, multipod, layers_override, timeout, device="cuda",
            out_dir=OUT_DIR):
    """Run one pair in a child process; its status and seconds."""
    tag = f"{arch}.{shape}.{'2x16x16' if multipod else '16x16'}"
    if layers_override:
        tag += f".g{layers_override}"
    out = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out):
        with open(out) as f:
            prev = json.load(f)
        if prev.get("status") in ("ok", "skipped"):
            return prev["status"], 0.0
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--json", out, "--device", device]
    if multipod:
        cmd.append("--multipod")
    if layers_override:
        cmd += ["--layers-override", str(layers_override)]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        status = "ok" if proc.returncode == 0 else "error"
        if status == "error" and not os.path.exists(out):
            with open(out, "w") as f:
                json.dump({"arch": arch, "shape": shape, "status": "error",
                           "error": proc.stdout[-2000:] + proc.stderr[-2000:]},
                          f, indent=1)
        if os.path.exists(out):
            with open(out) as f:
                status = json.load(f).get("status", status)
    except subprocess.TimeoutExpired:
        status = "timeout"
        with open(out, "w") as f:
            json.dump({"arch": arch, "shape": shape, "status": "timeout",
                       "timeout_seconds": timeout}, f)
    return status, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="", help="one arch, or several, comma-separated")
    ap.add_argument("--shape", default="", help="one shape, or several, comma-separated")
    ap.add_argument("--only-mesh", default="", choices=["", "pod", "multipod"])
    ap.add_argument("--variants", action="store_true",
                    help="also run G=1/G=2 depth variants on the pod mesh")
    ap.add_argument("--layers-override", type=int, default=0,
                    help="run only this depth (pattern periods)")
    ap.add_argument("--timeout", type=int, default=1500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    archs = args.arch.split(",") if args.arch else ARCHS
    shapes = args.shape.split(",") if args.shape else SHAPES
    meshes = {"pod": [False], "multipod": [True]}.get(args.only_mesh,
                                                      [False, True])
    jobs = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.layers_override:
                    jobs.append((arch, shape, mp, args.layers_override))
                    continue
                jobs.append((arch, shape, mp, 0))
                if args.variants and not mp:
                    jobs.append((arch, shape, mp, 1))
                    jobs.append((arch, shape, mp, 2))
    print(f"{len(jobs)} jobs", flush=True)

    def one(job):
        arch, shape, mp, g = job
        return job, run_one(arch, shape, mp, g, args.timeout, args.device,
                            args.out_dir)

    with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:
        for i, ((arch, shape, mp, g), (status, dt)) in enumerate(
                pool.map(one, jobs)):
            mesh = "2x16x16" if mp else "16x16"
            print(f"[{i + 1}/{len(jobs)}] {arch:24s} {shape:12s} {mesh:8s} "
                  f"g={g or 'full'}: {status} ({dt:.0f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
