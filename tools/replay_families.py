"""Device time of one bucket's replay, split by operation family, on the card.

    python3 tools/replay_families.py --workload convnext_t.closed64 --seed 5 \
        [--batch 8] [--replays 50] [--out families.json]

Sets the cell up as ``bench/run.py`` does (weights and images from the seed,
``synthesize`` under the configuration's mode and planner, Stage D's CUDA
graph at ``--batch``), checks that a replay equals the eager forward pass,
then replays the graph ``--replays`` times under ``torch.profiler`` and sums
the device operations by name and by family (:data:`FAMILIES`, first match
wins; "library convs" holds cuDNN's and cuBLAS's kernels with their layout
transforms; the rest is "other").  Prints one JSON object: the card, ms a replay of each family and of
each of the most costly kernel names, and launches a replay of each family.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (family, pattern on the device operation's name), first match wins.
FAMILIES = (
    ("depthwise", r"\bconv_depthwise2d_forward_kernel(_generic)?\b"),
    ("layernorm", r"\blayernorm_nchw_kernel\b"),
    ("gelu", r"[Gg]elu"),
    ("matmul_mapmajor", r"\bmatmul_mapmajor_(split|reduce)\b"),
    ("conv_mapmajor", r"\bconv_mapmajor(_int8)?_kernel\b"),
    ("residual add", r"\bvectorized_elementwise_kernel\b.*CUDAFunctor_add"),
    ("conv bias add", r"\belementwise_kernel\b.*CUDAFunctor_add"),
    ("bias cast", r"\bbfloat16_copy_kernel_cuda\b"),
    ("library convs", r"cutlass|xmma|nvjet|gemm|cudnn|convolve"),
    ("memcpy", r"^Memcpy|^Memset"),
)


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--replays", type=int, default=50)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import harness, inputs
    from repro_torch.cnn import WORKLOADS
    from repro_torch.core import PlannerConfig, synthesize
    from repro_torch.core.precision import ComputeMode

    if not torch.cuda.is_available():
        print("replay_families: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.load(args.workload, ROOT)
    cfg = cell.config
    hw, classes = cfg["input_hw"], cfg["num_classes"]
    shape = (3, hw, hw)
    layers = cell.reference().layers(scale=cfg.get("scale", 1.0), num_classes=classes)
    gen = inputs.generator(args.seed, "cuda")
    params = inputs.draw_weights(gen, layers, shape, "cuda", cell.kinds())
    x = inputs.draw_images(gen, args.batch, shape, "cuda")
    net = WORKLOADS[cfg["network"]](scale=cfg.get("scale", 1.0), num_classes=classes,
                                    input_hw=hw)
    t0 = time.perf_counter()
    program = synthesize(net, params, device=cfg["planner"]["device"],
                         planner_config=PlannerConfig(**{k: v for k, v in cfg["planner"].items()
                                                         if k != "device"}),
                         forced_mode=ComputeMode(cfg["mode"]))
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bp = program.for_batch(args.batch)
    stage_d_s = time.perf_counter() - t0
    replayed = bp(x)
    eager = program.infer(x)
    torch.cuda.synchronize()
    equal = bool(torch.equal(replayed, eager))
    for _ in range(5):
        bp(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.replays):
            bp(x)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        name = ev.name()
        dur = (ev.duration_ns() * 1e-9 if hasattr(ev, "duration_ns")
               else ev.duration_us() * 1e-6)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + dur, n + 1)
    fams = {}
    for name, (t, n) in by_name.items():
        f = family(name)
        ft, fn = fams.get(f, (0.0, 0))
        fams[f] = (ft + t, fn + n)
    r = args.replays
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    result = {"card": card.strip(), "workload": args.workload, "seed": args.seed,
              "batch": args.batch, "replays": r, "replay_equals_eager": equal,
              "synthesis_s": synth_s, "stage_d_s": stage_d_s,
              "layers": len(program.net.layers), "groups": len(program.plan.graph.groups),
              "family_ms_per_replay": {f: 1e3 * t / r for f, (t, _) in
                                       sorted(fams.items(), key=lambda kv: -kv[1][0])},
              "family_launches_per_replay": {f: n / r for f, (_, n) in fams.items()},
              "total_ms_per_replay": 1e3 * sum(t for t, _ in fams.values()) / r,
              "top_kernels": [[name, 1e3 * t / r, n / r] for name, (t, n) in top]}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
