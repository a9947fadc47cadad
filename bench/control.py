"""Readings for the check's limit: the program as configured and the control.

    python3 bench/control.py --workload alexnet.closed64 --seeds 1,2,3 \
        --seconds 2 [--modes relaxed,imprecise_int8] [--out readings.json]

For every seed, one run of the cell per compute mode, in this one process:
the configuration's own mode gives the lower readings of the check's
numbers (``harness.checks_of``), the program's own IMPRECISE_INT8 path (16
calibration images drawn from the seed), the nearest precision below the
configured bf16, gives the control's.  Each run is a whole run of the cell at its own
load, with a short window; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--modes", default="relaxed,imprecise_int8")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    here = str(ROOT / "bench")
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path if p != here]
    import torch
    from bench import harness

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            cell = harness.Cell.load(args.workload, ROOT)
            session = harness.Session(cell, seed, mode=mode)
            run = session.window(cell.traffic, args.seconds, seed)
            images = session.images
            session.close()
            c = harness.checks_of(run, cell,
                                  harness.reference_logprobs(cell, seed, images, "cuda", "float32"),
                                  harness.reference_logprobs(cell, seed, images, "cuda"))
            rows.append({"seed": seed, "mode": mode,
                         "img_per_s": run.completed_in_window / run.seconds,
                         **{k: v["value"] for k, v in c.items()}})
            del run
            torch.cuda.empty_cache()
            print(json.dumps(rows[-1]), flush=True)
    for mode in args.modes.split(","):
        mine = [r for r in rows if r["mode"] == mode]
        for k in ("error_power", "widest_answer_power"):
            v = [r[k] for r in mine]
            print(f"{mode} {k}: n {len(v)} min {min(v)} max {max(v)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
