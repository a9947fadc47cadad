"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the generator's lateness, then, as its last line on standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``),
the device, with ``--trace 1`` the breakdown, and last the numbers the
check compared, each beside its limit (also the last lines on standard
error).  Exits non-zero without a result where there is no CUDA card, or
where a module of JAX or of the JAX package is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Caches of the program and of the libraries stay inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    here = str(ROOT / "bench")
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path if p != here]

    import torch
    from bench.harness import run_cell

    chips = next(w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
                 ["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             root=ROOT, t_process=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in notes:
        print(line)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
