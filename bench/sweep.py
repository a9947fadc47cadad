"""Find a configuration's knee: the highest offered rate the tier sustains.

    python3 bench/sweep.py --workload alexnet.closed64 --seed 7 --seconds 20 \
        --rates 1200,1600,2000,2400 [--out sweep.json]

One process, one set-up of the cell's configuration, then one open-loop
window per rate (the traffic generator's Poisson-like arrivals) and, for
comparison, one closed loop of 64 clients.  A rate is sustained where
nothing was shed and the backlog at the window's close (requests due but
not answered) is at most two full buckets.  The knee is the highest
sustained rate; a cell at 0.8 of it takes that number into its traffic file.
"""
import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    here = str(ROOT / "bench")
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path if p != here]
    from bench.generator import SHED
    from bench.harness import Cell, Session

    cell = Cell.load(args.workload, ROOT)
    session = Session(cell, args.seed)
    max_batch = session.tier.config.max_batch
    rows = []
    plans = [("open", float(r)) for r in args.rates.split(",")] + [("closed", 64)]
    for kind, x in plans:
        traffic = ({"kind": "open", "rate_per_s": x} if kind == "open"
                   else {"kind": "closed", "clients": int(x)})
        run = session.window(traffic, args.seconds, args.seed)
        lat = sorted(run.latencies())
        n = len(lat)
        q = lambda p: 1e3 * lat[math.ceil(p * n) - 1] if n else None
        log = run.log
        shed = run.count(SHED)
        backlog = sum(1 for s, t in zip(log.state, log.t_done)
                      if s != SHED and not t <= run.t_end)
        late = sorted(run.lateness)
        row = {"traffic": traffic, "offered_per_s": n / args.seconds,
               "answered_per_s": run.completed_in_window / args.seconds,
               "shed": shed, "backlog_at_close": backlog,
               "p50_ms": q(0.50), "p95_ms": q(0.95), "p99_ms": q(0.99),
               "late_p99_ms": 1e3 * late[int(0.99 * (len(late) - 1))] if late else None,
               "imgs_per_batch": (run.stats["completed"] / run.stats["batches"]
                                  if run.stats["batches"] else None),
               "sustained": shed == 0 and backlog <= 2 * max_batch}
        rows.append(row)
        print(json.dumps(row), flush=True)
    sustained = [r["traffic"]["rate_per_s"] for r in rows
                 if r["traffic"]["kind"] == "open" and r["sustained"]]
    knee = max(sustained) if sustained else None
    print(f"knee {knee} req/s; 0.8 of it {0.8 * knee if knee else None}", flush=True)
    session.close()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "knee": knee}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
