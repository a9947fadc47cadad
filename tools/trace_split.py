"""Split the buckets of a traced benchmark run into host phases and device spans.

    python3 tools/trace_split.py --workload alexnet.closed64 --seeds 7,8,9 --out split.json

For each seed, one traced run of the cell on the card as ``bench/run.py --trace 1``
makes it (the window with the tier's tracer on, then the profiled phase), without the
check of the answers.  From the tier's spans over the window it prints:

* each phase of ``serve.dispatch`` in mean ms, their cover of it, and its self time
  (on a pipelined replica a dispatch also holds the next bucket's launch), and the
  share of buckets launched while another was in flight (``overlapped``);
* the device spans (``dev.copy_in``, ``dev.replay``), the device's gap between buckets,
  and the device's idle time by the host phase open during it;
* the nesting check: each ``dev.copy_in`` starts no earlier than 20 us before its
  ``serve.copy_in``, each ``dev.replay`` ends no later than 20 us after its
  ``serve.copy_out``;
* the clock anchors: their bracket (``error_us``) and their drift from the previous
  anchor and from the first;
* the profiler's clock against the events': for each graph launch of the profiled
  phase, its first device operation as the profiler places it on the host's clock,
  less the start of that bucket's ``dev.replay``; and the launch's host call less
  the start of its ``serve.replay`` span.

Reads and writes nothing outside the checkout but ``--out``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("serve.lookup", "serve.stack", "serve.copy_in", "serve.replay",
          "serve.copy_out", "serve.scatter")
SLACK_S = 20e-6


def _mean_ms(xs):
    return 1e3 * statistics.fmean(xs) if xs else None


def _median(xs):
    return statistics.median(xs) if xs else None


def split(spans, t0, t1):
    """The per-bucket split of the window ``[t0, t1)`` (spans that start in it)."""
    inside = [s for s in spans if t0 <= s.t_start < t1]
    by_id = {s.span_id: s for s in spans}
    dispatch = [s for s in inside if s.name == "serve.dispatch"]
    kids = {}
    for s in spans:
        p = by_id.get(s.parent_id)
        if p is not None and p.name == "serve.dispatch":
            kids.setdefault(p.span_id, {})[s.name] = s
    flags = [d.attrs["overlapped"] for d in dispatch if "overlapped" in d.attrs]
    out = {"buckets": len(dispatch),
           "dispatch_ms": _mean_ms([d.duration_s for d in dispatch]),
           "overlap_share": sum(flags) / len(flags) if flags else None}
    for name in PHASES + ("dev.copy_in", "dev.replay"):
        out[name + "_ms"] = _mean_ms([kids[d.span_id][name].duration_s for d in dispatch
                                      if name in kids.get(d.span_id, {})])
    covered = [sum(kids[d.span_id][n].duration_s for n in PHASES if n in kids[d.span_id])
               for d in dispatch if d.span_id in kids]
    out["phases_cover"] = (sum(covered) / sum(d.duration_s for d in dispatch)
                           if dispatch else None)
    out["dispatch_self_ms"] = (out["dispatch_ms"] - _mean_ms(covered)) if covered else None
    late_in = late_out = 0
    for d in dispatch:
        k = kids.get(d.span_id, {})
        if "dev.copy_in" in k:
            late_in += k["dev.copy_in"].t_start < k["serve.copy_in"].t_start - SLACK_S
            late_out += k["dev.replay"].t_end > k["serve.copy_out"].t_end + SLACK_S
    out["nesting_breaks"] = {"copy_in_early": late_in, "replay_late": late_out}
    by_thread = {}
    for d in dispatch:
        by_thread.setdefault(d.thread, []).append(d)
    gaps, dev_gaps = [], []
    for ds in by_thread.values():
        ds.sort(key=lambda s: s.t_start)
        for a, b in zip(ds, ds[1:]):
            gaps.append(b.t_start - a.t_end)
            ka, kb = kids.get(a.span_id, {}), kids.get(b.span_id, {})
            if "dev.replay" in ka and "dev.copy_in" in kb:
                dev_gaps.append(kb["dev.copy_in"].t_start - ka["dev.replay"].t_end)
    out["loop_gap_ms"], out["device_gap_ms"] = _mean_ms(gaps), _mean_ms(dev_gaps)
    out["device_idle_by_phase_s"] = idle_by_phase(dispatch, kids, t0, t1)
    req = sorted(s.duration_s for s in inside if s.name == "serve.request")
    out["request_p95_ms"] = 1e3 * req[-(-95 * len(req) // 100) - 1] if req else None
    return out


def _overlaps(intervals, a, b):
    """(seconds, name) of each of the sorted, disjoint ``intervals`` inside
    ``[a, b]``."""
    i = bisect.bisect_left(intervals, (b,)) - 1
    out = []
    while i >= 0 and intervals[i][1] > a:
        s0, s1, name = intervals[i]
        out.append((min(b, s1) - max(a, s0), name))
        i -= 1
    return out


def idle_by_phase(dispatch, kids, t0, t1):
    """Seconds of ``[t0, t1]`` in which no bucket's device span ran, by the host
    phase open then: a phase, a dispatch outside its phases, or no dispatch
    (one replica, so the phases are disjoint; a pipelined replica's dispatches
    overlap, so their union is taken)."""
    busy = sorted((k["dev.copy_in"].t_start, k["dev.replay"].t_end)
                  for k in (kids.get(d.span_id, {}) for d in dispatch) if "dev.copy_in" in k)
    if not busy:
        return None
    idle, t = [], t0
    for a, b in busy:
        if a > t:
            idle.append((t, min(a, t1)))
        t = max(t, b)
    if t < t1:
        idle.append((t, t1))
    phases = sorted((s.t_start, s.t_end, s.name) for d in dispatch
                    for s in kids.get(d.span_id, {}).values() if s.name in PHASES)
    whole = []
    for a, b in sorted((d.t_start, d.t_end) for d in dispatch):
        if whole and a <= whole[-1][1]:
            whole[-1] = (whole[-1][0], max(whole[-1][1], b), "serve.dispatch")
        else:
            whole.append((a, b, "serve.dispatch"))
    total = dict.fromkeys(PHASES + ("serve.dispatch (self)", "between dispatches"), 0.0)
    for a, b in idle:
        in_phases = 0.0
        for sec, name in _overlaps(phases, a, b):
            total[name] += sec
            in_phases += sec
        in_dispatch = sum(sec for sec, _ in _overlaps(whole, a, b))
        total["serve.dispatch (self)"] += in_dispatch - in_phases
        total["between dispatches"] += (b - a) - in_dispatch
    return dict(sorted(total.items(), key=lambda kv: -kv[1]))


def anchors(spans):
    a = [s for s in spans if s.name == "serve.clock_anchor"]
    err = [s.attrs["error_us"] for s in a]
    drift = [s.attrs["drift_us"] for s in a if "drift_us" in s.attrs]
    last = max((s for s in a if "since_first_s" in s.attrs),
               key=lambda s: s.attrs["since_first_s"], default=None)
    return {"count": len(a), "error_us_median": _median(err),
            "error_us_max": max(err, default=None),
            "drift_us_median_abs": _median([abs(d) for d in drift]),
            "drift_us_max_abs": max((abs(d) for d in drift), default=None),
            "drift_first_us_last": last.attrs["drift_first_us"] if last else None,
            "since_first_s_last": last.attrs["since_first_s"] if last else None}


def profiler_offsets(events, marks, spans):
    """For each graph launch of the profiled phase: its first device operation as
    the profiler places it on the host's clock less its bucket's ``dev.replay``
    start, and its host call less its ``serve.replay`` span's start (seconds)."""
    from bench import profiling
    stamp, launches, first = {}, {}, {}
    device = []
    for ev in events:
        name = ev.name()
        if name == profiling.START:
            stamp[name] = profiling._start_s(ev)
        elif ev.device_type().name == "CUDA":
            device.append((profiling._start_s(ev), ev.correlation_id()))
        elif name == "cudaGraphLaunch":
            launches[ev.correlation_id()] = profiling._start_s(ev)
    if profiling.START not in stamp:
        return None
    shift = marks[profiling.START] - stamp[profiling.START]
    for a, corr in device:
        if corr in launches:
            first[corr] = min(first.get(corr, a), a)
    replays = sorted((s.t_start, s.t_end, s.attrs.get("bucket")) for s in spans
                     if s.name == "serve.replay")
    dev = {s.attrs.get("bucket"): s for s in spans if s.name == "dev.replay"}
    starts = [r[0] for r in replays]
    dev_off, host_off, outside = [], [], 0
    for corr, t_launch in launches.items():
        if corr not in first:
            continue
        host = t_launch + shift
        i = bisect.bisect_right(starts, host) - 1
        if i < 0 or host > replays[i][1]:
            outside += 1
            continue
        host_off.append(host - replays[i][0])
        if replays[i][2] in dev:
            dev_off.append(first[corr] + shift - dev[replays[i][2]].t_start)
    return {"launches": len(first), "matched": len(dev_off), "launch_outside_replay": outside,
            "first_op_minus_dev_replay_ms_median": 1e3 * _median(dev_off) if dev_off else None,
            "first_op_minus_dev_replay_ms_range": [1e3 * min(dev_off), 1e3 * max(dev_off)]
            if dev_off else None,
            "launch_minus_serve_replay_ms_median": 1e3 * _median(host_off) if host_off else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness, profiling

    kept = {}

    class KeepingProfiler(profiling.Profiler):
        def stop(self, t0, t1):
            window = super().stop(t0, t1)
            kept["events"] = list(self._prof.profiler.kineto_results.events())
            kept["marks"] = dict(self._marks)
            return window

    harness.Profiler = KeepingProfiler
    results = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell.load(args.workload, ROOT)
        session = harness.Session(cell, seed, trace=True)
        run = session.window(cell.traffic, args.seconds, seed, profile=True)
        session.close()
        r = {"seed": seed, "img_per_s_traced": run.completed_in_window / run.seconds,
             "window": split(run.spans, run.t0, run.t_end), "anchors": anchors(run.spans),
             "profiler": profiler_offsets(kept.get("events", []), kept.get("marks", {}),
                                          run.spans),
             "profiler_notes": run.device.notes if run.device is not None else None}
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        Path(args.out).write_text(json.dumps({"workload": args.workload, "runs": results},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
