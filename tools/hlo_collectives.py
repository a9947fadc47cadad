"""Collectives of a compiled XLA program per device per step, loops counted.

``python -m repro.launch.dryrun --hlo-out F`` writes the reference's
post-SPMD HLO text; its own ``collective_stats`` counts each op once as it
appears in the text, so an op inside a ``while`` body (the layer scan, the
attention's key-chunk scan) counts once however often the loop runs.  This
script walks the computations from ``ENTRY`` and multiplies each ``while``
body by its ``known_trip_count``: the per-device counts and result bytes of
each collective kind, as the port's dry run (``repro_torch.launch.dryrun``)
reports them for the ops each rank runs.  A loop without a known trip
count counts once and is listed under ``"unknown_trip_counts"``.

  python3 tools/hlo_collectives.py F [F ...]      # one JSON object per file
"""
from __future__ import annotations

import json
import re
import sys
from collections import defaultdict

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
               "s64": 8, "u64": 8, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "c64": 8, "c128": 16}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# The reference's collective_stats patterns: result signature, then the op.
OP = re.compile(r"=\s*(.+?)\s+(" + "|".join(KINDS) + r")(?:-start)?\(")
SHAPE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred)\[([\d,]*)\]")
HEADER = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(.*\{\s*$")
CALLEE = re.compile(r"\b(body|condition|calls|to_apply|true_computation|"
                    r"false_computation)=%([\w.\-]+)")
BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")
TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')


def _result_bytes(sig: str) -> int:
    total = 0
    for dt, dims in SHAPE.findall(sig):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def parse(text: str):
    """({computation: ([(kind, bytes)], [(callee, times)])}, entry name,
    [while ops without a known trip count])."""
    comps, entry, unknown = {}, None, []
    name = None
    for line in text.splitlines():
        head = HEADER.match(line)
        if head:
            name = head.group(1)
            comps[name] = ([], [])
            if line.startswith("ENTRY"):
                entry = name
            continue
        if name is None or not line.strip() or line.strip() == "}":
            continue
        ops, calls = comps[name]
        m = OP.search(line)
        if m:
            ops.append((m.group(2), _result_bytes(m.group(1))))
        trip = TRIP.search(line)
        is_while = re.search(r"\swhile\(", line) is not None
        if is_while and not trip:
            unknown.append(line.split("=")[0].strip())
        for role, callee in CALLEE.findall(line):
            if role == "to_apply":                  # a reduction's scalar body
                continue
            times = int(trip.group(1)) if (role == "body" and trip) else 1
            calls.append((callee, times))
        for group in BRANCHES.findall(line):
            calls.extend((c.strip().lstrip("%"), 1) for c in group.split(","))
    return comps, entry, unknown


def collectives(text: str) -> dict:
    """{kind: {"count", "bytes"}} per device per step, loops counted; plus
    ``unknown_trip_counts`` where a loop had none."""
    comps, entry, unknown = parse(text)
    memo = {}

    def total(name):
        if name in memo:
            return memo[name]
        acc = defaultdict(lambda: [0, 0])
        ops, calls = comps.get(name, ([], []))
        for kind, nbytes in ops:
            acc[kind][0] += 1
            acc[kind][1] += nbytes
        for callee, times in calls:
            for kind, (c, b) in total(callee).items():
                acc[kind][0] += times * c
                acc[kind][1] += times * b
        memo[name] = dict(acc)
        return memo[name]

    out = {k: {"count": c, "bytes": b} for k, (c, b) in sorted(total(entry).items())}
    if unknown:
        out["unknown_trip_counts"] = unknown
    return out


def main(argv=None) -> int:
    for path in (argv if argv is not None else sys.argv[1:]):
        with open(path) as f:
            res = collectives(f.read())
        res["total_bytes"] = sum(v["bytes"] for k, v in res.items() if k in KINDS)
        print(json.dumps({"hlo": path, "collectives": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
