"""A layer kind's share of its roofline, whatever implements it: the bound
of every layer of the kind (``bench/roofline.py::bound_seconds``, at each
replay's batch) over the device time of the operations that compute them,
found by name in the traced device window.

``bench.roofline.kernel_roofline_pct`` counts only the layers the plan
routes to the hand-written kernels; this counts every layer of the kind,
for kinds that one operation a layer computes wherever the plan puts them
(a depthwise conv on the library, a LayerNorm on its own kernel).
"""
from __future__ import annotations

import bisect
from typing import Dict, Optional

from bench.roofline import bound_seconds


def kind_roofline_pct(run, kind: str, pattern: str, ops_per_layer: int) -> Optional[float]:
    """Each operation matching ``pattern`` is credited with an equal share
    of its replay's bound (``ops_per_layer`` for each layer of ``kind``);
    the replay's batch is that of the ``serve.dispatch`` span the operation
    starts in, and an operation outside every such span is timed but not
    credited.  None where the network has no layer of the kind or no
    operation matched."""
    d = run.device
    names = [l["name"] for l in run.layers if l["kind"] == kind]
    if d is None or not names:
        return None
    ops = d.ops_of(pattern)
    seconds = sum(b - a for _, a, b in ops)
    if not ops or seconds <= 0:
        return None
    spans = sorted((s.t_start, s.t_end, s.attrs["batch"]) for s in run.spans
                   if s.name == "serve.dispatch")
    starts = [s[0] for s in spans]
    per_replay = ops_per_layer * len(names)
    bounds: Dict[int, float] = {}
    work = 0.0
    for _, a, _ in ops:
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or a > spans[i][1]:
            continue
        batch = spans[i][2]
        if batch not in bounds:
            bounds[batch] = bound_seconds(run.layers, run.input_shape, names, batch,
                                          kinds=run.kinds)
        work += bounds[batch] / per_replay
    return 100.0 * work / seconds
