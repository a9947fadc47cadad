"""The yardstick: operations, bytes and the least time a layer can take.

Counted from the benchmark's own copy of the network (``bench/reference``),
never from the program.  A layer's bound is the larger of its operations at
the H100's dense bf16 tensor-core peak and its bytes at the HBM3 bandwidth,
counting each input byte read once and each output byte written once: the
input activations, the weights and the output in the served operand type,
and the f32 bias.  Published peaks of the H100 SXM (NVIDIA's data sheet,
dense, at its 700 W limit): they are stated beside the card's power limit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

from bench.reference.ops import shapes

BF16_FLOPS = 989e12          # dense bf16 tensor-core peak, FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3
BF16_BYTES = 2


def layer_work(layers: Sequence[dict], input_shape: Tuple[int, ...]
               ) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of one image through each conv and dense layer; the
    bytes of the weights and bias are per call, so they are counted apart by
    :func:`bound_seconds`."""
    sh = shapes(layers, input_shape)
    work = {}
    for l in layers:
        x, y = sh[l["inputs"][0]], sh[l["name"]]
        if l["kind"] == "conv":
            macs = math.prod(y) * x[0] * l["k"] ** 2
            work[l["name"]] = (2.0 * macs, float(math.prod(x) + math.prod(y)))
        elif l["kind"] == "dense":
            macs = math.prod(x) * y[0]
            work[l["name"]] = (2.0 * macs, float(math.prod(x) + y[0]))
    return work


def weight_elems(layers: Sequence[dict], input_shape: Tuple[int, ...]
                 ) -> Dict[str, Tuple[int, int]]:
    """(weight elements, bias elements) of each conv and dense layer."""
    sh = shapes(layers, input_shape)
    out = {}
    for l in layers:
        cin = sh[l["inputs"][0]]
        if l["kind"] == "conv":
            out[l["name"]] = (l["out"] * cin[0] * l["k"] ** 2, l["out"])
        elif l["kind"] == "dense":
            out[l["name"]] = (math.prod(cin) * l["out"], l["out"])
    return out


def flops_per_image(layers: Sequence[dict], input_shape: Tuple[int, ...]) -> float:
    """2 x the multiply-adds of every conv and dense layer for one image."""
    return sum(f for f, _ in layer_work(layers, input_shape).values())


def bound_seconds(layers: Sequence[dict], input_shape: Tuple[int, ...],
                  names: Iterable[str], batch: int,
                  operand_bytes: int = BF16_BYTES) -> float:
    """Sum over ``names`` of each layer's bound at ``batch`` images."""
    work = layer_work(layers, input_shape)
    wts = weight_elems(layers, input_shape)
    total = 0.0
    for n in names:
        flops, act = work[n]
        w, b = wts[n]
        nbytes = operand_bytes * (batch * act + w) + 4 * b
        total += max(batch * flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    return total


#: The plan's name for the hand-written kernels' implementation.
KERNEL_IMPL = "cuda_mapmajor"


def kernel_roofline_pct(run, kind: str, pattern: str, launches_per_layer: int):
    """A kernel's share of its roofline in the traced device window: the
    bound of the layers the plan routes to it, at each replay's batch, over
    the device time of the ``__global__`` functions matching ``pattern``.

    Each launch is credited with an equal share of its replay's bound; the
    replay's batch is that of the ``serve.dispatch`` span the launch falls
    in, and a launch outside every such span is timed but not credited.
    None where no layer is routed to the kernel or no launch was traced.
    """
    import bisect

    d = run.device
    kinds = {l["name"]: l["kind"] for l in run.layers}
    names = [n for n, impl in run.routing.items() if impl == KERNEL_IMPL and kinds[n] == kind]
    if d is None or not names:
        return None
    ops = d.ops_of(pattern)
    seconds = sum(b - a for _, a, b in ops)
    if not ops or seconds <= 0:
        return None
    spans = sorted((s.t_start, s.t_end, s.attrs["batch"]) for s in run.spans
                   if s.name == "serve.dispatch")
    starts = [s[0] for s in spans]
    per_replay = launches_per_layer * len(names)
    bounds: Dict[int, float] = {}
    work = 0.0
    for _, a, _ in ops:
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or a > spans[i][1]:
            continue
        batch = spans[i][2]
        if batch not in bounds:
            bounds[batch] = bound_seconds(run.layers, run.input_shape, names, batch)
        work += bounds[batch] / per_replay
    return 100.0 * work / seconds
