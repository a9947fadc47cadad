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
from typing import Dict, Iterable, Optional, Sequence, Tuple

from bench.reference.ops import Kinds, param_shapes, shapes

BF16_FLOPS = 989e12          # dense bf16 tensor-core peak, FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3
BF16_BYTES = 2


def layer_work(layers: Sequence[dict], input_shape: Tuple[int, ...],
               kinds: Optional[Kinds] = None) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, activation elements) of one image through each layer whose
    kind counts its work (conv and dense among the built-in kinds); the
    weights and bias are per call, so :func:`bound_seconds` counts them
    apart."""
    kinds = Kinds() if kinds is None else kinds
    sh = shapes(layers, input_shape, kinds)
    work = {}
    for l in layers:
        w = kinds[l["kind"]].work(l, [sh[i] for i in l["inputs"]], sh[l["name"]])
        if w is not None:
            work[l["name"]] = (float(w[0]), float(w[1]))
    return work


def weight_elems(layers: Sequence[dict], input_shape: Tuple[int, ...],
                 kinds: Optional[Kinds] = None) -> Dict[str, Tuple[int, int]]:
    """(weight elements, bias elements) of each layer that has parameters."""
    return {name: (math.prod(shape), n_bias)
            for name, shape, _, n_bias in param_shapes(layers, input_shape, kinds)}


def flops_per_image(layers: Sequence[dict], input_shape: Tuple[int, ...],
                    kinds: Optional[Kinds] = None) -> float:
    """The FLOPs of every layer whose kind counts them (2 x the multiply-adds
    of every conv and dense layer) for one image."""
    return sum(f for f, _ in layer_work(layers, input_shape, kinds).values())


def bound_seconds(layers: Sequence[dict], input_shape: Tuple[int, ...],
                  names: Iterable[str], batch: int,
                  operand_bytes: int = BF16_BYTES, kinds: Optional[Kinds] = None) -> float:
    """Sum over ``names`` of each layer's bound at ``batch`` images."""
    work = layer_work(layers, input_shape, kinds)
    wts = weight_elems(layers, input_shape, kinds)
    total = 0.0
    for n in names:
        flops, act = work[n]
        w, b = wts.get(n, (0, 0))
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
    kind_of = {l["name"]: l["kind"] for l in run.layers}
    names = [n for n, impl in run.routing.items() if impl == KERNEL_IMPL and kind_of[n] == kind]
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
            bounds[batch] = bound_seconds(run.layers, run.input_shape, names, batch,
                                          kinds=run.kinds)
        work += bounds[batch] / per_replay
    return 100.0 * work / seconds
