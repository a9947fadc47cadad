"""CUDA graph capture and the timed dispatch unit.

The port's counterpart of a jitted executable is a captured CUDA graph:
Stage D (:meth:`~repro_torch.core.synthesizer.SynthesizedProgram.for_batch`)
captures the whole forward pass in one, and the timed groups (the planner's
``autotune_plan``, ``obs.measure_drift``) capture one fused group each and
time its replays.  Eager timing on the card would compare the host's
per-op dispatch, which costs as much as a group's device time; a replay
launches the group's kernels with none of it.  Off the card both run
eagerly.  :func:`min_of_reps` is the one timing rule, calibration's too.
"""
from __future__ import annotations

import threading
from typing import Callable, Sequence, Tuple

import torch

#: One CUDA graph capture at a time in the process (a capture must not
#: overlap another one); the program cache builds distinct buckets from
#: several threads at once.
CAPTURE_LOCK = threading.Lock()


def capture_graph(fn: Callable[..., torch.Tensor],
                  static_ins: Sequence[torch.Tensor]
                  ) -> Tuple["torch.cuda.CUDAGraph", torch.Tensor, int]:
    """Capture ``fn(*static_ins)`` in one CUDA graph.

    One warm-up call on a side stream first (kernel builds and loads,
    cuDNN's algorithm choice), then the capture.  Returns the graph, its
    static output (in the graph's private memory pool) and the device memory
    the capture reserved for that pool.  A capture that fails (a host
    synchronization or a host-to-device copy inside ``fn``) raises
    ``RuntimeError``; nothing falls back to eager calls."""
    dev = static_ins[0].device
    with CAPTURE_LOCK:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static_ins)
            torch.cuda.synchronize(dev)
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            # thread_local: other replicas' threads may synchronize or
            # replay while this one captures.
            try:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static_out = fn(*static_ins)
                finally:
                    graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(
                    "CUDA graph capture failed; the captured function must "
                    f"not synchronize with or copy from the host: {e}") from e
            torch.cuda.synchronize(dev)
            graph_bytes = torch.cuda.memory_reserved(dev) - reserved
    return graph, static_out, graph_bytes


def sync_device(device: torch.device) -> None:
    """Wait for the card's work on ``device``; nothing to wait for off it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def min_of_reps(call: Callable[[], object], reps: int,
                clock: Callable[[], float], device: torch.device) -> float:
    """Min-of-``reps`` wall time of ``call()`` read on ``clock``, with the
    device synchronize inside the timed region.  The caller warms up."""
    best = float("inf")
    for _ in range(reps):
        t0 = clock()
        call()
        sync_device(device)
        best = min(best, clock() - t0)
    return best


def time_dispatch(fn: Callable[..., torch.Tensor],
                  ins: Sequence[torch.Tensor], reps: int,
                  clock: Callable[[], float]) -> float:
    """Min-of-``reps`` wall time of one dispatch unit ``fn(*ins)``
    (:func:`min_of_reps`).

    On the card the unit is captured once (:func:`capture_graph`: a warm-up
    and the capture) and each rep is one replay; off it each rep is one
    eager call after one warm-up."""
    dev = ins[0].device
    if dev.type != "cuda":
        fn(*ins)
        return min_of_reps(lambda: fn(*ins), reps, clock, dev)
    graph, _, _ = capture_graph(fn, ins)
    return min_of_reps(graph.replay, reps, clock, dev)
