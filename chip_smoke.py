#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--out results.json] [--baseline TREE]

Phases; each raises on failure, so a failing phase never exits 0:

1. the card's name and power limit; all four CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
   the constants, shared-memory counts (rule 1), K splits and blocks per
   launch that Python restates checked against the sources';
2. each kernel against its plain PyTorch version on the card, at the shapes
   full-width AlexNet gives it (conv2-conv5, fc6-fc8), batch 1 and 8: the
   float kernels in RELAXED, IMPRECISE and PRECISE, TF32 off; the int8
   kernels bit for bit, bias and ReLU each on and off;
3. the RELAXED main path: full-width AlexNet (random weights from a seed)
   through ``synthesize(device="h100", PlannerConfig(batch=8))`` (with a
   tracer and a metrics registry) and ``for_batch(1)`` / ``for_batch(8)``,
   each one CUDA graph (a warm-up pass, then the capture), 4 replayed
   batches each in one ``torch.profiler`` window; the wrappers' launch
   counters (which count the warm-ups and the captures; a replay calls no
   wrapper) and the kernels' launches on the card in the replays (counted
   by ``__global__`` name in the window) must each show one float conv
   launch per kernel-routed conv group, three matmul calls (each a split
   and a reduce launch) per pass and no int8 launch; the logits must match
   the same program run on CPU copies of the weights (the plain versions)
   within 2 bf16 ulps, and the probabilities within what those logits
   allow; then one ``synthesize`` with a 16-image validation set and its
   gate record;
4. the int8 main path: the same network through ``synthesize(...,
   forced_mode=IMPRECISE_INT8)`` with the 16 images as calibration set,
   then ``for_batch(1)`` / ``for_batch(8)`` (CUDA graphs), 4 replayed
   batches each; every kernel-routed int8 layer must carry calibrated
   qparams, the int8 kernels must launch once per routed group and pass
   (the float ones never), counted as in phase 3, and the logits must match
   the same program run
   on CPU copies of its prepared weights within
   mode_tolerance(IMPRECISE_INT8) of the row's largest |logit|; then one
   ``synthesize(..., allow_int8=True, max_degradation=0.05)`` through the
   loop and the gate;
5. times: each kernel and one library call for the same function where
   PyTorch has one, as device time (calls captured in a CUDA graph, the
   weights cycled through copies so they are cold in L2), with the
   kernel's ratio to the library call; one kernel call between CUDA events,
   host dispatch included; the plain version (CUDA events); the bound from
   bytes and operations; the float kernels under RELAXED and IMPRECISE
   (what Stage C ships); every kernel's blocks per launch; for the int8
   conv, whether one PyTorch call computes an int8 convolution on the card
   (what was tried and why it failed, where none does); end to end at
   batch 1 and 8 for the RELAXED and the int8 program, the eager walk
   (``infer``) against the replayed CUDA graph (``BatchProgram``), in
   turns, each between CUDA events and on the host clock to a
   synchronize; a replay must equal the eager walk bit for bit;
6. one ``torch.profiler`` window of three replayed batch-8 requests per
   program: device time by kernel (the program's kernels must be among
   them) and the device's busy share of the host-clock time;
7. the serving tier: phase 3's and phase 4's programs (not synthesized
   again) through ``run_offered_load`` on a ``ReplicaSet`` with
   ``ServingConfig(max_batch=8, max_delay_s=0.002)``, 1 and then 2
   replicas on the card sharing one ``ProgramCache`` per program (its 4
   buckets built first), three runs each: (a) 128 requests back to back
   in a profiler window, where no request may fail, admitted + shed must
   equal the requests, every response must equal its bucket's
   ``BatchProgram`` on the same (zero-padded) image batch bit for bit, no
   wrapper may run, and each kernel must launch on the card once per
   routed layer in every replay (the warm-ups' and the dispatched
   buckets'); (b) 4096 requests back to back with the admission bound
   above that, so none is shed: the tier's capacity in img/s; (c) 2048
   requests offered open loop at half that capacity under the default
   bound (64 per replica): p50, p95 and p99 latency, img/s and the shed
   share.  At most 4 Stage-D builds per program, ``serving_*`` series in
   the snapshot and ``serve.dispatch`` and ``synthesis.*`` spans in the
   trace; prints the graph memory per bucket; then
   ``python3 -m repro_torch.launch.serve_cnn`` on full-width AlexNet in a
   child process, which must exit 0.

With ``--baseline TREE`` (an older checkout of this repository that has
the int8 datapath, e.g. unpacked from ``git archive`` under ``build/``),
phase 5 also runs :func:`int8_probe` on TREE's package in a child process
before this tree's times and again after them, and on this tree's in
between: the two int8 kernels' device times at the same shapes, and the
forced IMPRECISE_INT8 program's fc8 logits on fixed images, which must be
bit-equal across the trees (the int8 kernels equal their plain versions,
which neither tree changed).  Each shape must be faster in this tree.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA or
without the repository beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
H100_BF16_FLOPS = 989e12      # dense tensor-core peak (data sheet, 700 W)
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak (data sheet, 700 W)
H100_BYTES_PER_S = 3.35e12    # HBM3
L2_BYTES = 50 * 2 ** 20       # the H100's L2 cache
#: Kernel vs plain on the card: rtol = mode_tolerance(mode) with
#: atol = rtol * max|plain|, except PRECISE, where the kernel's sequential
#: FMA chain and the plain version's library sums add 2304-term f32 sums
#: in different orders: rtol 1e-5 there (measured about 2e-6 on H100).
PRECISE_KERNEL_RTOL = 1e-5
#: GPU program vs the same program on CPU copies, held on the logits (fc8's
#: output, pre-softmax).  Under RELAXED they are bf16, rounded once at the
#: row's scale; the card and the CPU add the f32 sums before each bf16
#: rounding in different orders, so an activation may round the other way.
#: Limit: |d logit| <= 2 bf16 ulps at the row's largest |logit|.  Then each
#: probability p may move by at most p * (exp(2 d) - 1), d the row's
#: largest |d logit|, and top-1 must agree wherever the CPU's top logit
#: leads the runner-up by more than 2 d (bf16 logits also tie exactly).
LOGIT_ULPS = 2
#: f32 softmax of equal logits on the card and on the CPU: relative slack.
SOFTMAX_RTOL = 1e-5
#: The int8 program on the card vs the same program (same plan, same
#: prepared weights) on CPU copies.  The int8 kernels equal their plain
#: versions bit for bit; what can differ is the library conv1 (cuDNN vs the
#: CPU) and the f32 LRN, whose last-bit differences can flip a bf16
#: rounding and then an int8 rounding of conv2's input.  Limit on the
#: logits: mode_tolerance(IMPRECISE_INT8) = 0.15 of the row's largest
#: |logit|; top-1 must agree wherever the CPU's top logit leads the
#: runner-up by more than twice the row's largest |d logit|.
#: Calibration on the card vs on the CPU copy: scales within rtol 1e-4.
CALIB_RTOL = 1e-4

CONV_SHAPES = [  # name, cin, hw, k, cout (3x3/5x5 SAME, stride 1, u = 128)
    ("conv2", 96, 27, 5, 256), ("conv3", 256, 13, 3, 384),
    ("conv4", 384, 13, 3, 384), ("conv5", 384, 13, 3, 256)]
MM_SHAPES = [("fc6", 9216, 4096), ("fc7", 4096, 4096), ("fc8", 4096, 1000)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3):
    """Medians of ``reps`` timings of ``fn`` after ``warmup``: between CUDA
    events, and on the host clock from the call to the end event's
    synchronize.  Returns ``(event_ms, host_ms)``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(a.elapsed_time(b))
    return statistics.median(ev), statistics.median(host)


def device_launches(fn, names):
    """Launches on the card of each named ``__global__`` while ``fn`` runs,
    counted by kernel name in one ``torch.profiler`` window (a graph replay
    calls no wrapper, so only the card sees its launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA":
            for n in names:
                if n + "<" in ev.key or n + "(" in ev.key:
                    counts[n] += ev.count
    return counts


def cold_copies(t, footprint: int = 2 * L2_BYTES):
    """``t`` and clones of it, together at least ``footprint`` bytes, so that
    cycling through them finds each copy cold in the card's L2."""
    n = max(1, -(-footprint // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def graph_ms(calls, runs: int = 5) -> float:
    """Device time of one call: ``max(20, 2 * len(calls))`` calls, cycling
    through ``calls``, captured in one CUDA graph and replayed ``runs`` times
    between CUDA events; the median per call.  Host dispatch is not in it;
    the gaps between the graph's kernels are."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    reps = max(20, 2 * len(calls))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for r in range(reps):
            calls[r % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def int8_probe() -> dict:
    """The int8 kernels' device times at AlexNet's shapes, batch 1 and 8
    (weights cold in L2, as in phase 5), and the forced IMPRECISE_INT8
    program's fc8 logits and probabilities on fixed images.  It imports the
    ``repro_torch`` on ``sys.path`` and calls only what every tree with the
    int8 datapath has, so ``--baseline`` can run it on an older tree's
    package."""
    import torch
    import torch.nn.functional as F
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import (ComputeMode, PlannerConfig, collect_activations,
                                  synthesize)
    from repro_torch.data import imagenet_like
    from repro_torch.kernels.conv_mapmajor.conv_mapmajor import conv_mapmajor_int8
    from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import matmul_mapmajor_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rand_i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=gen, dtype=torch.int8)

    times = {}
    for batch in (1, 8):
        for name, cin, hw, k, cout in CONV_SHAPES:
            gi, go, p = -(-cin // 128), -(-cout // 128), k // 2
            x8 = F.pad(rand_i8(batch, gi, hw, hw, 128), (0, 0, p, p, p, p))
            w8 = rand_i8(go, 128, gi, k, k, 128)
            s8 = torch.rand(go, 128, device=dev, generator=gen) * 1e-4
            b = torch.randn(go, 128, device=dev, generator=gen) * 0.1
            times[f"{name} B={batch}"] = graph_ms(
                [lambda wc=wc: conv_mapmajor_int8(x8, wc, s8, b, out_hw=(hw, hw),
                                                  apply_relu=True)
                 for wc in cold_copies(w8)])
        for name, kdim, ndim in MM_SHAPES:
            a8, wm8 = rand_i8(batch, kdim), rand_i8(kdim, ndim)
            s8 = torch.rand(ndim, device=dev, generator=gen) * 1e-5
            b = torch.randn(ndim, device=dev, generator=gen) * 0.1
            times[f"{name} B={batch}"] = graph_ms(
                [lambda wc=wc: matmul_mapmajor_int8(a8, wc, s8, b, apply_relu=True)
                 for wc in cold_copies(wm8)])
    net = alexnet()
    params = init_network_params(net, SEED, "cuda")
    img_gen = torch.Generator().manual_seed(SEED + 2)
    cal_x, cal_y = imagenet_like(img_gen, 16, hw=227, num_classes=1000, device="cuda")
    prog = synthesize(net, params, (cal_x, cal_y), device="h100",
                      planner_config=PlannerConfig(batch=8),
                      forced_mode=ComputeMode.IMPRECISE_INT8)
    x, _ = imagenet_like(img_gen, 8, hw=227, num_classes=1000, device="cuda")
    z = collect_activations(net, prog.prepared, x, plan=prog.plan)["fc8"]
    y = prog.for_batch(8)(x)
    torch.cuda.synchronize()
    return {"times": times, "logits": z.cpu(), "probs": y.cpu(),
            "act_scales": dict(prog.synthesis_report.act_scales)}


def baseline_probe(tree: str, out_path: str) -> dict:
    """:func:`int8_probe` on ``tree``'s package, in a child process that
    builds that tree's kernels into its own ``build/``."""
    import torch
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--probe-src", os.path.join(os.path.abspath(tree), "src"),
                    "--probe-out", out_path], check=True, timeout=600)
    return torch.load(out_path)


def int8_conv_library(x_nchw, w_copies, pad: int):
    """One PyTorch call that computes an int8 convolution on the card with
    int32 accumulation inside, for each weight copy, or None; and what was
    tried, with the error each attempt raised.  ``x_nchw`` (N, C, H, W) and
    the copies (O, C, k, k) are int8 on the card."""
    import torch
    import torch.nn.functional as F
    tried = []
    exact = F.conv2d(x_nchw.double(), w_copies[0].double(), padding=pad)
    try:
        y = F.conv2d(x_nchw, w_copies[0], padding=pad)
        torch.cuda.synchronize()
        check(y.dtype == torch.int32 and torch.equal(y.double(), exact),
              f"F.conv2d on int8 returns {y.dtype}, not the exact int32 sums")
        return ([lambda wc=wc: F.conv2d(x_nchw, wc, padding=pad) for wc in w_copies],
                "F.conv2d on int8 tensors", tried)
    except Exception as e:  # noqa: BLE001 - what the build lacks is the finding
        tried.append(f"F.conv2d(int8, int8): {type(e).__name__}: {str(e).splitlines()[0][:200]}")
    try:
        # The quantized cuDNN conv: int8 operands, int32 sums, the output
        # requantized to int8 at out_scale.
        out_scale = float(exact.abs().max()) / 127
        xq = torch.quantize_per_tensor(x_nchw.float(), 1.0, 0, torch.qint8) \
            .contiguous(memory_format=torch.channels_last)
        packs = [torch.ops.quantized.conv2d_prepack(
            torch.quantize_per_tensor(wc.float(), 1.0, 0, torch.qint8), None,
            [1, 1], [pad, pad], [1, 1], 1) for wc in w_copies]
        y = torch.ops.quantized.conv2d(xq, packs[0], out_scale, 0)
        torch.cuda.synchronize()
        want = torch.clamp(torch.round(exact / out_scale), -128, 127)
        check(y.device.type == "cuda"
              and (y.int_repr().double() - want).abs().max().item() <= 1,
              "quantized::conv2d disagrees with the exact sums requantized")
        return ([lambda pk=pk: torch.ops.quantized.conv2d(xq, pk, out_scale, 0)
                 for pk in packs],
                "torch.ops.quantized.conv2d (quantized cuDNN; int8 out, requantized)", tried)
    except Exception as e:  # noqa: BLE001
        tried.append(f"torch.ops.quantized.conv2d on CUDA qint8: {type(e).__name__}: "
                     f"{str(e).splitlines()[0][:200]}")
    return None, None, tried


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(t.abs().float().clamp_min(2.0 ** -126))) - 7)


def logit_check(z, z_cpu, limit_row):
    """Hold card logits against the CPU copy's: |d| <= limit_row per row,
    and top-1 equal wherever the CPU's lead exceeds twice the row's |d|.
    Returns (dz, d_row, number of equal top-1)."""
    dz = (z.float().cpu() - z_cpu).abs()
    check(bool((dz <= limit_row).all()),
          f"logits differ by {(dz / limit_row).max().item():.3g} of their limit")
    d_row = dz.amax(-1, keepdim=True)
    top2 = z_cpu.topk(2, dim=-1).values
    card_top1 = z.float().argmax(-1).cpu()
    clear_lead = (top2[:, 0] - top2[:, 1]) > 2 * d_row[:, 0]
    check(bool((card_top1 == z_cpu.argmax(-1))[clear_lead].all()),
          "top-1 differs between the card and the CPU copy")
    return dz, d_row, int((card_top1 == z_cpu.argmax(-1)).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--baseline", metavar="TREE",
                    help="an older checkout whose int8 kernels and int8 logits phase 5 "
                         "compares with this tree's, in this call")
    ap.add_argument("--probe-src", help=argparse.SUPPRESS)   # the child of --baseline
    ap.add_argument("--probe-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if args.probe_src:
        sys.path.insert(0, args.probe_src)
        torch.save(int8_probe(), args.probe_out)
        return 0
    sys.path.insert(0, os.path.join(repo, "src"))
    import torch.nn.functional as F

    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import (IMPL_KERNEL, ComputeMode, PlannerConfig,
                                  collect_activations, mode_tolerance, synthesize)
    from repro_torch.data import imagenet_like
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv_mapmajor.conv_mapmajor import (
        INT8_MAX_U, MAX_U, conv_mapmajor, conv_mapmajor_int8, conv_mapmajor_int8_plain,
        conv_mapmajor_plain, cuda_grid_blocks, cuda_grid_blocks_int8, cuda_smem_bytes,
        cuda_smem_bytes_int8, kernel_grid_blocks_int8, kernel_smem_bytes,
        kernel_smem_bytes_int8)
    from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import (
        BLOCK_K, cuda_grid_blocks as mm_grid_blocks, int8_grid_blocks, matmul_mapmajor,
        matmul_mapmajor_int8, matmul_mapmajor_int8_plain, matmul_mapmajor_plain)
    from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import \
        cuda_grid_blocks_int8 as mm_grid_blocks_int8
    from repro_torch.kernels.matmul_mapmajor.ops import block_k
    from repro_torch.obs import MetricsRegistry, Tracer

    counted = {"conv_mapmajor": conv_mapmajor, "matmul_mapmajor": matmul_mapmajor,
               "conv_mapmajor_int8": conv_mapmajor_int8,
               "matmul_mapmajor_int8": matmul_mapmajor_int8}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    results: dict = {}
    phase_s: dict = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        print(f"[phase {name}: {now - t_phase:.1f} s]", flush=True)
        t_phase = now

    card = card_line()
    print(f"card: {card}", flush=True)
    results["card"] = card

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(logs)} kernels in {build_s:.2f} s (nvcc in parallel)", flush=True)
    for name, (_, log) in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    results["build_seconds"] = build_s
    modes = [ComputeMode.RELAXED, ComputeMode.IMPRECISE, ComputeMode.PRECISE]
    int8 = ComputeMode.IMPRECISE_INT8
    # The constants Python restates from the sources; the tile size enters
    # the smem counts, checked at conv1's 11x11/4 and at conv2-conv5's k.
    check(_build.load("conv_mapmajor").conv_mapmajor_max_u() == MAX_U,
          "MAX_U disagrees with kMaxU in conv_mapmajor.cu")
    check(_build.load("matmul_mapmajor").matmul_mapmajor_block_k() == BLOCK_K,
          "BLOCK_K disagrees with BK in matmul_mapmajor.cu")
    check(_build.load("conv_mapmajor_int8").conv_mapmajor_int8_max_u() == INT8_MAX_U,
          "INT8_MAX_U disagrees with kMaxU in conv_mapmajor_int8.cu")
    check(_build.load("matmul_mapmajor_int8").matmul_mapmajor_int8_block_k() == BLOCK_K,
          "BLOCK_K disagrees with BK in matmul_mapmajor_int8.cu")
    for k, s in [(11, 4)] + [(k, 1) for _, _, _, k, _ in CONV_SHAPES]:
        for mode in modes:
            check(kernel_smem_bytes(k, k, s, 128, 128, mode)
                  == cuda_smem_bytes(k, k, s, 128, 128, mode),
                  "rule-1 envelope disagrees with the kernel's smem request")
        # the lean staging and the 32-lane weight slices
        for u, u_out, s2 in [(128, 128, 2), (100, 7, 2), (4, 16, 1)]:
            check(kernel_smem_bytes(k, k, s2, u, u_out, ComputeMode.PRECISE)
                  == cuda_smem_bytes(k, k, s2, u, u_out, ComputeMode.PRECISE),
                  "rule-1 envelope disagrees with the kernel's smem request")
        check(kernel_smem_bytes_int8(k, k, s, 128, 128)
              == cuda_smem_bytes_int8(k, k, s, 128, 128),
              "int8 rule-1 envelope disagrees with the int8 kernel's smem request")
    # The int8 conv's request and blocks per launch at k, s of conv1, conv2
    # and conv3-conv5, full and lean staging, 64- and 32-lane slices.
    int8_smem = {}
    for k, s in [(11, 4), (5, 1), (3, 1)]:
        for u, u_out, s2 in [(128, 128, s), (128, 128, 4), (100, 7, s), (4, 16, s),
                             (36, 33, 2)]:
            py = kernel_smem_bytes_int8(k, k, s2, u, u_out)
            check(py == cuda_smem_bytes_int8(k, k, s2, u, u_out),
                  "int8 rule-1 envelope disagrees with the int8 kernel's smem request")
            check(py <= 232448, f"int8 request {py} B over the block budget")
            for n, gi, hw in [(1, 3, 13), (8, 1, 27)]:
                args8 = (n, gi, 3, u_out, hw, hw, k, k, s2, u)
                check(kernel_grid_blocks_int8(*args8) == cuda_grid_blocks_int8(*args8),
                      "int8 conv blocks per launch disagree with the source's")
        int8_smem[f"{k}x{k}/{s}"] = kernel_smem_bytes_int8(k, k, s, 128, 128)
    print(f"int8 conv smem per block at u = 128: {int8_smem}")
    for batch in (1, 8):
        for name, kdim, ndim in MM_SHAPES:
            check(int8_grid_blocks(batch, ndim, kdim) == mm_grid_blocks_int8(batch, ndim, kdim),
                  "int8 matmul blocks (and so K splits) disagree with the source's")
            check(int8_grid_blocks(batch, ndim, kdim) >= 2 * 132,
                  f"int8 matmul {name} B={batch}: fewer than 2 blocks per SM")
    results["int8_conv_smem_bytes"] = int8_smem
    phase_done("build")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    def rand_i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=gen,
                             dtype=torch.int8)

    # ---- 2. kernels vs their plain versions -------------------------------
    def rtol(mode):
        return PRECISE_KERNEL_RTOL if mode is ComputeMode.PRECISE else mode_tolerance(mode)

    conv_inputs, mm_inputs, conv8_inputs, mm8_inputs = {}, {}, {}, {}
    errs = {name: [] for name in counted}
    print("kernel vs plain (max |err| / atol):", flush=True)
    for batch in (1, 8):
        for name, cin, hw, k, cout in CONV_SHAPES:
            gi, go, p = -(-cin // 128), -(-cout // 128), k // 2
            # map-major as the wrapper makes it: SAME border and the lanes
            # past cin in the last group are zeros
            x = F.pad(rand(batch, gi, hw, hw, 128), (0, 0, p, p, p, p))
            w = rand(go, 128, gi, k, k, 128, scale=(2.0 / (cin * k * k)) ** 0.5)
            x[:, -1, ..., cin - (gi - 1) * 128:] = 0
            w[:, :, -1, ..., cin - (gi - 1) * 128:] = 0
            b = rand(go, 128, scale=0.1)
            conv_inputs[(name, batch)] = (x, w, b, hw)
            for mode in modes:
                for relu in (True, False):
                    got = conv_mapmajor(x, w, b, out_hw=(hw, hw), mode=mode,
                                        apply_relu=relu)
                    want = conv_mapmajor_plain(x, w, b, out_hw=(hw, hw),
                                               mode=mode, apply_relu=relu)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    atol = rtol(mode) * max(want.float().abs().max().item(), 1.0)
                    print(f"  conv {name} B={batch} {mode.value:9s} relu={relu!s:5s} "
                          f"{err:.3g} / {atol:.3g}")
                    check(torch.isfinite(got.float()).all().item() and err <= atol,
                          f"conv_mapmajor {name} B={batch} {mode.value}: {err} > {atol}")
                    if mode is ComputeMode.RELAXED:
                        errs["conv_mapmajor"].append(err)
            # The int8 kernel at the same shape: int8 operands (zero border
            # and zero lanes past cin), a per-channel scale of the size
            # act_scale x weight_scale takes, bit-equality required.
            x8 = F.pad(rand_i8(batch, gi, hw, hw, 128), (0, 0, p, p, p, p))
            w8 = rand_i8(go, 128, gi, k, k, 128)
            x8[:, -1, ..., cin - (gi - 1) * 128:] = 0
            w8[:, :, -1, ..., cin - (gi - 1) * 128:] = 0
            s8 = torch.rand(go, 128, device=dev, generator=gen) * 1e-4
            conv8_inputs[(name, batch)] = (x8, w8, s8, b, hw)
            for bias in (True, False):
                for relu in (True, False):
                    bb = b if bias else None
                    got = conv_mapmajor_int8(x8, w8, s8, bb, out_hw=(hw, hw),
                                             apply_relu=relu)
                    want = conv_mapmajor_int8_plain(x8, w8, s8, bb, out_hw=(hw, hw),
                                                    apply_relu=relu)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    print(f"  conv_int8 {name} B={batch} bias={bias!s:5s} relu={relu!s:5s} "
                          f"{err:.3g} (bit-equal required)")
                    check(torch.equal(got, want),
                          f"conv_mapmajor_int8 {name} B={batch} differs from its plain version")
                    errs["conv_mapmajor_int8"].append(err)
        for name, kdim, ndim in MM_SHAPES:
            a = rand(batch, kdim)
            wm = rand(kdim, ndim, scale=(2.0 / kdim) ** 0.5)
            bias = rand(ndim, scale=0.1)
            mm_inputs[(name, batch)] = (a, wm, bias)
            for mode in modes:
                for relu in (True, False):
                    got = matmul_mapmajor(a, wm, bias, mode=mode, bk=block_k(128),
                                          apply_relu=relu)
                    want = matmul_mapmajor_plain(a, wm, bias, mode=mode,
                                                 bk=block_k(128), apply_relu=relu)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    atol = rtol(mode) * max(want.float().abs().max().item(), 1.0)
                    print(f"  matmul {name} B={batch} {mode.value:9s} relu={relu!s:5s} "
                          f"{err:.3g} / {atol:.3g}")
                    check(torch.isfinite(got.float()).all().item() and err <= atol,
                          f"matmul_mapmajor {name} B={batch} {mode.value}: {err} > {atol}")
                    if mode is ComputeMode.RELAXED:
                        errs["matmul_mapmajor"].append(err)
            a8, wm8 = rand_i8(batch, kdim), rand_i8(kdim, ndim)
            s8 = torch.rand(ndim, device=dev, generator=gen) * 1e-5
            mm8_inputs[(name, batch)] = (a8, wm8, s8, bias)
            for with_bias in (True, False):
                for relu in (True, False):
                    bb = bias if with_bias else None
                    got = matmul_mapmajor_int8(a8, wm8, s8, bb, apply_relu=relu)
                    want = matmul_mapmajor_int8_plain(a8, wm8, s8, bb, apply_relu=relu)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    print(f"  matmul_int8 {name} B={batch} bias={with_bias!s:5s} "
                          f"relu={relu!s:5s} {err:.3g} (bit-equal required)")
                    check(torch.equal(got, want),
                          f"matmul_mapmajor_int8 {name} B={batch} differs from its plain version")
                    errs["matmul_mapmajor_int8"].append(err)
    results["kernel_vs_plain_max_abs_err"] = {k: max(v) for k, v in errs.items()}
    phase_done("kernel_vs_plain")

    # ---- 3. main path, RELAXED --------------------------------------------
    net = alexnet()
    params = init_network_params(net, SEED, "cuda")
    cfg = PlannerConfig(batch=8)
    synth_registry = MetricsRegistry()
    tracer = Tracer(clock=synth_registry.clock)
    prog = synthesize(net, params, device="h100", planner_config=cfg,
                      registry=synth_registry, tracer=tracer)

    def routed_groups(program):
        """Print the routing; count kernel-routed groups by anchor kind."""
        counts = {"conv": 0, "dense": 0}
        for g in program.plan.graph.groups:
            lp = program.plan.for_layer(g.name)
            members = "+".join(l.name for l in g.layers)
            print(f"  {members:22s} {lp.impl:14s} {lp.mode.value:14s} {lp.u:4d}  {lp.reason}")
            if lp.impl == IMPL_KERNEL:
                counts[g.anchor.kind] += 1
        return counts

    print("routing, RELAXED (group: impl mode u reason):")
    groups = routed_groups(prog)
    conv_kernel_groups, dense_kernel_groups = groups["conv"], groups["dense"]
    check(dense_kernel_groups == 3, f"{dense_kernel_groups} dense groups routed to the kernel")
    check(conv_kernel_groups >= 1, "no conv group routed to the kernel")

    n_batches = 4
    builds = 2 * 2                   # for_batch(1), for_batch(8): warm-up + capture
    replays = 2 * n_batches
    img_gen = torch.Generator().manual_seed(SEED + 1)
    #: Each kernel's CUDA launches per layer call, by ``__global__`` name.
    device_kernels = {"conv_mapmajor": ("conv_mapmajor_kernel",),
                      "matmul_mapmajor": ("matmul_mapmajor_split",
                                          "matmul_mapmajor_reduce"),
                      "conv_mapmajor_int8": ("conv_mapmajor_int8_kernel",),
                      "matmul_mapmajor_int8": ("matmul_mapmajor_int8_split",
                                               "matmul_mapmajor_int8_reduce")}
    all_globals = [g for gs in device_kernels.values() for g in gs]

    def check_device_launches(dev_counts, per_pass, passes, what):
        """Each kernel's globals launched ``passes`` times per routed layer."""
        for kern, globs in device_kernels.items():
            for g in globs:
                want = passes * per_pass.get(kern, 0)
                check(dev_counts[g] == want,
                      f"{what}: {g} launched {dev_counts[g]} times on the card, "
                      f"{want} expected ({passes} passes)")

    def serve(program, label):
        """for_batch(1) and for_batch(8), each one CUDA graph, then n_batches
        replays of each in one profiler window.  The wrappers count the
        warm-ups and the captures; the replays' launches are counted on the
        card by kernel name."""
        reset_counts()
        bps = {batch: program.for_batch(batch) for batch in (1, 8)}
        for batch, bp in bps.items():
            check(bp.captured, f"for_batch({batch}) did not capture a CUDA graph")
        inputs = {batch: [imagenet_like(img_gen, batch, hw=227, num_classes=1000,
                                        device="cuda")[0] for _ in range(n_batches)]
                  for batch in (1, 8)}
        served = {}

        def replay_all():
            for batch in (1, 8):
                served[batch] = [(x, bps[batch](x)) for x in inputs[batch]]

        dev_counts = device_launches(replay_all, all_globals)
        counts = read_counts()
        print(f"Stage D, {label}: " + "; ".join(
            f"B={b}: {bp.compile_seconds:.3f} s (warm-up + capture), graph memory "
            f"{bp.graph_bytes / 2**20:.1f} MiB" for b, bp in bps.items()))
        print(f"launches on the {label} path: wrappers ({builds} passes: warm-ups and "
              f"captures) {counts}; on the card in the {replays} replays {dev_counts}")
        return served, counts, dev_counts, bps

    served, launches, dev_launches, bps = serve(prog, "RELAXED")
    per_pass = {"conv_mapmajor": conv_kernel_groups, "matmul_mapmajor": 3}
    for kern in counted:
        want = builds * per_pass.get(kern, 0)
        check(launches[kern] == want,
              f"{kern}: {launches[kern]} wrapper calls, {want} expected ({builds} passes)")
    check_device_launches(dev_launches, per_pass, replays, "RELAXED replays")
    results["launches"] = launches
    results["device_launches"] = dev_launches
    results["stage_d_compiles"] = prog.stage_d_compiles
    check(prog.stage_d_compiles == 2, "two Stage-D specializations expected")

    cpu_params = {n: {k: v.cpu() for k, v in p.items()} for n, p in params.items()}
    prog_cpu = synthesize(net, cpu_params, device="h100", planner_config=cfg)
    check(prog_cpu.plan.fingerprint() == prog.plan.fingerprint(),
          "CPU copy planned differently")
    max_ulps = max_dlogit = max_dprob = max_prob_ratio = 0.0
    n_img = n_equal = 0
    for batch, outs in served.items():
        for x, y in outs:
            check(tuple(y.shape) == (batch, 1000) and torch.isfinite(y).all().item(),
                  "non-finite or misshaped output")
            check(torch.allclose(y.sum(-1), torch.ones(batch, device=dev), atol=1e-4),
                  "probabilities do not sum to 1")
            z = collect_activations(net, prog.prepared, x, plan=prog.plan)["fc8"]
            acts_cpu = collect_activations(net, prog_cpu.prepared, x.cpu(),
                                           plan=prog_cpu.plan)
            z_cpu, y_cpu = acts_cpu["fc8"].float(), acts_cpu[prog.plan.graph.output]
            check(tuple(z.shape) == (batch, 1000) and torch.isfinite(z).all().item(),
                  "non-finite or misshaped logits")
            ulp_row = bf16_ulp(z_cpu.abs().amax(-1, keepdim=True))
            dz, d_row, eq = logit_check(z, z_cpu, LOGIT_ULPS * ulp_row)
            ulps = (dz / ulp_row).max().item()
            dprob = (y.cpu() - y_cpu).abs()
            ptol = y_cpu * (torch.expm1(2 * d_row) + SOFTMAX_RTOL)
            check(bool((dprob <= ptol).all()),
                  "a probability moved more than its logits allow")
            n_equal += eq
            max_ulps, max_dlogit = max(max_ulps, ulps), max(max_dlogit, dz.max().item())
            max_dprob = max(max_dprob, dprob.max().item())
            max_prob_ratio = max(max_prob_ratio, (dprob / ptol).max().item())
            n_img += batch
    print(f"card vs CPU copy: top-1 equal on {n_equal}/{n_img} images; logits max "
          f"|d| {max_dlogit:.4g} = {max_ulps:.3g} bf16 ulps at the row's scale "
          f"(limit {LOGIT_ULPS}); max |d prob| {max_dprob:.4g}, at most "
          f"{max_prob_ratio:.3g} of its limit p*(exp(2d)-1)")
    results["card_vs_cpu"] = {"top1_equal": n_equal, "images": n_img,
                              "max_dlogit": max_dlogit, "max_dlogit_ulps": max_ulps,
                              "max_dprob": max_dprob}

    # Stage C on the card: 16 validation images labelled by the PRECISE
    # program; launch counts are not asserted for this run.
    val_x, _ = imagenet_like(img_gen, 16, hw=227, num_classes=1000, device="cuda")
    precise = synthesize(net, params, device="h100", planner_config=cfg,
                         forced_mode=ComputeMode.PRECISE)
    val_y = precise.infer(val_x).argmax(-1)
    t0 = time.perf_counter()
    tuned = synthesize(net, params, (val_x, val_y), max_degradation=0.05,
                       device="h100", planner_config=cfg)
    synth_s = time.perf_counter() - t0
    rep = tuned.synthesis_report
    print("synthesis with validation: modes "
          + ", ".join(f"{n}={m.value}" for n, m in tuned.modes.items()))
    print("  " + rep.summary().replace("\n", "\n  "))
    check(rep.validated, "validation gate failed")
    results["gate"] = {"modes": {n: m.value for n, m in tuned.modes.items()},
                       "reference_accuracy": rep.reference_accuracy,
                       "validations": [(v.accuracy, v.degradation, v.passed)
                                       for v in rep.validations],
                       "fallbacks": rep.fallbacks, "seconds": synth_s}
    phase_done("main_path_relaxed")

    # ---- 4. main path, IMPRECISE_INT8 -------------------------------------
    t0 = time.perf_counter()
    prog8 = synthesize(net, params, (val_x, val_y), device="h100", planner_config=cfg,
                       forced_mode=int8, registry=synth_registry, tracer=tracer)
    synth8_s = time.perf_counter() - t0
    print(f"int8 synthesis ({synth8_s:.2f} s); plan:")
    print("  " + prog8.plan.table().replace("\n", "\n  "))
    act_scales = prog8.synthesis_report.act_scales
    print("act_scales: " + ", ".join(f"{n}={v:.6g}" for n, v in act_scales.items()))
    print("routing, IMPRECISE_INT8 (group: impl mode u reason):")
    groups8 = routed_groups(prog8)
    for g in prog8.plan.graph.groups:
        lp = prog8.plan.for_layer(g.name)
        if lp.impl == IMPL_KERNEL and lp.mode is int8:
            check(lp.qparams is not None, f"{g.name} is int8 on the kernel without qparams")
    check(set(act_scales) == {l.name for l in net.param_layers},
          "forced int8 with calibration images left a layer uncalibrated")
    check(groups8["dense"] == 3, f"{groups8['dense']} int8 dense groups on the kernel")
    check(groups8["conv"] >= 1, "no int8 conv group routed to the kernel")
    served8, launches8, dev_launches8, bps8 = serve(prog8, "IMPRECISE_INT8")
    per_pass8 = {"conv_mapmajor_int8": groups8["conv"], "matmul_mapmajor_int8": 3}
    for kern in counted:
        want = builds * per_pass8.get(kern, 0)
        check(launches8[kern] == want,
              f"{kern}: {launches8[kern]} wrapper calls, {want} expected ({builds} passes)")
    check_device_launches(dev_launches8, per_pass8, replays, "IMPRECISE_INT8 replays")
    check(prog8.stage_d_compiles == 2, "two Stage-D specializations expected")

    # The same program (plan, quantized weights, qparams) on CPU copies.
    cpu_prepared8 = {n: {k: v.to("cpu") for k, v in p.items()}
                     for n, p in prog8.prepared.items()}
    tol8 = mode_tolerance(int8)
    max_ratio8 = max_dlogit8 = 0.0
    n_img8 = n_equal8 = 0
    for batch, outs in served8.items():
        for x, y in outs:
            check(tuple(y.shape) == (batch, 1000) and torch.isfinite(y).all().item(),
                  "non-finite or misshaped int8 output")
            check(torch.allclose(y.sum(-1), torch.ones(batch, device=dev), atol=1e-4),
                  "int8 probabilities do not sum to 1")
            z = collect_activations(net, prog8.prepared, x, plan=prog8.plan)["fc8"]
            z_cpu = collect_activations(net, cpu_prepared8, x.cpu(),
                                        plan=prog8.plan)["fc8"].float()
            check(tuple(z.shape) == (batch, 1000) and torch.isfinite(z).all().item(),
                  "non-finite or misshaped int8 logits")
            limit = tol8 * z_cpu.abs().amax(-1, keepdim=True)
            dz, _, eq = logit_check(z, z_cpu, limit)
            n_equal8 += eq
            max_dlogit8 = max(max_dlogit8, dz.max().item())
            max_ratio8 = max(max_ratio8, (dz / limit).max().item())
            n_img8 += batch
    print(f"int8 card vs CPU copy: top-1 equal on {n_equal8}/{n_img8} images; logits "
          f"max |d| {max_dlogit8:.4g}, at most {max_ratio8:.3g} of the limit "
          f"{tol8} x the row's largest |logit|")
    prog8_cpu = synthesize(net, cpu_params, (val_x.cpu(), val_y.cpu()), device="h100",
                           planner_config=cfg, forced_mode=int8)
    scale_rel = max(abs(prog8_cpu.synthesis_report.act_scales[n] - v) / v
                    for n, v in act_scales.items())
    print(f"calibration on the CPU copy: act_scales within {scale_rel:.3g} (rtol "
          f"{CALIB_RTOL}); plan fingerprint "
          f"{'equal' if prog8_cpu.plan.fingerprint() == prog8.plan.fingerprint() else 'differs'}")
    check(scale_rel <= CALIB_RTOL, "calibration on the card and the CPU disagree")
    check([(n, lp.impl, lp.u) for n, lp in prog8_cpu.plan]
          == [(n, lp.impl, lp.u) for n, lp in prog8.plan],
          "CPU copy routed the int8 program differently")
    results["int8"] = {"launches": launches8, "device_launches": dev_launches8,
                       "act_scales": act_scales,
                       "synthesis_seconds": synth8_s,
                       "card_vs_cpu": {"top1_equal": n_equal8, "images": n_img8,
                                       "max_dlogit": max_dlogit8,
                                       "max_dlogit_over_limit": max_ratio8},
                       "calibration_max_rel_diff": scale_rel}

    t0 = time.perf_counter()
    tuned8 = synthesize(net, params, (val_x, val_y), allow_int8=True, max_degradation=0.05,
                        device="h100", planner_config=cfg)
    synth8_loop_s = time.perf_counter() - t0
    rep8 = tuned8.synthesis_report
    print("synthesis with allow_int8: modes "
          + ", ".join(f"{n}={m.value}" for n, m in tuned8.modes.items()))
    print("  " + rep8.summary().replace("\n", "\n  "))
    check(rep8.validated, "int8 validation gate failed")
    final = rep8.final_validation
    check(final.passed and final.degradation <= 0.05 + 1e-9 and final.modes == tuned8.modes,
          "the gate's last record does not describe the shipped program")
    int8_layers = {n for n, m in tuned8.modes.items() if m is int8}
    check(all(tuned8.plan.for_layer(n).qparams is not None for n in int8_layers)
          and set(rep8.act_scales) == int8_layers,
          "shipped int8 layers and their calibration disagree")
    check(all(lp.qparams is None for n, lp in tuned8.plan if n not in int8_layers),
          "a float layer carries qparams")
    results["gate_int8"] = {"modes": {n: m.value for n, m in tuned8.modes.items()},
                            "reference_accuracy": rep8.reference_accuracy,
                            "validations": [(v.accuracy, v.degradation, v.passed)
                                            for v in rep8.validations],
                            "fallbacks": rep8.fallbacks, "seconds": synth8_loop_s}
    phase_done("main_path_int8")

    # ---- 5. times -----------------------------------------------------------
    # Kernel and library times are device times (graph_ms): each call cycles
    # through copies of its weights so that they are cold in L2, as in the
    # program, where the other layers' weights pass through L2 in between.
    # call_ms is one call between CUDA events, host dispatch included.
    relaxed, imprecise = ComputeMode.RELAXED, ComputeMode.IMPRECISE
    bf16 = torch.bfloat16
    probe_dir = os.path.join(repo, "build", "int8_probe")
    if args.baseline:   # the older tree first: parent, this tree, this tree, parent
        base1 = baseline_probe(args.baseline, os.path.join(probe_dir, "baseline_1.pt"))
    rows = []
    shapes = {name: (cin, cout) for name, cin, _, _, cout in CONV_SHAPES}
    cudnn_ms = {}

    def row(kern, name, batch, calls, plain, lib, flops, nbytes, peak,
            imprecise_calls=None, blocks=None):
        rows.append({"kernel": kern, "layer": name, "batch": batch,
                     "ms": graph_ms(calls), "call_ms": cuda_ms(calls[0])[0],
                     "imprecise_ms": graph_ms(imprecise_calls) if imprecise_calls else None,
                     "plain_ms": plain, "library_ms": graph_ms(lib) if lib else None,
                     "flops": flops, "bytes": nbytes, "peak": peak, "blocks": blocks})
        return rows[-1]

    for (name, batch), (x, w, b, hw) in conv_inputs.items():
        xb, wb = x.to(bf16), w.to(bf16)
        gi, go = x.shape[1], w.shape[0]
        k = w.shape[3]
        cin, cout = shapes[name]
        copies = cold_copies(wb)
        kernel_calls = {mode: [lambda wc=wc, mode=mode: conv_mapmajor(
            xb, wc, b, out_hw=(hw, hw), mode=mode, apply_relu=True)
            for wc in copies] for mode in (relaxed, imprecise)}
        plain = cuda_ms(lambda: conv_mapmajor_plain(xb, wb, b, out_hw=(hw, hw),
                                                    mode=relaxed, apply_relu=True), reps=5)[0]
        # The layer's own NCHW operands: no SAME border, no zero lanes past
        # cin.  The library call and the bound do the layer's work, not the
        # kernel's padded work.
        x_nchw = xb[:, :, k // 2:k // 2 + hw, k // 2:k // 2 + hw, :] \
            .permute(0, 1, 4, 2, 3).reshape(batch, gi * 128, hw, hw)[:, :cin].contiguous()
        w_oihw = wb.permute(0, 1, 2, 5, 3, 4).reshape(go * 128, gi * 128, k, k)[
            :cout, :cin].contiguous()
        b_lib = b.reshape(-1)[:cout].to(bf16)
        lib_calls = [lambda wc=wc: F.conv2d(x_nchw, wc, b_lib, padding=k // 2)
                     for wc in cold_copies(w_oihw)]
        flops = 2.0 * batch * hw * hw * cout * cin * k * k
        nbytes = 2 * (x_nchw.numel() + w_oihw.numel() + batch * cout * hw * hw) + 4 * cout
        r = row("conv_mapmajor", name, batch, kernel_calls[relaxed], plain, lib_calls,
                flops, nbytes, H100_BF16_FLOPS, kernel_calls[imprecise],
                cuda_grid_blocks(batch, go, w.shape[1], hw, hw, k, k, 1, 128, relaxed))
        cudnn_ms[(name, batch)] = r["library_ms"]
    int8_conv_lib = {}
    for (name, batch), (x8, w8, s8, b, hw) in conv8_inputs.items():
        k = w8.shape[3]
        gi, go = x8.shape[1], w8.shape[0]
        cin, cout = shapes[name]
        calls = [lambda wc=wc: conv_mapmajor_int8(x8, wc, s8, b, out_hw=(hw, hw),
                                                  apply_relu=True)
                 for wc in cold_copies(w8)]
        plain = cuda_ms(lambda: conv_mapmajor_int8_plain(x8, w8, s8, b, out_hw=(hw, hw),
                                                         apply_relu=True), reps=3)[0]
        # The layer's own work: 1-byte activations and weights, bf16 out, f32
        # scale and bias; the library call (if any) on the layer's own NCHW
        # int8 operands.
        x_nchw = x8[:, :, k // 2:k // 2 + hw, k // 2:k // 2 + hw, :] \
            .permute(0, 1, 4, 2, 3).reshape(batch, gi * 128, hw, hw)[:, :cin].contiguous()
        w_oihw = w8.permute(0, 1, 2, 5, 3, 4).reshape(go * 128, gi * 128, k, k)[
            :cout, :cin].contiguous()
        lib_calls, lib_what, tried = int8_conv_library(x_nchw, cold_copies(w_oihw), k // 2)
        int8_conv_lib[f"{name} B={batch}"] = {"call": lib_what, "tried": tried}
        flops = 2.0 * batch * hw * hw * cout * cin * k * k
        nbytes = batch * cin * hw * hw + cout * cin * k * k + 2 * batch * cout * hw * hw \
            + 8 * cout
        row("conv_mapmajor_int8", name, batch, calls, plain, lib_calls, flops, nbytes,
            H100_INT8_OPS, blocks=cuda_grid_blocks_int8(batch, gi, go, w8.shape[1], hw,
                                                        hw, k, k, 1, 128))
        del calls, lib_calls
    first = next(iter(int8_conv_lib.values()))
    print(f"int8 conv library call: {first['call'] or 'none'}; tried: "
          + ("; ".join(first["tried"]) or "-"))
    results["int8_conv_library"] = int8_conv_lib
    for (name, batch), (a, wm, bias) in mm_inputs.items():
        ab, wb = a.to(bf16), wm.to(bf16)
        kdim, ndim = wm.shape
        copies = cold_copies(wb)
        kernel_calls = {mode: [lambda wc=wc, mode=mode: matmul_mapmajor(
            ab, wc, bias, mode=mode, bk=block_k(128), apply_relu=True)
            for wc in copies] for mode in (relaxed, imprecise)}
        plain = cuda_ms(lambda: matmul_mapmajor_plain(ab, wb, bias, mode=relaxed,
                                                      bk=block_k(128), apply_relu=True),
                        reps=5)[0]
        bias_lib = bias.to(bf16)
        lib_calls = [lambda wc=wc: torch.addmm(bias_lib, ab, wc) for wc in copies]
        flops = 2.0 * batch * kdim * ndim
        nbytes = 2 * (a.numel() + wm.numel() + batch * ndim) + 4 * bias.numel()
        row("matmul_mapmajor", name, batch, kernel_calls[relaxed], plain, lib_calls,
            flops, nbytes, H100_BF16_FLOPS, kernel_calls[imprecise],
            mm_grid_blocks(batch, ndim, kdim, block_k(128)))
        del copies, kernel_calls, lib_calls
    for (name, batch), (a8, wm8, s8, bias) in mm8_inputs.items():
        plain = cuda_ms(lambda: matmul_mapmajor_int8_plain(a8, wm8, s8, bias,
                                                           apply_relu=True), reps=5)[0]
        # cuBLASLt's int8 product (int32 out, no flush) needs M > 16: A is
        # padded to 32 rows; B column-major, cuBLASLt's int8 layout.
        a32 = F.pad(a8, (0, 0, 0, 32 - batch))
        wm8_cm = wm8.t().contiguous().t()
        check(torch.equal(torch._int_mm(a32, wm8_cm)[:batch],
                          (a8.double() @ wm8.double()).to(torch.int32)),
              "torch._int_mm disagrees with the exact int32 product")
        calls = [lambda wc=wc: matmul_mapmajor_int8(a8, wc, s8, bias, apply_relu=True)
                 for wc in cold_copies(wm8)]
        lib_calls = [lambda wc=wc: torch._int_mm(a32, wc) for wc in cold_copies(wm8_cm)]
        kdim, ndim = wm8.shape
        flops = 2.0 * batch * kdim * ndim
        nbytes = batch * kdim + kdim * ndim + 2 * batch * ndim + 8 * ndim
        row("matmul_mapmajor_int8", name, batch, calls, plain, lib_calls, flops, nbytes,
            H100_INT8_OPS, blocks=mm_grid_blocks_int8(batch, ndim, kdim))
        del calls, lib_calls
    print("kernel times (ms, device, weights cold in L2): kernel [IMPRECISE] | one call "
          "with host dispatch | plain | library | bound (by) | kernel/library | blocks per "
          "launch; float kernels RELAXED, IMPRECISE in brackets; int8 library: "
          "torch._int_mm at M=32; conv: the int8 call above, or none (bf16 cuDNN beside, "
          "and the ratio to it)")
    per_shape = []
    for r in rows:
        t_ops = r["flops"] / r.pop("peak") * 1e3
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        key = (r["layer"], r["batch"])
        lib = r["library_ms"]
        lib_s = f"{lib:.4f}" if lib is not None else "none"
        if r["kernel"] == "conv_mapmajor_int8":
            r["ratio_to_bf16_cudnn"] = r["ms"] / cudnn_ms[key]
            lib_s += f" (bf16 cuDNN {cudnn_ms[key]:.4f}: {r['ratio_to_bf16_cudnn']:.2f}x)"
        r.update(bound_ms=bound, bound_by=by,
                 ratio_to_library=r["ms"] / (lib if lib is not None else cudnn_ms[key]))
        imp_s = f" [{r['imprecise_ms']:.4f}]" if r["imprecise_ms"] is not None else ""
        blk_s = f" | {r['blocks']} blocks" if r["blocks"] is not None else ""
        print(f"  {r['kernel']:20s} {r['layer']} B={r['batch']}: {r['ms']:.4f}{imp_s} | "
              f"{r['call_ms']:.4f} | {r['plain_ms']:.4f} | {lib_s} | {bound:.5f} ({by}) | "
              f"{r['ratio_to_library']:.2f}x{blk_s}")
        per_shape.append(r)
    results["per_shape"] = per_shape

    if args.baseline:
        ours = int8_probe()
        base2 = baseline_probe(args.baseline, os.path.join(probe_dir, "baseline_2.pt"))
        main_ms = {f"{r['layer']} B={r['batch']}": r["ms"] for r in per_shape
                   if r["kernel"].endswith("int8")}
        print(f"int8 kernels, baseline {args.baseline} vs this tree (ms, device, weights cold "
              "in L2): baseline 1 | this tree (phase 5) | this tree (probe) | baseline 2 | "
              "speed-up (baselines' mean / this tree's mean)")
        compare = {}
        for key, old1 in base1["times"].items():
            old2, new2 = base2["times"][key], ours["times"][key]
            new1 = main_ms[key]
            gain = (old1 + old2) / (new1 + new2)
            compare[key] = {"baseline": [old1, old2], "this_tree": [new1, new2],
                            "speedup": gain}
            print(f"  {key:10s} {old1:.4f} | {new1:.4f} | {new2:.4f} | {old2:.4f} | "
                  f"{gain:.2f}x")
            check(max(new1, new2) < min(old1, old2),
                  f"int8 kernel at {key} not faster than the baseline's")
        same = [torch.equal(ours["logits"], b["logits"]) for b in (base1, base2)]
        print(f"int8 program fc8 logits, this tree vs the baseline: "
              f"{'bit-equal' if all(same) else 'DIFFER'} (both baseline runs); act_scales "
              f"{'equal' if ours['act_scales'] == base1['act_scales'] else 'differ'}")
        check(all(same), "the int8 program's logits differ from the baseline's")
        check(all(torch.equal(ours["probs"], b["probs"]) for b in (base1, base2)),
              "the int8 program's probabilities differ from the baseline's")
        results["baseline"] = {"tree": args.baseline, "int8_kernels": compare,
                               "int8_logits_bit_equal": all(same)}

    # End to end: the eager walk against the replayed graph, in turns
    # (eager, graph, graph, eager), each between CUDA events (host dispatch
    # included) and on the host clock to a synchronize.
    e2e = {}
    programs = (("relaxed", prog, served, bps), ("int8", prog8, served8, bps8))
    for label, program, outs, bp_of in programs:
        e2e[label] = {}
        for batch in (1, 8):
            bp = bp_of[batch]
            x = outs[batch][0][0]
            fns = {"eager": lambda: program.infer(x), "graph": lambda: bp(x)}
            ev = {k: [] for k in fns}
            wall = {k: [] for k in fns}
            for k in ("eager", "graph", "graph", "eager"):
                ev_ms, host_ms = cuda_ms(fns[k], reps=20)
                ev[k].append(ev_ms)
                wall[k].append(host_ms)
            row_ = {k: {"ms_per_batch": statistics.mean(ev[k]),
                        "ms_runs": ev[k], "host_ms": statistics.mean(wall[k]),
                        "images_per_s": batch / statistics.mean(ev[k]) * 1e3}
                    for k in fns}
            got, want = bp(x), program.infer(x)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want),
                  f"{label} B={batch}: the replay differs from the eager walk by {d:.3g} "
                  "in the probabilities")
            e2e[label][batch] = row_
            print(f"end to end {label} B={batch}: eager {row_['eager']['ms_per_batch']:.3f} ms "
                  f"(host clock {row_['eager']['host_ms']:.3f}), graph "
                  f"{row_['graph']['ms_per_batch']:.3f} ms (host clock "
                  f"{row_['graph']['host_ms']:.3f}) per batch, "
                  f"{row_['graph']['images_per_s']:.1f} img/s replayed; replay bit-equal "
                  "to eager")
    results["end_to_end"] = e2e
    phase_done("times")

    # ---- 6. where the time goes: one profiled window at batch 8 each ------
    from torch.profiler import ProfilerActivity, profile
    results["profile_b8"] = {}
    kernel_names = {"relaxed": ("conv_mapmajor_kernel", "matmul_mapmajor_split",
                                "matmul_mapmajor_reduce"),
                    "int8": ("conv_mapmajor_int8_kernel", "matmul_mapmajor_int8_split",
                             "matmul_mapmajor_int8_reduce")}
    # A first, discarded window: the profiler's own start-up (CUPTI) would
    # otherwise land in the first program's measured window.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        bps[8](served[8][0][0])
        torch.cuda.synchronize()
    for label, program, outs, bp_of in programs:
        bp = bp_of[8]
        x = outs[8][0][0]
        bp(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                bp(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        by_kernel = {}
        for ev in prof.key_averages():
            if ev.device_type.name == "CUDA" and ev.self_device_time_total:
                by_kernel[ev.key] = ev.self_device_time_total / 3 / 1e3
        busy_ms = sum(by_kernel.values())
        if busy_ms:
            print(f"profile {label} B=8 (replayed graph): {wall_ms:.3f} ms per batch on "
                  f"the host clock, device busy {busy_ms:.3f} ms "
                  f"({busy_ms / wall_ms:.1%}); top device kernels:")
            for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
                print(f"  {ms:8.4f} ms  {name[:90]}")
            missing = [k for k in kernel_names[label]
                       if not any(k + "<" in n or k + "(" in n for n in by_kernel)]
            check(not missing, f"profile {label}: no device time for {missing} in the "
                               "replayed window")
        else:
            print(f"profile {label} B=8: the profiler recorded no device time (not measured)")
        results["profile_b8"][label] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                        "by_kernel_ms": by_kernel}
    phase_done("profile")

    # ---- 7. the serving tier ----------------------------------------------
    from repro_torch.serving import (ProgramCache, ReplicaSet, ServingConfig,
                                     run_offered_load, warm_buckets)
    serve_cfg = ServingConfig(max_batch=8, max_delay_s=0.002)
    n_requests = 128
    n_saturate, n_paced = 4096, 2048
    results["serving"] = {}

    def load_entry(report, replicas):
        srv = report.server_stats
        check(srv["failed"] == 0, f"serving x{replicas}: {srv['failed']} requests failed")
        check(report.admitted + report.shed_requests == report.requests
              and srv["completed"] == report.admitted,
              f"serving x{replicas}: admitted + shed != requests")
        return {"replicas": replicas, "requests": report.requests,
                "offered_per_s": report.offered_rate_rps,
                "admitted": report.admitted, "shed": report.shed_requests,
                "shed_share": report.shed_requests / report.requests,
                "failed": srv["failed"], "p50_ms": report.latency_ms(50),
                "p95_ms": report.latency_ms(95), "p99_ms": report.latency_ms(99),
                "mean_ms": report.latency_mean_ms,
                "images_per_s": report.sustained_per_s,
                "wall_seconds": report.wall_seconds,
                "bucket_counts": srv["bucket_counts"],
                "padding_fraction": srv["padding_fraction"]}

    for label, program, _, _ in programs:
        per_pass_s = per_pass if program is prog else per_pass8
        cache = ProgramCache(config=serve_cfg, registry=MetricsRegistry(),
                             tracer=tracer)
        cache.admit(program)
        # Stage D for every bucket before any profiled window: a capture is
        # not made under the profiler.
        warm_buckets(cache, program, serve_cfg.max_batch)
        results["serving"][label] = {}
        for replicas in (1, 2):
            # (a) 128 requests back to back under a profiler window: every
            # response against its bucket's BatchProgram, and every replay's
            # kernels counted on the card.
            registry = MetricsRegistry()
            tier = ReplicaSet(program, config=serve_cfg.with_replicas(replicas),
                              cache=cache, registry=registry, tracer=tracer)
            buckets = []
            for r in tier.replicas:
                def logged(bucket, _inner=r.server.dispatch_bucket):
                    buckets.append(([q.image for q in bucket.requests], bucket.batch,
                                    [q.future for q in bucket.requests]))
                    _inner(bucket)
                r.server.dispatch_bucket = logged
            reports = []

            def back_to_back():
                reports.append(run_offered_load(tier, requests=n_requests,
                                                seed=SEED + 5))

            reset_counts()
            serve_dev = device_launches(back_to_back, all_globals)
            report = reports[0]
            serve_counts = read_counts()
            entry = load_entry(report, replicas)
            # warm_replicas replays each of the 4 buckets once per replica,
            # then one replay per dispatched bucket.
            passes = 4 * replicas + report.server_stats["batches"]
            check_device_launches(serve_dev, per_pass_s, passes,
                                  f"serving {label} x{replicas}")
            check(not any(serve_counts.values()),
                  f"serving {label}: a wrapper ran outside a graph: {serve_counts}")
            n_checked = 0
            for images, batch, futures in buckets:
                xb = np.stack(images)
                xb = np.concatenate([xb, np.zeros((batch - len(xb), *xb.shape[1:]),
                                                  xb.dtype)])
                want = cache.get_or_build(program, batch)(
                    torch.from_numpy(xb).to(dev)).cpu().numpy()
                for j, f in enumerate(futures):
                    check(np.array_equal(f.result(timeout=60), want[j]),
                          f"serving {label}: a response differs from its bucket's "
                          "BatchProgram")
                    n_checked += 1
            check(n_checked == report.admitted, "a served request was not checked")
            snap = registry.snapshot()
            check({"serving_dispatch_seconds", "serving_tier_submitted_total",
                   "serving_batcher_flush_total"} <= set(snap)
                  and "serving_cache_stage_d_compiles_total" in cache.registry.snapshot(),
                  "serving_* series missing from the snapshot")
            entry.update(device_launches=serve_dev, replay_passes=passes,
                         responses_bit_equal=n_checked)
            print(f"serving {label}, {replicas} replica(s), {n_requests} requests back to "
                  f"back (profiled): {report.admitted} admitted, {report.shed_requests} "
                  f"shed, 0 failed; buckets {entry['bucket_counts']}; {n_checked} "
                  f"responses bit-equal to their bucket's BatchProgram; {passes} replays, "
                  f"kernels on the card {serve_dev}")
            # (b) saturation: n_saturate back to back, admission bound above
            # the request count, so nothing is shed: the tier's capacity.
            sat_cfg = dataclasses.replace(serve_cfg, replicas=replicas,
                                          max_queue_depth=n_saturate)
            sat = load_entry(run_offered_load(
                ReplicaSet(program, config=sat_cfg, cache=cache,
                           registry=MetricsRegistry(), tracer=tracer),
                requests=n_saturate, seed=SEED + 6), replicas)
            check(sat["shed"] == 0, f"serving {label}: shed under an unreachable bound")
            # (c) latency under load: n_paced offered open loop at half that
            # capacity, the default admission bound (64 per replica).
            rate = sat["images_per_s"] / 2
            paced = load_entry(run_offered_load(
                ReplicaSet(program, config=serve_cfg.with_replicas(replicas),
                           cache=cache, registry=MetricsRegistry(), tracer=tracer),
                requests=n_paced, rate=rate, seed=SEED + 7), replicas)
            results["serving"][label][f"x{replicas}"] = {
                "back_to_back_128": entry, "saturation": sat, "paced": paced}
            for what, e in (("saturation", sat), ("half load", paced)):
                print(f"serving {label}, {replicas} replica(s), {what}: {e['requests']} "
                      f"requests offered at "
                      + (f"{e['offered_per_s']:.1f}/s" if e["offered_per_s"] else "once")
                      + f" over {e['wall_seconds']:.2f} s: {e['images_per_s']:.1f} img/s, "
                      f"p50 {e['p50_ms']:.3f} ms, p95 {e['p95_ms']:.3f} ms, p99 "
                      f"{e['p99_ms']:.3f} ms; {e['shed']} shed ({e['shed_share']:.2%}), "
                      f"0 failed; buckets {e['bucket_counts']}")
        compiles = cache.stats.stage_d_compiles
        check(compiles <= 4, f"serving {label}: {compiles} Stage-D builds (at most 4)")
        # Where a bucket of 8 spends its dispatch (host clock to a
        # synchronize, median of 20 each): the stack of the requests'
        # images, the copy to the card, the replay, the copy back.
        bp8 = cache.get_or_build(program, 8)
        images = list(np.random.default_rng(SEED).standard_normal(
            (8, *net.input_shape)).astype(np.float32))
        x8 = np.stack(images)
        x8_dev = torch.from_numpy(x8).to(dev)
        out8 = bp8(x8_dev)
        parts = {"stack": cuda_ms(lambda: np.stack(images))[1],
                 "to_device": cuda_ms(lambda: torch.from_numpy(x8).to(dev))[1],
                 "replay": cuda_ms(lambda: bp8(x8_dev))[1],
                 "to_host": cuda_ms(lambda: out8.cpu().numpy())[1]}
        results["serving"][label]["bucket8_ms"] = parts
        print(f"serving {label}: a bucket of 8, host clock: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()))
        graph_mib = {b: cache.get_or_build(program, b).graph_bytes / 2**20
                     for b in (1, 2, 4, 8)}
        results["serving"][label]["stage_d_compiles"] = compiles
        results["serving"][label]["graph_mib"] = graph_mib
        print(f"serving {label}: {compiles} Stage-D builds; graph memory per bucket (MiB): "
              + ", ".join(f"B={b}: {m:.1f}" for b, m in graph_mib.items()))
    span_names = {sp.name for sp in tracer.finished()}
    check("serve.dispatch" in span_names
          and any(n.startswith("synthesis.") for n in span_names),
          "serve.dispatch or synthesis.* spans missing from the trace")
    print("trace spans: " + ", ".join(sorted(span_names)))
    print(f"synthesis counters: runs "
          f"{synth_registry.counter('synthesis_runs_total').value():.0f}, "
          f"iterations {synth_registry.counter('synthesis_iterations_total').value():.0f}")
    results["trace_spans"] = sorted(span_names)

    # The launcher, as a user runs it, in a child process.
    t0 = time.perf_counter()
    launcher = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_cnn", "--net", "alexnet",
         "--scale", "1.0", "--input-hw", "227", "--classes", "1000", "--requests", "64"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src")))
    print(f"serve_cnn (full-width AlexNet, 64 requests): rc {launcher.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in launcher.stdout.splitlines()[:6]:
        print(f"  {line}")
    check(launcher.returncode == 0,
          f"serve_cnn exited {launcher.returncode}: {launcher.stderr[-2000:]}")
    results["serve_cnn_stdout"] = launcher.stdout
    phase_done("serving")

    # One entry per kernel: its wrapper's launches on its main path (warm-ups
    # and captures) and its globals' launches on the card in that path's
    # replays; times summed over the layers it serves in one batch-8
    # forward pass (float kernels in RELAXED, int8 kernels under
    # IMPRECISE_INT8).
    summary = []
    sources = {
        "conv_mapmajor": ("src/repro_torch/kernels/csrc/conv_mapmajor.cu",
                          "src/repro/kernels/conv_mapmajor/conv_mapmajor.py:106",
                          prog, launches, dev_launches),
        "matmul_mapmajor": ("src/repro_torch/kernels/csrc/matmul_mapmajor.cu",
                            "src/repro/kernels/matmul_mapmajor/matmul_mapmajor.py:67",
                            prog, launches, dev_launches),
        "conv_mapmajor_int8": ("src/repro_torch/kernels/csrc/conv_mapmajor_int8.cu",
                               "src/repro/kernels/conv_mapmajor/conv_mapmajor.py:168",
                               prog8, launches8, dev_launches8),
        "matmul_mapmajor_int8": ("src/repro_torch/kernels/csrc/matmul_mapmajor_int8.cu",
                                 "src/repro/kernels/matmul_mapmajor/matmul_mapmajor.py:96",
                                 prog8, launches8, dev_launches8)}
    for kern, (source, replaces, program, counts, dev_counts) in sources.items():
        routed = {g.name for g in program.plan.graph.groups
                  if program.plan.for_layer(g.name).impl == IMPL_KERNEL}
        sel = [r for r in per_shape if r["kernel"] == kern and r["batch"] == 8
               and r["layer"] in routed]
        peak = H100_INT8_OPS if kern.endswith("int8") else H100_BF16_FLOPS
        bound_ops = sum(r["flops"] for r in sel) / peak * 1e3
        bound_bytes = sum(r["bytes"] for r in sel) / H100_BYTES_PER_S * 1e3
        libs = [r["library_ms"] for r in sel]
        entry = {
            "name": kern, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[kern],
            "replay_launches_on_card": {g: dev_counts[g] for g in device_kernels[kern]},
            "max_abs_err": max(errs[kern]),
            "ms": sum(r["ms"] for r in sel), "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": sum(libs) if None not in libs else None,
            "shapes": "+".join(r["layer"] for r in sel) + " at batch 8, "
                      + ("IMPRECISE_INT8" if program is prog8 else "RELAXED")}
        if kern == "conv_mapmajor_int8":
            entry["library_note"] = (
                f"int8 library call: {first['call'] or 'none'}; bf16 F.conv2d on the "
                f"same layers: {sum(cudnn_ms[(r['layer'], 8)] for r in sel):.4f} ms")
        summary.append(entry)
    results["kernels"] = summary
    results["phase_seconds"] = phase_s
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps({"kernels": summary}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
