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
   child process, which must exit 0;
8. calibration, timed groups and the paper's baselines: (a) ``calibrate()``
   and ``resolve_profile("auto")`` into a temporary cache: each measured rate
   beside the ``h100`` profile's data-sheet figure (none may pass 1.05x it),
   a second ``resolve_profile("auto")`` must read the cache without
   measuring, and the AlexNet layers that route differently under the
   calibrated profile; (b) ``synthesize(..., allow_int8=True,
   max_degradation=0.05, autotune=True)`` with the 16 images (autotune on 8):
   every layer autotuned; where the loop converged and the gate kept its
   modes, every layer eligible for a kernel timed under it ("best of 2")
   and the wrappers called at least twice per such layer; the
   replay of ``for_batch(8)`` bit-equal to the eager walk and the logits
   within the loosest shipped mode's limit of the CPU copy's; then
   ``autotune_plan`` on phase 3's and phase 4's programs, where each wrapper
   must be called exactly once per routed layer and twice per timed one, and
   all four kernels must have launched in the phase; (c) ``measure_drift`` of
   the autotuned program at batch 8: its table, a positive finite predicted
   and measured time for every costed group, the ``plan_drift_*`` gauges and
   the worst group; each group of phase 3's and phase 4's programs timed
   under the kernel and the library path; (d) FLP and KLP on conv3 at batch
   1 (PRECISE, TF32 off, and RELAXED) and the sequential loop nest on a
   16-channel 13x13 conv, each against ``conv_olp`` on the card under the
   mode's tolerance, with their times beside OLP's.
9. warm starts across processes: two child processes share one temporary
   artifact directory (under ``build/``); each runs full-width AlexNet
   through ``synthesize(device="h100", PlannerConfig(batch=8),
   allow_int8=True, max_degradation=0.05, autotune=True, autotune_input=8
   images, artifact_store=...)`` with 16 validation images (labels from the
   float network on CPU copies, the same bits in both), then
   ``for_batch(8)`` and one replay on 8 fixed images, with each wrapper's
   launches counted around that.  The cold process must synthesize and
   persist; the warm one must read ``synthesis_iterations_total == 0``, a
   ``kind=program`` hit, the cold fingerprint and logits equal to the cold
   process's bit for bit; then its ``PlannerConfig(batch=1)`` request must
   miss.  Prints each process's seconds split into synthesis (or
   hydration) and Stage D.  Then ``python3 -m repro_torch.launch.serve_cnn
   --artifact-dir`` twice in child processes: both exit 0, the first
   persists, the second reports the warm start;
10. the dense LM: (a) Qwen2-7B at full width and depth (28 layers, d_model
   3584, 28/4 heads, d_ff 18944, vocab 152064; bf16 weights drawn on the
   card from a seed with the reference's ``1/sqrt(fan_in)`` scale) through
   ``ServingEngine.generate`` at batch 4, prompt 128, 32 new tokens, greedy,
   RELAXED, twice: equal tokens; prefill ms, decode tok/s, peak memory and
   the weight-streaming bound of a decode step; (b) the same width at 2
   layers, batch 2, prompt 16 and 4 decode steps (the CPU's greedy token
   fed to both) against CPU copies of the weights: every logit within
   ``mode_tolerance(RELAXED)`` of the row's largest |logit|, the greedy
   token equal wherever the CPU's lead exceeds that limit; (c) the same
   with ``window_override=8`` (a ring cache of 8 slots); (d) ``python3 -m
   repro_torch.launch.serve --arch qwen2-7b`` in a child process, which
   must exit 0.  This path has no hand-written kernel (the reference has
   no Pallas there).
11. the other LM families, plain PyTorch as phase 10 (the reference computes
   them with XLA operations only): (a)-(c) each config at its published
   widths, bf16 weights drawn on the card from a seed, through
   ``ServingEngine.generate`` at batch 4, prompt 128, 32 new tokens,
   greedy, RELAXED, twice (equal tokens): granite-moe-1b-a400m,
   hymba-1.5b, xlstm-350m and whisper-small (1500 encoder frames drawn from
   a seed) at full depth, llama-3.2-vision-90b (1601 image tokens) cut to one
   pattern period of 5 layers and qwen3-moe-235b-a22b cut to 2 layers (181
   and 470 GB whole); prefill ms, decode ms a step and tok/s, peak memory,
   the weight-streaming bound of a decode step (and of the active weights
   of a MoE), and one profiled granite decode step; (d) granite, hymba and
   xlstm at 2 layers and whisper at 2 decoder and 2 encoder layers (1500
   frames), full width, batch 2, prompt 16 and 4 decode steps (the CPU's
   greedy token fed to both) against CPU copies of the weights: every logit
   within ``mode_tolerance(RELAXED)`` of the row's largest |logit| (beside
   the CPU copy's own RELAXED error against its PRECISE run, for scale), the
   greedy token equal wherever the CPU's lead exceeds that limit; the MoE
   runs take the CPU's RELAXED expert choices
   (:class:`RouteReplay`), the card's own differing choices must be
   near-ties, and granite's prefill must drop pairs; (e) ``python3 -m
   repro_torch.launch.serve`` for granite at its published size and for
   the other five at ``--layers 2 --d-model 256``, six child processes at
   once, each of which must exit 0.
12. LM training, in a child process (a fresh caching allocator), plain
   PyTorch as phases 10–11 (the reference trains with XLA operations only):
   (a) Qwen2-7B at full width, 8 of its 28 layers (f32 params, gradients
   and AdamW moments: 47.3 GB; 121.8 GB whole), f32 weights drawn on the
   card from a seed, ``make_train_step`` in RELAXED at batch 4 x 1024 on
   ``lm_batches`` through ``DataPipeline``: a warm-up step and 3 timed ones
   (host clock and CUDA events; finite losses), tokens/s, peak memory, the
   step's bound (8 x non-embedding params x tokens at the bf16 peak: the
   forward, the backward and the forward again for remat; the f32 AdamW's
   bytes at 3.35 TB/s), the utilization (6 x non-embedding params x tokens,
   the model's operations without the recompute, at the bf16 peak, over
   the step's time), and one profiled step split by CUDA events into
   the forward, the backward and the optimizer, with the device's busy
   share and kernel count; (b) ``save_checkpoint`` of params and AdamW
   state, one more step from the live state, ``load_checkpoint`` into a
   fresh tree and the same step from it: equal losses and bit-equal
   params; (c) a 2-layer copy at full width against CPU copies of its
   weights on one sequence of 64 tokens: the RELAXED loss within
   ``mode_tolerance(RELAXED)``; in PRECISE with TF32 turned on for the
   process, the loss within rtol 1e-5 and each gradient leaf within a
   relative L2 error of 1e-4 of the CPU's, each parameter after one
   ``adamw_update`` within 1e-2 of the CPU's (a first AdamW step passes the
   per-element error of gradients near its eps straight through) and
   within 1e-6 of the CPU's ``adamw_update`` on the card's gradients, and
   the card's loss and gradients bit-equal to its run with TF32 off; (d) granite-moe-1b-a400m, hymba-1.5b, xlstm-350m and
   whisper-small (zero frames), whole at full width, two steps each at
   batch 4 x 512: finite losses, params and moments, every leaf with a
   gradient or a value moved, step ms and peak memory; the MoE routes with
   drops (capacity factor 1.25), and each layer's recompute drops the same
   pairs; then (e) ``python3 -m repro_torch.launch.train --arch xlstm-350m
   --layers 2 --d-model 256 --steps 20 --batch 8 --seq 128 --checkpoint``
   (the reference launcher's example) as a child: exit 0, and a checkpoint
   ``load_checkpoint`` reads back whose weights give the first batch a
   lower loss than the launcher's initial weights.
13. the mesh and dry-run tools (``nn/sharding.py``, ``launch/{mesh,specs,
   dryrun}.py``), plain PyTorch on DTensor (the reference's dry run lowers
   XLA operations only): (a) a one-rank NCCL group and a 1x1 mesh on the
   card; for each of ``MESH_PAIRS`` (Qwen2-7B decode_32k, batch 128 and a
   32,768-slot cache; Qwen2-7B's train step at 16 x 4096 tokens, one data
   rank's share of train_4k, as no train_4k pair fits one card whole; and
   whisper-small's prefill_32k, the pairs the dry run puts under 70 GB on
   one device, each at one pattern period and full width)
   ``build_lowering``'s step runs for real on DTensors over
   arguments drawn on the card from a seed, against the plain step on the
   same arguments: argument bytes equal to the dry run's exactly, the dry
   run's predicted peak (arguments + temp) within 10 % of the card's peak
   over the step (from a reset), its FLOPs equal to a ``FlopCounterMode``
   count of the real step, and the result bit-equal to the plain step's
   (on one card the mesh path changes no numerics); step ms between CUDA
   events; (b) ``python3 -m repro_torch.launch.dryrun`` in child processes
   on the fake group with a "cuda" mesh (``MESH_CHILDREN``: Qwen2-7B
   decode_32k at full depth and train_4k at one layer on 16x16 and
   2x16x16, and one pair of every other arch at one pattern period, each
   family and step kind at least once), each of which must exit 0 with
   ``status: "ok"``: per-device argument and temp GB, FLOPs, collectives
   and seconds; Qwen2-7B's full-depth decode must move its K/V cache by
   all-to-all (an ``all-to-all`` entry, all-gathers under 0.05 GB a
   device) with the all-reduces it made before the cache moved.
   All the dry runs start first and run beside (a).
14. the channel LayerNorm kernel (``kernels/csrc/layernorm_nchw.cu``,
   ConvNeXt-T's 23 LayerNorms): against its plain version on the card at the
   five shapes full-width ConvNeXt-T gives it at batch 8 (8x96x56x56,
   8x192x28x28, 8x384x14x14, 8x768x7x7 and the 8x768 vector), within one
   bf16 ulp at every element, at the scale of the terms ``|x_hat w| + |b|``
   that both round once (where they cancel, an output near 0 may be off by
   several of its own ulps); its device time at
   each shape (``graph_ms``) beside its bytes' bound, its plain version's
   and the library's LayerNorm on a permuted copy; then full-width
   ConvNeXt-T through ``synthesize`` and ``for_batch(8)``: 2 x 23 wrapper
   launches (warm-up and capture), 23 launches of ``layernorm_nchw_kernel``
   on the card in each of 4 replays, and a replay bit-equal to the eager
   walk.  Its entry in the ``kernels`` line sums the 23 layers.

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
    calls no wrapper, so only the card sees its launches).  The window's
    ``cudaGraphLaunch`` calls on the host are counted too, under that key:
    when a kernel's count falls short, they tell a replay that launched
    nothing apart from a record the profiler dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    counts["cudaGraphLaunch"] = 0
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA":
            for n in names:
                if n + "<" in ev.key or n + "(" in ev.key:
                    counts[n] += ev.count
        elif ev.key.startswith("cudaGraphLaunch"):
            counts["cudaGraphLaunch"] += ev.count
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


def phase8(net, params, cfg, validation, prog, prog8, x8, rand, counted):
    """Phase 8: calibration, autotune, drift and the paper's baselines on
    full-width AlexNet (see the module docstring).  ``prog``/``prog8`` are
    phase 3's and phase 4's programs, ``x8`` a batch of 8 images on the card,
    ``counted`` the kernel wrappers by name.  Returns the phase's results
    and the wrappers' calls in it."""
    import tempfile

    import torch

    from repro_torch.core import (IMPL_KERNEL, IMPL_XLA, ComputeMode, QuantizedTensor,
                                  autotune_plan, collect_activations, conv_flp, conv_klp,
                                  conv_olp, conv_sequential, lower_network,
                                  mode_tolerance, plan_network, synthesize)
    from repro_torch.device import H100, calibrate, resolve_profile
    from repro_torch.kernels.conv_mapmajor.ops import fits_vmem
    from repro_torch.obs import MetricsRegistry, Tracer, measure_drift
    int8 = ComputeMode.IMPRECISE_INT8
    val_x, val_y = validation
    p8 = {}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    # (a) Calibration: each rate beside the h100 profile's data-sheet figure.
    t0 = time.perf_counter()
    cal = calibrate()
    cal_s = time.perf_counter() - t0
    rates = {}
    for field, label, unit, unit_name in (
            ("peak_flops_bf16", "bf16 matmul", 1e12, "TFLOP/s"),
            ("peak_flops_f32", "f32 matmul (TF32 off)", 1e12, "TFLOP/s"),
            ("peak_flops_int8", "int8 matmul (torch._int_mm)", 1e12, "TOP/s"),
            ("hbm_bandwidth", "stream", 1e9, "GB/s")):
        got, sheet = getattr(cal, field), getattr(H100, field)
        rates[field] = {"measured": got, "datasheet": sheet, "share": got / sheet}
        print(f"calibrated {label}: {got / unit:.1f} {unit_name}, {got / sheet:.1%} of "
              f"the h100 profile's {sheet / unit:.0f}")
        check(got <= 1.05 * sheet,
              f"calibrated {label} {got:.4g} is above 1.05x the data sheet's {sheet:.4g}: "
              "impossible, or TF32 ran the f32 sweep")
    with tempfile.TemporaryDirectory() as cache_dir:
        first = resolve_profile("auto", cache_dir=cache_dir)
        ticks = []

        def counting_clock():
            ticks.append(1)
            return time.perf_counter()
        second = resolve_profile("auto", cache_dir=cache_dir, clock=counting_clock)
    check(first.source == "calibrated" and second == first and not ticks,
          "the second resolve_profile('auto') measured again instead of reading the cache")
    print(f"calibration {cal_s:.2f} s; resolve_profile('auto'): {first.summary()}; "
          "the second call read the cache (no measurement)")
    graph = lower_network(net)
    reroutes = {}
    for mode in (ComputeMode.RELAXED, int8):
        all_mode = {n: mode for n in net.inexactable_layers}
        a = plan_network(net, modes=all_mode, config=cfg, graph=graph)
        b = plan_network(net, modes=all_mode,
                         config=dataclasses.replace(cfg, profile=first), graph=graph)
        reroutes[mode.value] = [(n, a.for_layer(n).impl, b.for_layer(n).impl)
                                for n in net.inexactable_layers
                                if a.for_layer(n).impl != b.for_layer(n).impl]
        print(f"routing under the calibrated profile, all {mode.value}: "
              + (", ".join(f"{n} {x} -> {y}" for n, x, y in reroutes[mode.value])
                 or "no layer routes differently from h100"))
    p8["calibration"] = {"seconds": cal_s, "rates": rates, "profile": first.to_json_dict(),
                         "reroutes": reroutes}

    # (b) Autotune: each group timed under both candidates as a CUDA graph.
    layers_by_name = {l.name: l for l in net.param_layers}

    def kernel_of(name, lp, prepared):
        """The kernel a layer's kernel candidate launches, or None where
        autotune drops it (PRECISE, or over the shared-memory budget)."""
        l = layers_by_name[name]
        if lp.mode is ComputeMode.PRECISE or (
                l.kind == "conv" and not fits_vmem(l.kernel, l.stride, lp.u, lp.mode,
                                                   budget=H100.vmem_budget)):
            return None
        on_int8 = (lp.mode is int8 and lp.qparams is not None
                   and isinstance(prepared[name]["w"], QuantizedTensor))
        return ("conv_mapmajor" if l.kind == "conv" else "matmul_mapmajor") \
            + ("_int8" if on_int8 else "")

    reset_counts()
    t0 = time.perf_counter()
    tr8 = Tracer()
    auto = synthesize(net, params, (val_x, val_y), device="h100", planner_config=cfg,
                      allow_int8=True, max_degradation=0.05, autotune=True,
                      autotune_input=val_x[:8], tracer=tr8)
    auto_s = time.perf_counter() - t0
    auto_counts = read_counts()
    rep_a = auto.synthesis_report
    check(auto.plan.origin == "autotune" and rep_a.validated,
          "autotuned synthesis did not ship an autotuned plan through its gate")
    n_tunes = sum(sp.name == "synthesis.autotune" for sp in tr8.finished())
    print(f"synthesize(autotune=True, allow_int8=True): {auto_s:.2f} s, {n_tunes} autotune "
          f"passes, {len(rep_a.iterations)} iterations; wrapper calls {auto_counts}")
    # The last autotune pass ran under the shipped modes when the loop
    # converged (they repeat the round before) and the gate kept them.  A
    # loop can also end on its tie-break: near-equal candidates may swap
    # between passes, so the plan's fingerprint need not repeat.
    timed_under_shipped = rep_a.converged and not rep_a.fallbacks
    print(f"  converged: {rep_a.converged}, gate demotions: {len(rep_a.fallbacks)}"
          + ("" if timed_under_shipped else "; per-layer timing is checked on the two "
             "autotune_plan passes below only"))
    eligible = dict.fromkeys(counted, 0)
    for n in net.inexactable_layers:
        lp = auto.plan.for_layer(n)
        print(f"  {n:6s} {lp.impl:14s} {lp.mode.value:14s} {lp.reason}")
        check(lp.reason.startswith("autotune: "), f"{n} was not autotuned")
        k = kernel_of(n, lp, auto.prepared)
        if k is not None and timed_under_shipped:
            eligible[k] += 1
            check("best of 2" in lp.reason, f"{n}: its kernel candidate was not timed")
    for k, e in eligible.items():
        check(auto_counts[k] >= 2 * e,
              f"{k}: {auto_counts[k]} calls for {e} eligible layers (>= {2 * e} expected)")
    bp_auto = auto.for_batch(8)
    x_auto = x8
    y_auto = bp_auto(x_auto)
    check(torch.equal(y_auto, auto.infer(x_auto)),
          "the autotuned program's replay differs from its eager walk")
    z = collect_activations(net, auto.prepared, x_auto, plan=auto.plan)["fc8"]
    auto_cpu = {n: {k: v.to("cpu") for k, v in p.items()} for n, p in auto.prepared.items()}
    z_cpu = collect_activations(net, auto_cpu, x_auto.cpu(), plan=auto.plan)["fc8"].float()
    shipped = set(auto.modes.values())
    if int8 in shipped or ComputeMode.IMPRECISE in shipped:
        loosest = int8 if int8 in shipped else ComputeMode.IMPRECISE
        limit = mode_tolerance(loosest) * z_cpu.abs().amax(-1, keepdim=True)
        limit_name = f"mode_tolerance({loosest.value}) x the row's largest |logit|"
    else:
        limit = LOGIT_ULPS * bf16_ulp(z_cpu.abs().amax(-1, keepdim=True))
        limit_name = f"{LOGIT_ULPS} bf16 ulps"
    dz, _, eq_a = logit_check(z, z_cpu, limit)
    print(f"autotuned replay B=8 bit-equal to its eager walk; card vs CPU copy: logits max "
          f"|d| {dz.max().item():.4g} (limit {limit_name}), top-1 equal on {eq_a}/8")
    p8["autotune"] = {"seconds": auto_s, "passes": n_tunes, "launches": auto_counts,
                      "eligible": eligible, "modes": {n: m.value for n, m in auto.modes.items()},
                      "plan": {n: [lp.impl, lp.mode.value, lp.reason]
                               for n, lp in auto.plan if n in net.inexactable_layers}}
    # autotune_plan on phase 3's and phase 4's programs: exactly one call per
    # kernel-routed layer (the activation pass) and two (warm-up, capture) per
    # layer whose kernel candidate it times.
    p8["autotune_static"] = {}
    for label, p in (("RELAXED", prog), ("IMPRECISE_INT8", prog8)):
        before = read_counts()
        tuned = autotune_plan(net, p.prepared, val_x[:8], p.plan)
        delta = {k: v - before[k] for k, v in read_counts().items()}
        want = dict.fromkeys(counted, 0)
        print(f"autotune_plan on the {label} program (static -> tuned):")
        for n in net.inexactable_layers:
            lp, tl = p.plan.for_layer(n), tuned.for_layer(n)
            k = kernel_of(n, lp, p.prepared)
            if k is not None:
                want[k] += 2 + (lp.impl == IMPL_KERNEL)
                check("best of 2" in tl.reason, f"{label} {n}: kernel candidate not timed")
            print(f"  {n:6s} {lp.impl:14s} -> {tl.impl:14s} {tl.reason}")
        check(delta == want, f"autotune_plan on {label}: wrapper calls {delta}, {want} expected")
        p8["autotune_static"][label] = {
            "launches": delta, "plan": {n: [tuned.for_layer(n).impl, tuned.for_layer(n).reason]
                                        for n in net.inexactable_layers}}
    phase8_counts = read_counts()
    print(f"phase 8 wrapper calls (autotuned synthesis + two autotune_plan passes): "
          f"{phase8_counts}")
    check(all(phase8_counts.values()), "a kernel was launched no time in phase 8")
    p8["launches"] = phase8_counts

    # (c) Drift: predicted roofline vs the replayed group, batch 8.
    reg8 = MetricsRegistry()
    drift = measure_drift(auto, batch=8, reps=5, registry=reg8)
    print(drift.table())
    for g in drift.groups:
        check(0 < g.predicted_s < float("inf") and 0 < g.measured_s < float("inf"),
              f"drift {g.group}: predicted {g.predicted_s}, measured {g.measured_s}")
    check(len(drift.groups) == len(net.param_layers), "a costed group has no drift row")
    check({"plan_drift_predicted_seconds", "plan_drift_measured_seconds",
           "plan_drift_error_pct"} <= set(reg8.snapshot()), "plan_drift_* gauges missing")
    print(f"largest drift error: {drift.worst.group} ({drift.worst.error_pct:+.1f} %)")
    p8["drift"] = drift.as_dict()

    def library_twin(p):
        """The same program with every kernel-routed group on the library path."""
        layers = {n: dataclasses.replace(lp, impl=IMPL_XLA) if lp.impl == IMPL_KERNEL
                  else lp for n, lp in p.plan}
        return dataclasses.replace(p, plan=dataclasses.replace(p.plan, layers=layers))

    # Each group under both candidates, timed as autotune times it.
    p8["candidates_us"] = {}
    for label, p in (("RELAXED", prog), ("IMPRECISE_INT8", prog8)):
        kern = {g.group: g for g in measure_drift(p, batch=8, reps=5).groups}
        lib = {g.group: g for g in measure_drift(library_twin(p), batch=8, reps=5).groups}
        rows = {n: {"impl": kern[n].impl, "kernel_us": kern[n].measured_s * 1e6,
                    "library_us": lib[n].measured_s * 1e6,
                    "predicted_us": kern[n].predicted_s * 1e6} for n in kern}
        p8["candidates_us"][label] = rows
        print(f"{label} program, batch 8, replayed group (us): "
              + "; ".join(f"{n} {r['impl']} {r['kernel_us']:.1f} / library "
                          f"{r['library_us']:.1f} (predicted {r['predicted_us']:.1f})"
                          for n, r in rows.items()))

    # (d) The paper's baselines against OLP on the card.
    name3, cin3, hw3, k3, cout3 = CONV_SHAPES[1]
    x3 = rand(1, cin3, hw3, hw3)
    w3 = rand(cout3, cin3, k3, k3, scale=(cin3 * k3 * k3) ** -0.5)
    xs, ws = rand(1, 16, 13, 13), rand(16, 16, 3, 3, scale=(16 * 9) ** -0.5)
    baselines = {}
    for label, fn, xb, wb, mode_list in (
            (f"FLP {name3}", conv_flp, x3, w3, (ComputeMode.PRECISE, ComputeMode.RELAXED)),
            (f"KLP {name3}", conv_klp, x3, w3, (ComputeMode.PRECISE, ComputeMode.RELAXED)),
            ("sequential 16x16x13x13 k3", conv_sequential, xs, ws, (ComputeMode.PRECISE,))):
        for mode in mode_list:
            olp = conv_olp(xb, wb, padding="SAME", mode=mode)
            y = fn(xb, wb, padding="SAME", mode=mode)
            err = (y.float() - olp.float()).abs().max().item()
            tol = PRECISE_KERNEL_RTOL if mode is ComputeMode.PRECISE else mode_tolerance(mode)
            lim = tol * max(olp.float().abs().max().item(), 1.0)
            check(tuple(y.shape) == tuple(olp.shape) and err <= lim,
                  f"{label} {mode.value}: max |d| {err:.3g} against OLP (limit {lim:.3g})")
            reps = 3 if fn is conv_sequential else 10
            ms = cuda_ms(lambda: fn(xb, wb, padding="SAME", mode=mode), reps=reps, warmup=1)[0]
            olp_ms = cuda_ms(lambda: conv_olp(xb, wb, padding="SAME", mode=mode))[0]
            baselines[f"{label} {mode.value}"] = {"ms": ms, "olp_ms": olp_ms,
                                                  "max_abs_err": err, "limit": lim}
            print(f"{label} B=1 {mode.value}: {ms:.3f} ms vs OLP {olp_ms:.4f} ms "
                  f"({ms / olp_ms:.1f}x); max |d| {err:.3g} (limit {lim:.3g})")
    p8["baselines"] = baselines
    return p8, phase8_counts


def warmstart_child(store_dir: str, out_path: str, role: str) -> None:
    """One process of phase 9: full-width AlexNet through ``synthesize`` with
    the artifact store at ``store_dir`` (the gate, int8 and autotune on),
    ``for_batch(8)`` and one replay on fixed images; the wrappers' launches
    counted from just before ``synthesize`` to just after the replay.  The
    ``warm`` role then asks again with ``PlannerConfig(batch=1)``.  Writes
    its readings and logits to ``out_path`` (``torch.save``)."""
    import torch

    from repro_torch.artifacts import ArtifactStore
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import PlannerConfig, run_network, synthesize
    from repro_torch.data import imagenet_like
    from repro_torch.kernels.conv_mapmajor.conv_mapmajor import (
        conv_mapmajor, conv_mapmajor_int8)
    from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import (
        matmul_mapmajor, matmul_mapmajor_int8)
    from repro_torch.obs import MetricsRegistry

    counted = {"conv_mapmajor": conv_mapmajor, "matmul_mapmajor": matmul_mapmajor,
               "conv_mapmajor_int8": conv_mapmajor_int8,
               "matmul_mapmajor_int8": matmul_mapmajor_int8}
    net = alexnet()
    params = init_network_params(net, SEED, "cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    val_x, _ = imagenet_like(gen, 16, hw=227, num_classes=1000, device="cpu")
    x8, _ = imagenet_like(gen, 8, hw=227, num_classes=1000, device="cpu")
    # Labels from the float network on CPU copies: the same bits in every
    # process, so both processes make the same request.
    cpu_params = {n: {k: t.cpu() for k, t in p.items()} for n, p in params.items()}
    val_y = run_network(net, cpu_params, val_x).argmax(-1).cuda()
    val_x, x8 = val_x.cuda(), x8.cuda()

    def run(batch):
        reg = MetricsRegistry()
        store = ArtifactStore(store_dir, registry=reg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog = synthesize(net, params, (val_x, val_y), max_degradation=0.05,
                          allow_int8=True, device="h100",
                          planner_config=PlannerConfig(batch=batch), autotune=True,
                          autotune_input=val_x[:8], registry=reg, artifact_store=store)
        torch.cuda.synchronize()
        read = lambda name, **kw: float(reg.get(name).value(**kw))
        return prog, {
            "seconds": time.perf_counter() - t0,
            "iterations": read("synthesis_iterations_total"),
            **{f"{what}_{kind}": read(f"artifact_{what}_total", kind=kind)
               for what in ("hits", "misses", "writes", "invalid")
               for kind in ("program", "executable")},
            "hydrate_seconds": read("artifact_hydrate_seconds_total", kind="program"),
            "fingerprint": prog.fingerprint()}

    for fn in counted.values():
        fn.launches = 0
    prog, reading = run(8)
    bp = prog.for_batch(8)
    logits = bp(x8)
    torch.cuda.synchronize()
    reading.update(stage_d_seconds=bp.compile_seconds, captured=bp.captured,
                   launches={k: fn.launches for k, fn in counted.items()},
                   modes={n: m.value for n, m in prog.modes.items()},
                   validated=bool(prog.synthesis_report.validated))
    out = {"role": role, "main": reading}
    if role == "warm":
        out["batch1"] = run(1)[1]
    torch.save({"result": out, "logits": logits.cpu()}, out_path)
    print(json.dumps(out))


def phase9(repo: str) -> dict:
    """Phase 9: warm starts across processes (see the module docstring)."""
    import shutil
    import tempfile

    import torch
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="warmstart-", dir=os.path.join(repo, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    try:
        store = os.path.join(tmp, "store")
        got = {}
        for role in ("cold", "warm"):
            out = os.path.join(tmp, f"{role}.pt")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--warm-child", store, out,
                 role], cwd=repo, capture_output=True, text=True, timeout=900, env=env)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"warm-start {role} process exited "
                  f"{proc.returncode}: {proc.stderr[-3000:]}")
            got[role] = torch.load(out)
            got[role]["result"]["wall_seconds"] = wall
        cold, warm = (got[r]["result"] for r in ("cold", "warm"))
        c, w = cold["main"], warm["main"]
        for role, r in (("cold", c), ("warm", w)):
            print(f"{role}: synthesize {r['seconds']:.2f} s (iterations "
                  f"{r['iterations']:.0f}, program hits {r['hits_program']:.0f}, "
                  f"hydration {r['hydrate_seconds']:.3f} s), Stage D (capture of "
                  f"for_batch(8)) {r['stage_d_seconds']:.3f} s; process "
                  f"{got[role]['result']['wall_seconds']:.1f} s; wrapper launches "
                  f"{r['launches']}")
        print("  (the kernels' build directory was already warm from phase 1 in both)")
        check(c["iterations"] >= 1 and c["writes_program"] == 1,
              "the cold process did not synthesize and persist")
        check(c["validated"] and w["validated"], "a warm-start program is not validated")
        check(w["iterations"] == 0, f"warm process ran {w['iterations']} iterations")
        check(w["hits_program"] >= 1, "warm process read no program from the store")
        check(w["fingerprint"] == c["fingerprint"],
              f"fingerprints differ: {c['fingerprint']} vs {w['fingerprint']}")
        check(c["invalid_program"] == w["invalid_program"] == 0, "invalid artifacts")
        check(c["captured"] and w["captured"], "Stage D did not capture a CUDA graph")
        check(sum(c["launches"].values()) > 0 and sum(w["launches"].values()) > 0,
              "no kernel launched in a warm-start process")
        lc, lw = got["cold"]["logits"], got["warm"]["logits"]
        check(bool(torch.isfinite(lc).all()) and lc.shape == (8, 1000), "cold logits")
        ints = {2: torch.int16, 4: torch.int32}
        check(lc.dtype == lw.dtype and torch.equal(lc.view(ints[lc.element_size()]),
                                                   lw.view(ints[lw.element_size()])),
              "warm logits differ from the cold process's bits")
        print(f"warm logits equal the cold process's bit for bit ({lc.dtype}); modes "
              + ", ".join(f"{n}={m}" for n, m in w["modes"].items()))
        b1 = warm["batch1"]
        print(f"PlannerConfig(batch=1): program hits {b1['hits_program']:.0f}, misses "
              f"{b1['misses_program']:.0f}, iterations {b1['iterations']:.0f}, "
              f"{b1['seconds']:.2f} s")
        check(b1["hits_program"] == 0 and b1["iterations"] >= 1,
              "PlannerConfig(batch=1) hydrated the batch-8 program")

        # The launcher, twice, as a user runs it: cold, then warm.
        launches = []
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve_cnn", "--net", "alexnet",
                 "--scale", "1.0", "--input-hw", "227", "--classes", "1000",
                 "--requests", "32", "--artifact-dir", os.path.join(tmp, "serve_cnn")],
                cwd=repo, capture_output=True, text=True, timeout=600, env=env)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"serve_cnn --artifact-dir exited "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            lines = [l for l in proc.stdout.splitlines()
                     if l.startswith(("  stages A-C", "  program hydrated", "cold start",
                                      "warm start", "served"))]
            print(f"serve_cnn --artifact-dir: rc 0 in {wall:.1f} s")
            for line in lines:
                print(f"  {line.strip()}")
            launches.append({"seconds": wall, "lines": lines})
        check(any(l.startswith("cold start: program persisted") for l in launches[0]["lines"]),
              "the first serve_cnn launch did not persist its program")
        check(any(l.startswith("warm start: program hydrated") for l in launches[1]["lines"]),
              "the second serve_cnn launch did not start warm")
        return {"cold": cold, "warm": warm, "serve_cnn": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile_decode(params, cfg, prompts, label, aux=None, capacity=160) -> dict:
    """Where a decode step's time goes: prefill ``prompts``, one decode step
    to warm up, then one ``torch.profiler`` window of 4 steps (RELAXED).
    Returns the host-clock ms a step, the device-busy ms, the device kernels
    a step and the ten largest kernels' ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.precision import ComputeMode
    from repro_torch.nn import model as M
    relaxed = ComputeMode.RELAXED
    s = prompts.shape[1]
    with torch.inference_mode():
        z, caches = M.prefill(params, prompts, cfg, capacity=capacity, aux=aux,
                              mode=relaxed)
        tok = z.argmax(-1, keepdim=True)
        z, caches = M.decode_step(params, caches, tok, s, cfg, mode=relaxed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(4):
                z, caches = M.decode_step(params, caches, tok, s + 1 + i, cfg,
                                          mode=relaxed)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 4
    by_kernel = {ev.key: ev.self_device_time_total / 4 / 1e3 for ev in prof.key_averages()
                 if ev.device_type.name == "CUDA" and ev.self_device_time_total}
    busy_ms = sum(by_kernel.values())
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type.name == "CUDA") / 4
    print(f"{label} decode step (profiled): {wall_ms:.2f} ms on the host clock, device "
          f"busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), {launches:.0f} device "
          f"kernels a step; top:")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    for name, ms in top[:6]:
        print(f"  {ms:8.3f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_kernels": launches,
            "top": top[:10]}


def phase10(repo: str) -> dict:
    """Phase 10: the dense LM serving path (see the module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ComputeMode, mode_tolerance
    from repro_torch.nn import model as M
    from repro_torch.serving import ServingEngine

    relaxed = ComputeMode.RELAXED
    out: dict = {}
    cfg = get_config("qwen2-7b")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
           cfg.vocab_size) == (28, 3584, 28, 4, 18944, 152064), "qwen2-7b widths")

    # (a) full width, full depth.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # what phases 1-9 still hold
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                           "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tensors = list(M.tree_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in tensors)
    n_params = sum(t.numel() for t in tensors)
    check(n_params == M.num_params(cfg), "parameter count")
    engine = ServingEngine(cfg, params, max_context=160, mode=relaxed, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    runs = [engine.generate(prompts, max_new_tokens=32) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    check(np.array_equal(runs[0].tokens, runs[1].tokens), "two greedy calls differ")
    check(runs[0].tokens.shape == (4, 32), f"tokens {runs[0].tokens.shape}")
    step_bound_ms = weight_bytes / H100_BYTES_PER_S * 1e3
    gens = []
    for i, r in enumerate(runs):
        step_ms = r.decode_seconds / (r.steps - 1) * 1e3
        gens.append({"prefill_ms": r.prefill_seconds * 1e3,
                     "decode_ms": r.decode_seconds * 1e3, "decode_step_ms": step_ms,
                     "decode_tok_s": r.decode_tokens_per_second})
        print(f"qwen2-7b call {i + 1}: prefill (4 x 128) {r.prefill_seconds * 1e3:.1f} ms; "
              f"decode {r.steps} tokens in {r.decode_seconds * 1e3:.1f} ms "
              f"({step_ms:.2f} ms a step, {r.decode_tokens_per_second:.1f} tok/s)")
    print(f"qwen2-7b: {n_params / 1e9:.3f} B parameters, {weight_bytes / 1e9:.2f} GB bf16 "
          f"(drawn in {init_s:.2f} s); peak memory {(peak - held) / 1e9:.2f} GB above the "
          f"{held / 1e9:.2f} GB the earlier phases hold ({peak / 2 ** 30:.2f} GiB in all); "
          f"weight-streaming bound {step_bound_ms:.2f} ms a step = "
          f"{4 / step_bound_ms * 1e3:.0f} tok/s at batch 4")
    prof = profile_decode(engine.params, cfg, prompts, "qwen2-7b")
    out["full"] = {"params": n_params, "weight_bytes": weight_bytes, "init_s": init_s,
                   "peak_bytes": peak, "held_before_bytes": held,
                   "step_bound_ms": step_bound_ms, "calls": gens,
                   "first_row": runs[0].tokens[0, :16].tolist(),
                   "profiled_step": prof}
    del engine, params, tensors
    torch.cuda.empty_cache()

    # (b), (c): two layers at full width against CPU copies of the weights.
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = M.init_params(cfg2, torch.Generator(device="cuda").manual_seed(SEED + 2),
                       "cuda", torch.bfloat16)
    p2_cpu = M.tree_map(lambda t: t.cpu(), p2)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(SEED + 3))
    rtol = mode_tolerance(relaxed)

    def compare(z, z_cpu, what):
        check(bool(torch.isfinite(z).all()), f"{what}: non-finite logits")
        limit = rtol * z_cpu.abs().amax(-1).clamp_min(1.0)
        d = (z.float().cpu() - z_cpu).abs().amax(-1)
        check(bool((d <= limit).all()), f"{what}: logits differ by "
              f"{(d / limit).max().item():.3g} of the limit")
        top2 = z_cpu.topk(2, dim=-1).values
        lead = top2[:, 0] - top2[:, 1] > limit
        check(bool((z.float().cpu().argmax(-1) == z_cpu.argmax(-1))[lead].all()),
              f"{what}: greedy token differs where the CPU leads by more than the limit")
        return float((d / limit).max()), int(lead.sum())

    def lockstep(window_override):
        kw = dict(mode=relaxed, window_override=window_override)
        with torch.inference_mode():
            z, caches = M.prefill(p2, toks.cuda(), cfg2, capacity=20, **kw)
            z_cpu, caches_cpu = M.prefill(p2_cpu, toks, cfg2, capacity=20, **kw)
            if window_override:
                check(all(c.capacity == window_override for c in caches),
                      "the windowed cache is not a ring of the window's size")
            worst = [compare(z, z_cpu, f"prefill (window {window_override})")]
            for step in range(4):
                nxt = z_cpu.argmax(-1, keepdim=True)      # the CPU's greedy token
                z, caches = M.decode_step(p2, caches, nxt.cuda(), 16 + step, cfg2, **kw)
                z_cpu, caches_cpu = M.decode_step(p2_cpu, caches_cpu, nxt, 16 + step,
                                                  cfg2, **kw)
                worst.append(compare(z, z_cpu, f"decode step {step} "
                                               f"(window {window_override})"))
        return worst

    for label, wo in (("two_layers", 0), ("ring_window_8", 8)):
        t0 = time.perf_counter()
        worst = lockstep(wo)
        out[label] = {"worst_of_limit": [w for w, _ in worst],
                      "greedy_checked": [n for _, n in worst],
                      "seconds": time.perf_counter() - t0}
        print(f"qwen2-7b 2 layers, window {wo or 'none'}: card vs CPU copy, prefill + 4 "
              f"decode steps, largest |dlogit| "
              f"{max(w for w, _ in worst):.3f} of the limit (RELAXED, {rtol} x row max), "
              f"greedy equal on {sum(n for _, n in worst)} clear rows "
              f"({out[label]['seconds']:.1f} s)")
    del p2, p2_cpu
    torch.cuda.empty_cache()

    # (d) the launcher, as a user runs it.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-7b"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src")))
    print(f"launch.serve --arch qwen2-7b: rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.splitlines()[:4]:
        print(f"  {line}")
    check(proc.returncode == 0, f"launch.serve exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    out["launch_serve_stdout"] = proc.stdout
    return out


#: Phase 11's configs at full width: (name, layers kept (0 = all), why the
#: depth is cut).  The last two do not fit one card whole (181 GB and 470 GB
#: of bf16 weights against 80 GB).
LM_FAMILIES = [
    ("granite-moe-1b-a400m", 0, ""),
    ("hymba-1.5b", 0, ""),
    ("xlstm-350m", 0, ""),
    ("whisper-small", 0, ""),
    ("llama-3.2-vision-90b", 5, "one pattern period of 5 of 100 layers (181 GB whole)"),
    ("qwen3-moe-235b-a22b", 2, "2 of 94 layers (470 GB whole)"),
]
#: Phase 11(d)'s copies against the CPU: (name, decoder layers, encoder layers).
LM_LOCKSTEP = [("granite-moe-1b-a400m", 2, 0), ("hymba-1.5b", 2, 0),
               ("xlstm-350m", 2, 0), ("whisper-small", 2, 2)]


def lm_aux(cfg, batch, seed, device):
    """Encoder frames or image tokens (B, S_aux, d) drawn from ``seed``, or
    None for a config without ``cross`` layers."""
    import torch
    n = cfg.encoder_seq or cfg.num_image_tokens
    if not n:
        return None
    return torch.randn((batch, n, cfg.d_model), device=device,
                       generator=torch.Generator(device=device).manual_seed(seed))


class RouteReplay:
    """Phase 11(d)'s hold on MoE routing.  The top-k choice is
    discontinuous: bf16 rounding that differs between the card and the CPU
    can swap two experts whose probabilities nearly tie, and the outputs
    then differ by far more than any tolerance.  Inside ``with``, the first
    run records each ``moe.route`` call's probabilities and choices; after
    :meth:`start_replay`, a run takes the recorded choices in the same
    order, with its own probabilities at them (renormalized) as gate
    weights, and its own choices are kept for :meth:`check_flips`."""

    def __init__(self, moe_module):
        self.moe, self.orig = moe_module, moe_module.route
        self.recorded, self.own, self.replaying, self.i = [], [], False, 0

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def start_replay(self):
        self.replaying, self.i = True, 0

    def __call__(self, router_w, x, num_experts, top_k, mode):
        import torch
        top_p, top_i, probs = self.orig(router_w, x, num_experts, top_k, mode)
        if not self.replaying:
            self.recorded.append((probs.float().cpu(), top_i.cpu()))
            return top_p, top_i, probs
        ref_probs, ref_i = self.recorded[self.i]
        self.i += 1
        self.own.append((probs.float().cpu(), top_i.cpu(), ref_probs, ref_i))
        ti = ref_i.to(x.device)
        tp = probs.gather(1, ti)
        return tp / torch.clamp(tp.sum(-1, keepdim=True), min=1e-9), ti, probs

    def check_flips(self) -> list:
        """Every replayed run made as many route calls as the recorded one,
        and wherever a run's own router chose another set of experts, the
        recorded run's k-th choice led its (k+1)-th by at most twice the
        largest difference between the two runs' probabilities in that
        row: a near-tie that rounding can swap.  Returns the number of such
        rows in each replayed run."""
        import torch
        if not self.own:
            return []
        n = len(self.recorded)
        check(len(self.own) % n == 0, "a replayed run made another number of route calls")
        flips = [0] * (len(self.own) // n)
        for j, (probs, top_i, ref_probs, ref_i) in enumerate(self.own):
            k = ref_i.shape[1]
            differ = (torch.sort(top_i, -1).values != torch.sort(ref_i, -1).values).any(-1)
            srt = torch.sort(ref_probs, -1, descending=True).values
            gap = srt[:, k - 1] - srt[:, k]
            noise = (probs - ref_probs).abs().amax(-1)
            check(bool((gap[differ] <= 2 * noise[differ]).all()),
                  "a router chose other experts where the recorded choice led clearly")
            flips[j // n] += int(differ.sum())
        return flips


def phase11(repo: str) -> dict:
    """Phase 11: the MoE, hybrid-SSM, xLSTM and cross-attention families
    (see the module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ComputeMode, mode_tolerance
    from repro_torch.nn import model as M
    from repro_torch.nn import moe
    from repro_torch.serving import ServingEngine

    relaxed = ComputeMode.RELAXED
    out: dict = {}

    # (a)-(c): each family through ServingEngine.generate at full width.
    for name, layers, cut in LM_FAMILIES:
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                               "cuda", torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = list(M.tree_leaves(params))
        n_params = sum(t.numel() for t in leaves)
        check(n_params == M.num_params(cfg), f"{name}: parameter count")
        weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
        # What a decode step reads: every weight but the encoder's.
        enc_bytes = sum(t.numel() * t.element_size() for t in M.tree_leaves(
            [params.get("enc_layers", []), params.get("enc_final_norm", [])]))
        step_bytes = weight_bytes - enc_bytes
        active_bytes = step_bytes - 2 * (M.num_params(cfg) - M.active_params(cfg))
        aux = lm_aux(cfg, 4, SEED + 4, "cuda")
        engine = ServingEngine(cfg, params, max_context=160, mode=relaxed, device="cuda")
        prompts = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
        runs = [engine.generate(prompts, max_new_tokens=32, aux=aux) for _ in range(2)]
        peak = torch.cuda.max_memory_allocated()
        check(runs[0].tokens.shape == (4, 32), f"{name}: tokens {runs[0].tokens.shape}")
        check(bool(((runs[0].tokens >= 0) & (runs[0].tokens < cfg.vocab_size)).all()),
              f"{name}: a token outside the vocabulary")
        check(np.array_equal(runs[0].tokens, runs[1].tokens),
              f"{name}: two greedy calls differ")
        bound_ms = step_bytes / H100_BYTES_PER_S * 1e3
        active_bound_ms = active_bytes / H100_BYTES_PER_S * 1e3
        calls = []
        for i, r in enumerate(runs):
            step_ms = r.decode_seconds / (r.steps - 1) * 1e3
            calls.append({"prefill_ms": r.prefill_seconds * 1e3,
                          "decode_ms": r.decode_seconds * 1e3, "decode_step_ms": step_ms,
                          "decode_tok_s": r.decode_tokens_per_second})
            print(f"{name} call {i + 1}: prefill (4 x 128) {r.prefill_seconds * 1e3:.1f} ms; "
                  f"decode {r.steps} tokens in {r.decode_seconds * 1e3:.1f} ms "
                  f"({step_ms:.2f} ms a step, {r.decode_tokens_per_second:.1f} tok/s)")
        depth = f"{cfg.num_layers} layers" + (f" (depth cut: {cut})" if cut else " (full depth)")
        if cfg.is_encoder_decoder:
            depth += f" + {cfg.encoder_layers} encoder layers over {cfg.encoder_seq} frames"
        elif cfg.num_image_tokens:
            depth += f", {cfg.num_image_tokens} image tokens"
        moe_note = (f"; active weights {active_bytes / 1e9:.2f} GB, bound "
                    f"{active_bound_ms:.2f} ms" if cfg.moe is not None else "")
        print(f"{name}: {depth}; {n_params / 1e9:.3f} B parameters ({M.active_params(cfg) / 1e9:.3f} B "
              f"active), {weight_bytes / 1e9:.2f} GB bf16 (drawn in {init_s:.2f} s); peak "
              f"memory {(peak - held) / 1e9:.2f} GB above the {held / 1e9:.2f} GB held before; "
              f"weight-streaming bound of a decode step {step_bytes / 1e9:.2f} GB = "
              f"{bound_ms:.2f} ms{moe_note}", flush=True)
        entry = {"layers": cfg.num_layers, "depth_cut": cut, "params": n_params,
                 "active_params": M.active_params(cfg), "weight_bytes": weight_bytes,
                 "step_weight_bytes": step_bytes, "init_s": init_s, "peak_bytes": peak,
                 "held_before_bytes": held, "step_bound_ms": bound_ms,
                 "active_step_bound_ms": active_bound_ms if cfg.moe is not None else None,
                 "calls": calls, "first_row": runs[0].tokens[0, :16].tolist()}
        if name == "granite-moe-1b-a400m":
            entry["profiled_step"] = profile_decode(engine.params, cfg, prompts, name)
        out[name] = entry
        del engine, params, leaves, aux
        torch.cuda.empty_cache()

    # (d) Full width, cut in depth, on the card against CPU copies.
    rtol = mode_tolerance(relaxed)
    for name, layers, enc_layers in LM_LOCKSTEP:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), num_layers=layers,
                                  encoder_layers=enc_layers)
        p = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 2),
                          "cuda", torch.bfloat16)
        p_cpu = M.tree_map(lambda t: t.cpu(), p)
        toks = torch.randint(0, cfg.vocab_size, (2, 16),
                             generator=torch.Generator().manual_seed(SEED + 3))
        aux_cpu = lm_aux(cfg, 2, SEED + 5, "cpu")
        aux = None if aux_cpu is None else aux_cpu.cuda()
        replay = RouteReplay(moe)

        def run(params, tokens, aux_kv, mode, feed=None):
            """Prefill 16 tokens and 4 decode steps; the token fed at each
            step is ``feed``'s, else the run's own greedy one.  Returns the
            f32 CPU logits of each call and the tokens fed."""
            with torch.inference_mode():
                z, caches = M.prefill(params, tokens, cfg, capacity=20, aux=aux_kv,
                                      mode=mode)
                zs, fed = [z.float().cpu()], []
                for step in range(4):
                    nxt = (zs[-1].argmax(-1, keepdim=True) if feed is None
                           else feed[step]).to(tokens.device)
                    fed.append(nxt.cpu())
                    z, caches = M.decode_step(params, caches, nxt, 16 + step, cfg, mode=mode)
                    zs.append(z.float().cpu())
            return zs, fed

        with replay:
            z_cpu, fed = run(p_cpu, toks, aux_cpu, relaxed)
            replay.start_replay()
            z_card, _ = run(p, toks.cuda(), aux, relaxed, feed=fed)
            replay.start_replay()
            z_exact, _ = run(p_cpu, toks, aux_cpu, ComputeMode.PRECISE, feed=fed)
        flips = replay.check_flips() or [0, 0]
        row_err = lambda a, b: float(((a - b).abs() / b.abs().amax(-1, keepdim=True)
                                      .clamp_min(1.0)).max())
        # For scale: the CPU copy's own RELAXED error against its PRECISE run.
        e_cpu = max(row_err(a, b) for a, b in zip(z_cpu, z_exact))
        dropped = []
        if cfg.moe is not None:
            n = toks.numel()
            cap = moe.expert_capacity(n, toks.shape[1], cfg.moe)
            dropped = [int((~moe.assign_slots(top_i, cfg.moe.num_experts, cap)[1]).sum())
                       for _, top_i in replay.recorded if top_i.shape[0] == n]
        worst, clear = [], 0
        for step, (zc, zh) in enumerate(zip(z_card, z_cpu)):
            what = f"{name} {'prefill' if step == 0 else f'decode step {step - 1}'}"
            check(bool(torch.isfinite(zc).all()), f"{what}: non-finite logits")
            limit = rtol * zh.abs().amax(-1, keepdim=True).clamp_min(1.0)
            d = (zc - zh).abs()
            check(bool((d <= limit).all()),
                  f"{what}: logits differ by {(d / limit).max().item():.3g} of the limit "
                  f"(the CPU copy's RELAXED strays {e_cpu:.4f} from its PRECISE)")
            top2 = zh.topk(2, dim=-1).values
            lead = (top2[:, 0] - top2[:, 1]) > limit[:, 0]
            check(bool((zc.argmax(-1) == zh.argmax(-1))[lead].all()),
                  f"{what}: greedy token differs where the CPU leads by more than the limit")
            worst.append(float((d / limit).max()))
            clear += int(lead.sum())
        if cfg.moe is not None:
            check(len(dropped) == layers and sum(dropped) > 0,
                  f"{name}: no pair was dropped at prefill ({dropped})")
        entry = {"layers": layers, "encoder_layers": enc_layers,
                 "worst_of_mode_tolerance": worst, "cpu_relaxed_vs_precise": e_cpu,
                 "greedy_checked": clear, "moe_dropped_at_prefill": dropped,
                 "own_routes_differing": {"card_relaxed": flips[0],
                                          "cpu_precise": flips[1]},
                 "seconds": time.perf_counter() - t0}
        out[f"{name}_vs_cpu"] = entry
        print(f"{name} {layers} layers{f' + {enc_layers} encoder layers' if enc_layers else ''} "
              f"at full width: card vs CPU copy, prefill + 4 decode steps, largest |dlogit| "
              f"{max(worst):.3f} of the limit (mode_tolerance(RELAXED) x row max; the CPU "
              f"copy's own RELAXED logits stray {e_cpu:.4f} of the row max from its "
              f"PRECISE ones); greedy equal on {clear} clear rows"
              + (f"; pairs dropped at prefill per layer {dropped}; held to the CPU "
                 f"copy's expert choices, the card's own router chose others for "
                 f"{flips[0]} token route(s) and the PRECISE run's for {flips[1]}, each "
                 f"at a near-tie" if cfg.moe is not None else "")
              + f" ({entry['seconds']:.1f} s)", flush=True)
        del p, p_cpu
        torch.cuda.empty_cache()

    # (e) The launcher in child processes, all at once.
    cmds = [["--arch", "granite-moe-1b-a400m"]] + [
        ["--arch", n, "--layers", "2", "--d-model", "256"]
        for n in ("qwen3-moe-235b-a22b", "hymba-1.5b", "xlstm-350m", "whisper-small",
                  "llama-3.2-vision-90b")]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve"] + c,
                              cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for c in cmds]
    results = []
    try:
        for c, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate(timeout=600)
            results.append((c, proc.returncode, stdout, stderr))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"launch.serve, {len(cmds)} child processes at once: "
          f"{time.perf_counter() - t0:.1f} s")
    out["launch_serve"] = []
    for c, rc, stdout, stderr in results:
        print(f"  {' '.join(c)}: rc {rc}; {' | '.join(stdout.splitlines()[:2])}")
        check(rc == 0, f"launch.serve {' '.join(c)} exited {rc}: {stderr[-2000:]}")
        out["launch_serve"].append({"args": c, "rc": rc, "stdout": stdout})
    return out


#: Phase 12's Qwen2-7B training run: 8 of its 28 layers, cut for memory
#: only (f32 params, gradients and both AdamW moments take 16 bytes a
#: parameter: 121.8 GB for the whole model against the card's 80 GB; 47.3 GB
#: at 8 layers).
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
#: Timed steps, after one warm-up step; then one profiled step and the
#: checkpoint's resume step.
TRAIN_TIMED = 3
#: Card against CPU (the 2-layer copy, one sequence of 64 tokens), PRECISE
#: with TF32 turned on outside mode_dot: the loss within rtol 1e-5 and each
#: gradient leaf within a relative L2 error of 1e-4 of the CPU's (f32 sums
#: taken in another order: a few 1e-6; one TF32 product would give ~1e-3).
#: The RELAXED loss within mode_tolerance(RELAXED).
TRAIN_PRECISE_L2 = 1e-4
TRAIN_PRECISE_LOSS_RTOL = 1e-5
#: The params after one adamw_update from zero moments, card vs CPU, each
#: leaf's relative L2 error.  A first AdamW step moves each element by
#: lr * g / (|g| + 1e-8): where a leaf's gradients sit near 1e-8 (the key
#: bias's, ~2e-8, nearly invariant under the softmax), it passes their
#: per-element error (not their leaf-wide 1e-6) straight through: 9.8e-4
#: measured on an H100.  The card's AdamW on the card's gradients against
#: the CPU's AdamW on the same gradients: f32 elementwise, 1e-6.
TRAIN_ADAMW_L2 = 1e-2
TRAIN_ADAMW_SAME_L2 = 1e-6
#: Phase 12(d): whole, at full width, two steps each at batch 4 x 512.
TRAIN_FAMILIES = ["granite-moe-1b-a400m", "hymba-1.5b", "xlstm-350m", "whisper-small"]


def _train_batches(cfg, batch, seq, steps, device):
    """The launcher's batches (``lm_batches(SEED, ...)``, zero frames or
    image tokens for a config with ``cross`` layers) through
    ``DataPipeline``."""
    from repro_torch.data import DataPipeline
    from repro_torch.launch.train import train_batches
    return DataPipeline(train_batches(cfg, batch, seq, steps, SEED), device=device)


def _trainable(params):
    from repro_torch.nn import model as M
    for leaf in M.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _timed_step(step_fn, params, opt, batch):
    """One ``train_step``: (params, opt, loss, host-clock ms to a
    synchronize, CUDA-event ms)."""
    import torch
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    params, opt, loss = step_fn(params, opt, batch)
    b.record()
    b.synchronize()
    return params, opt, float(loss), (time.perf_counter() - t0) * 1e3, a.elapsed_time(b)


def _rel_l2(a, b) -> float:
    import torch
    a, b = a.detach().float().cpu(), b.detach().float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def train_child(tmp: str, out_path: str) -> None:
    """Phase 12 (a)-(d) in a fresh process (see the module docstring);
    writes its results as JSON to ``out_path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.precision import ComputeMode, mode_tolerance
    from repro_torch.launch.specs import make_train_step
    from repro_torch.nn import model as M
    from repro_torch.nn import moe
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule

    relaxed, precise = ComputeMode.RELAXED, ComputeMode.PRECISE
    gen = lambda seed, dev="cuda": torch.Generator(device=dev).manual_seed(seed)
    out: dict = {}

    # (a) Qwen2-7B at full width, 8 of its 28 layers.
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=TRAIN_LAYERS)
    check((cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size)
          == (3584, 28, 4, 18944, 152064), "qwen2-7b widths")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _trainable(M.init_params(cfg, gen(SEED), "cuda", torch.float32))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    check(n_params == M.num_params(cfg), "parameter count")
    non_embed = n_params - params["embed"].numel()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_fn = make_train_step(cfg, relaxed)
    batches = _train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED + 3, "cuda")
    steps = []
    for i in range(TRAIN_TIMED + 1):
        params, opt, loss, host_ms, event_ms = _timed_step(step_fn, params, opt, next(batches))
        check(np.isfinite(loss), f"qwen2-7b step {i}: loss {loss}")
        steps.append({"loss": loss, "host_ms": host_ms, "event_ms": event_ms})
        print(f"qwen2-7b train step {i}{' (warm-up)' if i == 0 else ''}: loss {loss:.4f}, "
              f"{host_ms:.1f} ms on the host clock, {event_ms:.1f} ms between CUDA events",
              flush=True)
    step_ms = statistics.median(s["host_ms"] for s in steps[1:])
    event_ms = statistics.median(s["event_ms"] for s in steps[1:])

    # One profiled step, split by CUDA events into the three calls a
    # train_step makes: loss_fn (the forward), autograd.grad (each layer
    # recomputed, then its backward) and adamw_update.
    batch = next(batches)
    leaves = list(M.tree_leaves(params))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        loss = M.loss_fn(params, batch["tokens"], batch["labels"], cfg, mode=relaxed)
        ev[1].record()
        grads = iter(torch.autograd.grad(loss, leaves))
        ev[2].record()
        lr = cosine_schedule(opt.step, peak_lr=3e-4, warmup=100, total=10000)
        params, opt = adamw_update(M.tree_map(lambda _: next(grads), params), opt,
                                   params, lr=lr)
        ev[3].record()
        ev[3].synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    del grads
    split = {name: ev[i].elapsed_time(ev[i + 1])
             for i, name in enumerate(("forward", "backward", "optimizer"))}
    cuda_events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in cuda_events) / 1e3
    n_kernels = sum(e.count for e in cuda_events)
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in cuda_events),
                 key=lambda kv: -kv[1])[:8]
    check(busy_ms > 0, "the profiler saw no device time in the training step")
    check(np.isfinite(float(loss.detach())), "profiled step: loss")
    peak = torch.cuda.max_memory_allocated()
    # The bound: the operations the step runs, 6 x non-embedding params x
    # tokens plus the forward again (each layer and loss chunk is
    # recomputed), at the bf16 peak; the f32 AdamW reads p, g, m, v and
    # writes p, m, v.  Utilization counts the model's operations only
    # (6 x, no recompute).
    ops = 8 * non_embed * tokens
    ops_ms = ops / H100_BF16_FLOPS * 1e3
    model_ops_ms = 6 * non_embed * tokens / H100_BF16_FLOPS * 1e3
    adamw_bytes = 7 * 4 * n_params
    adamw_ms = adamw_bytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, adamw_ms)
    print(f"qwen2-7b training, {TRAIN_LAYERS} of 28 layers at full width, {n_params / 1e9:.3f} B "
          f"f32 parameters (drawn in {init_s:.2f} s), batch {TRAIN_BATCH} x {TRAIN_SEQ}, RELAXED: "
          f"step {step_ms:.1f} ms on the host clock ({event_ms:.1f} ms between CUDA events; "
          f"median of {TRAIN_TIMED} after a warm-up), {tokens / step_ms * 1e3:.0f} tokens/s; "
          f"peak memory {peak / 1e9:.2f} GB; bound {bound_ms:.1f} ms (operations "
          f"{ops / 1e12:.1f} TFLOP = {ops_ms:.1f} ms at the bf16 peak; AdamW {adamw_bytes / 1e9:.1f} "
          f"GB = {adamw_ms:.1f} ms; the two in series {ops_ms + adamw_ms:.1f} ms); the step is "
          f"{step_ms / bound_ms:.2f}x the bound; model operations alone (6 x, no recompute) "
          f"{model_ops_ms:.1f} ms: utilization {model_ops_ms / step_ms:.1%}", flush=True)
    print(f"  profiled step: {prof_wall_ms:.1f} ms on the host clock; forward "
          f"{split['forward']:.1f} ms, backward {split['backward']:.1f} ms, optimizer "
          f"{split['optimizer']:.1f} ms (CUDA events); device busy {busy_ms:.1f} ms "
          f"({busy_ms / prof_wall_ms:.1%}) over {n_kernels} kernels; top:", flush=True)
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {name[:90]}")
    out["qwen2_7b"] = {
        "layers": TRAIN_LAYERS, "params": n_params, "non_embedding_params": non_embed,
        "init_s": init_s, "steps": steps, "step_ms": step_ms, "step_event_ms": event_ms,
        "tokens_per_s": tokens / step_ms * 1e3, "peak_bytes": peak,
        "bound_ms": bound_ms, "ops_ms": ops_ms, "adamw_ms": adamw_ms,
        "model_ops_ms": model_ops_ms, "utilization": model_ops_ms / step_ms,
        "profiled": {"wall_ms": prof_wall_ms, "split_ms": split, "device_busy_ms": busy_ms,
                     "kernels": n_kernels, "top": top}}

    # (b) Checkpoint and resume: save, one more step from the live state,
    # then load into a fresh tree (the live moments freed first: both
    # states would not fit the card) and the same step from it.
    batch = next(batches)
    path = os.path.join(tmp, "qwen2_7b_train.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, {"params": params, "opt": opt}, step=int(opt.step))
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    params, opt, loss_live, _, _ = _timed_step(step_fn, params, opt, batch)
    # The target gives keys and shapes only: meta tensors hold no memory.
    target = M.tree_map(lambda t: torch.empty(t.shape, device="meta"),
                        {"params": params, "opt": opt})
    del opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loaded, saved_step = load_checkpoint(path, target, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del target
    os.remove(path)
    check(saved_step == TRAIN_TIMED + 2, f"checkpoint step {saved_step}")
    resumed = _trainable(loaded["params"])
    resumed, _, loss_resumed, _, _ = _timed_step(step_fn, resumed, loaded["opt"], batch)
    same = all(torch.equal(a, b) for a, b in zip(M.tree_leaves(params), M.tree_leaves(resumed)))
    print(f"checkpoint: {size / 1e9:.1f} GB (params and AdamW state) saved in {save_s:.1f} s, "
          f"loaded in {load_s:.1f} s; the next step from the live state and from the loaded "
          f"one: losses {loss_live!r} and {loss_resumed!r}, parameters "
          f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
    check(loss_live == loss_resumed and same, "the resumed step differs from the live one")
    out["checkpoint"] = {"bytes": size, "save_s": save_s, "load_s": load_s,
                         "loss": loss_live, "bit_equal": same}
    del params, resumed, loaded, batches
    torch.cuda.empty_cache()

    # (c) The same width at 2 layers against the CPU: one sequence of 64.
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p_card = _trainable(M.init_params(cfg2, gen(SEED + 2), "cuda", torch.float32))
    p_cpu = _trainable(M.tree_map(lambda t: t.detach().to("cpu", copy=True), p_card))
    toks = torch.randint(0, cfg2.vocab_size, (1, 65), generator=gen(SEED + 3, "cpu"))
    x_cpu, y_cpu = toks[:, :-1], toks[:, 1:]
    with torch.no_grad():
        l_card = float(M.loss_fn(p_card, x_cpu.cuda(), y_cpu.cuda(), cfg2, mode=relaxed))
        l_cpu = float(M.loss_fn(p_cpu, x_cpu, y_cpu, cfg2, mode=relaxed))
    rtol = mode_tolerance(relaxed)
    check(abs(l_card - l_cpu) <= rtol * abs(l_cpu), f"RELAXED loss {l_card} vs {l_cpu}")

    def precise_grads(params, x, y):
        leaves = list(M.tree_leaves(params))
        loss = M.loss_fn(params, x, y, cfg2, mode=precise)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    def adamw_step(params, grads):
        """One adamw_update from zero moments at lr 3e-4, on a copy."""
        copy = M.tree_map(lambda t: t.detach().clone(), params)
        it = iter(grads)
        return list(M.tree_leaves(adamw_update(M.tree_map(lambda _: next(it), copy),
                                               adamw_init(copy), copy, lr=3e-4)[0]))

    # TF32 off, then on: every product of the loss and its backward runs in
    # full f32 either way, so the two must be bit-equal.
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        pl_off, g_off = precise_grads(p_card, x_cpu.cuda(), y_cpu.cuda())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        pl_card, g_card = precise_grads(p_card, x_cpu.cuda(), y_cpu.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    tf32_same = pl_off == pl_card and all(torch.equal(a, b) for a, b in zip(g_off, g_card))
    del g_off
    new_card = adamw_step(p_card, g_card)
    t0 = time.perf_counter()
    pl_cpu, g_cpu = precise_grads(p_cpu, x_cpu, y_cpu)
    new_cpu = adamw_step(p_cpu, g_cpu)
    cpu_s = time.perf_counter() - t0
    g_err = [_rel_l2(a, b) for a, b in zip(g_card, g_cpu)]
    p_err = [_rel_l2(a, b) for a, b in zip(new_card, new_cpu)]
    del new_cpu, g_cpu
    # The optimizer alone: the CPU's adamw_update on the card's gradients.
    opt_err = [_rel_l2(a, b) for a, b in zip(
        new_card, adamw_step(p_cpu, [g.cpu() for g in g_card]))]
    print(f"qwen2-7b 2 layers at full width ({sum(t.numel() for t in M.tree_leaves(p_cpu)) / 1e9:.3f} "
          f"B parameters), card vs CPU on 64 tokens: RELAXED loss {l_card:.6f} vs {l_cpu:.6f} "
          f"(rel {abs(l_card - l_cpu) / abs(l_cpu):.2e}, limit {rtol}); PRECISE with TF32 on "
          f"outside mode_dot: loss {pl_card:.7f} vs {pl_cpu:.7f} (rel "
          f"{abs(pl_card - pl_cpu) / abs(pl_cpu):.2e}, limit {TRAIN_PRECISE_LOSS_RTOL}), gradient "
          f"leaves' relative L2 error max {max(g_err):.2e} (median {statistics.median(g_err):.2e}, "
          f"limit {TRAIN_PRECISE_L2}); params after one AdamW step max {max(p_err):.2e} (median "
          f"{statistics.median(p_err):.2e}, limit {TRAIN_ADAMW_L2}), the card's AdamW against "
          f"the CPU's on the same gradients {max(opt_err):.2e} (limit {TRAIN_ADAMW_SAME_L2}); the "
          f"card's loss and gradients with TF32 on "
          f"{'bit-equal to' if tf32_same else 'DIFFERENT from'} those with it off "
          f"(CPU gradients and AdamW {cpu_s:.1f} s)", flush=True)
    check(tf32_same, "turning TF32 on changed a PRECISE loss or gradient on the card")
    check(abs(pl_card - pl_cpu) <= TRAIN_PRECISE_LOSS_RTOL * abs(pl_cpu), "PRECISE loss")
    check(max(g_err) <= TRAIN_PRECISE_L2, f"PRECISE gradients: {max(g_err):.3g}")
    check(max(p_err) <= TRAIN_ADAMW_L2, f"params after AdamW: {max(p_err):.3g}")
    check(max(opt_err) <= TRAIN_ADAMW_SAME_L2, f"AdamW on the card: {max(opt_err):.3g}")
    out["two_layers_vs_cpu"] = {
        "relaxed_loss": [l_card, l_cpu], "precise_loss": [pl_card, pl_cpu],
        "grad_rel_l2_max": max(g_err), "grad_rel_l2_median": statistics.median(g_err),
        "params_rel_l2_max": max(p_err), "adamw_same_grads_rel_l2_max": max(opt_err),
        "tf32_on_equals_off": tf32_same, "cpu_seconds": cpu_s}
    del p_card, p_cpu, g_card, new_card
    torch.cuda.empty_cache()

    # (d) The other families, whole, at full width: two steps each.
    out["families"] = {}
    for name in TRAIN_FAMILIES:
        fcfg = get_config(name)
        torch.cuda.reset_peak_memory_stats()
        params = _trainable(M.init_params(fcfg, gen(SEED), "cuda", torch.float32))
        before = M.tree_map(lambda t: t.detach().clone(), params)
        opt = adamw_init(params)
        step_fn = make_train_step(fcfg, relaxed)
        calls = []
        orig = moe.assign_slots

        def spy(top_idx, num_experts, capacity):
            slot, keep = orig(top_idx, num_experts, capacity)
            calls.append(int((~keep).sum()))
            return slot, keep
        moe.assign_slots = spy
        try:
            losses, times = [], []
            for batch in _train_batches(fcfg, 4, 512, 2, "cuda"):
                params, opt, loss, host_ms, ev_ms = _timed_step(step_fn, params, opt, batch)
                losses.append(loss)
                times.append(host_ms)
        finally:
            moe.assign_slots = orig
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"{name}: losses {losses}")
        finite = all(bool(torch.isfinite(t).all())
                     for t in M.tree_leaves([params, opt.mu, opt.nu]))
        check(finite, f"{name}: a parameter or moment is not finite")
        # AdamW moves a leaf whose gradient or value is nonzero.
        moving = [bool(torch.any(m != 0) or torch.any(b != 0))
                  for m, b in zip(M.tree_leaves(opt.mu), M.tree_leaves(before))]
        moved = [not torch.equal(a.detach(), b)
                 for a, b in zip(M.tree_leaves(params), M.tree_leaves(before))]
        check(all(m for m, should in zip(moved, moving) if should),
              f"{name}: a parameter with a gradient or a value did not move")
        n = sum(t.numel() for t in M.tree_leaves(params))
        entry = {"params": n, "losses": losses, "step_ms": times, "peak_bytes": peak,
                 "leaves_moved": sum(moved), "leaves": len(moved)}
        drops = ""
        if fcfg.moe is not None:
            # Per step: the forward's layers, then the backward's recompute
            # in reverse order; routing must be the same both times.
            L = fcfg.num_layers
            per_step = [calls[i * 2 * L:(i + 1) * 2 * L] for i in range(2)]
            check(len(calls) == 4 * L, f"{name}: {len(calls)} routing calls")
            check(all(s[:L] == s[L:][::-1] for s in per_step),
                  f"{name}: the recomputed routing dropped other pairs")
            entry["dropped_pairs"] = [sum(s[:L]) for s in per_step]
            drops = (f"; pairs dropped (capacity factor {fcfg.moe.capacity_factor}) "
                     f"{entry['dropped_pairs']} of {4 * 512 * fcfg.moe.top_k * L} per step, "
                     f"the same in each layer's recompute")
        print(f"{name} training, whole at full width ({n / 1e9:.3f} B f32 parameters, "
              f"{16 * n / 1e9:.1f} GB with gradients and moments), batch 4 x 512, RELAXED: "
              f"losses {', '.join(f'{l:.4f}' for l in losses)}; step "
              f"{', '.join(f'{t:.1f}' for t in times)} ms (host clock); peak memory "
              f"{peak / 1e9:.2f} GB; {sum(moved)} of {len(moved)} leaves moved{drops}",
              flush=True)
        out["families"][name] = entry
        del params, opt, before
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase12(repo: str) -> dict:
    """Phase 12: LM training (see the module docstring)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.nn import model as M
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train-", dir=os.path.join(repo, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    try:
        out_path = os.path.join(tmp, "train.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--train-child",
                               tmp, out_path], cwd=repo, capture_output=True, text=True,
                              timeout=900, env=env)
        print(proc.stdout, end="")
        check(proc.returncode == 0, f"the training process exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        with open(out_path) as f:
            out = json.load(f)
        out["child_seconds"] = time.perf_counter() - t0

        # (e) The reference launcher's own example, on the card.
        ckpt = os.path.join(tmp, "launch_train.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "xlstm-350m",
             "--layers", "2", "--d-model", "256", "--steps", "20", "--batch", "8",
             "--seq", "128", "--checkpoint", ckpt],
            cwd=repo, capture_output=True, text=True, timeout=600, env=env)
        wall = time.perf_counter() - t0
        print(f"launch.train --arch xlstm-350m --layers 2 --d-model 256 --steps 20: rc "
              f"{proc.returncode} in {wall:.1f} s")
        for line in proc.stdout.splitlines():
            print(f"  {line}")
        check(proc.returncode == 0, f"launch.train exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        final = [l for l in proc.stdout.splitlines() if l.startswith("final loss")]
        check(len(final) == 1, "launch.train printed no final loss")
        # The printed losses are of different batches: the check holds the
        # first batch fixed and compares the launcher's initial weights
        # (seed 0, drawn on the card) with the trained ones it saved.
        cfg = get_config("xlstm-350m").scaled_down(layers=2, d_model=256)
        initial = M.init_params(cfg, 0, "cuda", torch.float32)
        got, step = load_checkpoint(ckpt, {"params": initial}, device="cuda")
        check(step == 20 and all(a.shape == b.shape for a, b in zip(
            M.tree_leaves(got["params"]), M.tree_leaves(initial))), "launch.train's checkpoint")
        toks, labels = (torch.as_tensor(a.astype(np.int64), device="cuda")
                        for a in next(lm_batches(0, 8, 128, cfg.vocab_size, 20)))
        with torch.no_grad():
            before = float(M.loss_fn(initial, toks, labels, cfg))
            after = float(M.loss_fn(got["params"], toks, labels, cfg))
        print(f"  checkpoint read back: step {step}, {len(list(M.tree_leaves(got)))} leaves; "
              f"the first batch's loss {before:.4f} under the initial weights, {after:.4f} "
              f"under the trained ones")
        check(np.isfinite(after) and after < before,
              f"launch.train: the trained weights' loss {after} on the first batch is not "
              f"below the initial weights' {before}")
        out["launch_train"] = {"seconds": wall, "first_batch_loss": [before, after],
                               "stdout": proc.stdout}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: Phase 13: the dry run's predicted peak (its arguments plus its temp
#: bytes) within this share of the card's peak over the step.
MESH_PEAK_RTOL = 0.10
#: Phase 13(a): (arch, shape, pattern periods, dry run in a child process)
#: run for real on a one-card mesh at full width.  The dry run on a 1x1 mesh
#: chose them (PERF.md): whisper-small's prefill_32k is the least
#: prefill_32k peak (35.9 GB); no train_4k pair fits one card at its whole
#: batch of 256 x 4096 (the least, xlstm-350m's, is 85.5 GB), so the train
#: step is Qwen2-7B's on train_4k's sequences at 16 of them, what one data
#: rank of the 16x16 mesh holds (47.4 GB).
MESH_TRAIN_SHAPE = dict(seq_len=4096, global_batch=16, kind="train")
MESH_PAIRS = [("qwen2-7b", "decode_32k", 1, False), ("qwen2-7b", MESH_TRAIN_SHAPE, 1, False),
              ("whisper-small", "prefill_32k", 1, True)]
#: Phase 13(b): dry runs on the production meshes, in child processes:
#: (arch, shape, layers override or 0 for full depth, multi-pod).  Every
#: family and every step kind runs at least once.
MESH_CHILDREN = [("qwen2-7b", "decode_32k", 0, False), ("qwen2-7b", "decode_32k", 0, True),
                 ("qwen2-7b", "train_4k", 1, False), ("qwen2-7b", "train_4k", 1, True),
                 ("granite-moe-1b-a400m", "train_4k", 1, False),
                 ("qwen3-moe-235b-a22b", "prefill_32k", 1, False),
                 ("hymba-1.5b", "long_500k", 1, False),
                 ("xlstm-350m", "decode_32k", 1, False),
                 ("whisper-small", "decode_32k", 1, False),
                 ("llama-3.2-vision-90b", "decode_32k", 1, False),
                 ("gemma2-9b", "long_500k", 1, False),
                 ("qwen3-32b", "decode_32k", 1, False),
                 ("command-r-plus-104b", "decode_32k", 1, False)]
#: Phase 13(b): Qwen2-7B decode_32k at full depth, per device a step.  Its
#: K/V cache moves onto attention's head-dim split by all-to-all, so what
#: is still gathered is each new token's (the whole cache was 15.04 GB on
#: 16x16); the all-reduces (count, bytes) are the ones the dry run made
#: before the cache moved, on a "cuda" mesh.  (A "cpu" mesh's fake group
#: reads one more all-reduce, the final norm's 32 B, or 16 B on 2x16x16,
#: sum of squares.)
QWEN2_DECODE_GATHER_BYTES = 0.05e9
QWEN2_DECODE_ALL_REDUCE = {"16x16": (1849, 825_352_192),
                           "2x16x16": (1849, 412_676_096)}


def mesh_args(cfg, spec, device: str, seed: int):
    """Full-size arguments for ``spec`` (a ``build_lowering`` of ``cfg`` on
    meta shards) drawn on ``device`` from ``seed``: the parameters as
    ``init_params`` draws them, a decode cache and aux inputs normal x 0.5,
    token ids uniform; the AdamW state at step 50 (a nonzero learning
    rate)."""
    import torch

    from repro_torch.nn import model as M
    from repro_torch.optim import adamw_init
    g = torch.Generator(device=device).manual_seed(seed + 1)
    normal = lambda a: (torch.randn(tuple(a.shape), generator=g, device=device) * 0.5) \
        .to(a.dtype)
    ids = lambda a: torch.randint(0, cfg.vocab_size, tuple(a.shape), generator=g,
                                  device=device, dtype=a.dtype)
    params_spec = spec.args[0]
    dtype = next(iter(M.tree_leaves(params_spec))).dtype
    params = M.init_params(cfg, seed, device, dtype)
    if isinstance(spec.args[1], tuple) and hasattr(spec.args[1], "_fields") \
            and "mu" in spec.args[1]._fields:                       # train
        params = M.tree_map(lambda t: t.requires_grad_(True), params)
        opt = adamw_init(params)
        opt = opt._replace(step=torch.full((), 50, dtype=torch.int32, device=device))
        batch = {k: (ids(v) if k != "aux" else normal(v)) for k, v in spec.args[2].items()}
        return (params, opt, batch)
    if len(spec.args) == 4 and not isinstance(spec.args[1], torch.Tensor):  # decode
        return (params, M.tree_map(normal, spec.args[1]), ids(spec.args[2]), spec.args[3])
    return (params, ids(spec.args[1])) + tuple(normal(a) for a in spec.args[2:])


def mesh_pair(cfg, shape: str, mesh, device: str = "cuda", seed: int = SEED,
              dry=None, peak_rtol=MESH_PEAK_RTOL) -> dict:
    """Phase 13(a) for one pair on a one-device host ``mesh``: the step of
    ``build_lowering`` run for real on DTensors over arguments drawn on
    ``device``, against the plain step (no mesh, plain tensors) on the same
    arguments, and against ``dry`` (the dry run's JSON for the pair on a
    1x1 mesh; run in-process when None): argument bytes equal, the
    predicted peak within ``peak_rtol`` of the card's (measured from a
    reset, the arguments counted, nothing else held before the step; None:
    not held), the
    dry run's FLOPs equal a ``FlopCounterMode`` count of the real step, and
    the step's result bit-equal to the plain step's (logits; for a train
    step the loss and every parameter after AdamW)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import specs as SP
    from repro_torch.launch.dryrun import run_pair
    from repro_torch.nn import model as M
    from repro_torch.nn.sharding import activate_mesh
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spec = SP.build_lowering(cfg, shape, mesh)
    kind = (SP.SHAPES[shape] if isinstance(shape, str) else shape)["kind"]
    full = mesh_args(cfg, spec, device, seed)
    real_bytes = SP.argument_bytes(full)
    leaves = iter(list(M.tree_leaves(full)))

    def wrap(a):
        t = next(leaves)
        return DTensor.from_local(t, mesh, a.placements, run_check=False) \
            if isinstance(a, DTensor) else t
    sharded = M.tree_map(wrap, spec.args)
    if kind == "train":
        plain = M.tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad)
                           if isinstance(t, torch.Tensor) else t, full)
    else:
        plain = full
    out_plain = spec.fn(*plain)
    ref = ([out_plain[2]] + list(M.tree_leaves(out_plain[0])) if kind == "train"
           else [out_plain[0]])
    del out_plain
    sync()
    if cuda:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with activate_mesh(mesh):
        out = spec.fn(*sharded)
    sync()
    measured = (torch.cuda.max_memory_allocated() - base + real_bytes) if cuda else None
    got = ([out[2]] + list(M.tree_leaves(out[0])) if kind == "train" else [out[0]])
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    equal = all(torch.equal(local(a).detach(), b.detach()) for a, b in zip(got, ref))
    del out, got, ref
    # The count in a run of its own: FlopCounterMode decomposes the ops it
    # has no formula for (logsumexp), which moves their rounding.
    counter = FlopCounterMode(display=False)
    with activate_mesh(mesh), counter:
        spec.fn(*sharded)
    # The step's time on the card (its result discarded).
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    with activate_mesh(mesh):
        spec.fn(*sharded)
    if cuda:
        end.record()
        sync()
        ms = start.elapsed_time(end)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    if dry is None:
        dry = run_pair(cfg.name, shape, mesh=mesh, cfg=cfg)
    predicted = dry["memory"]["argument_bytes"] + dry["memory"]["temp_bytes"]
    res = {"arch": cfg.name, "shape": shape if isinstance(shape, str) else kind,
           "layers": cfg.num_layers,
           "argument_bytes": real_bytes, "dry_argument_bytes": dry["memory"]["argument_bytes"],
           "predicted_peak_bytes": predicted, "measured_peak_bytes": measured,
           "flops": float(counter.get_total_flops()), "dry_flops": dry["flops_per_device"],
           "bit_equal": equal, "step_ms": ms, "dry_seconds": dry["lower_seconds"]}
    print(f"  {cfg.name} {res['shape']} at {cfg.num_layers} layers on a 1x1 mesh: step "
          f"{ms:.1f} ms; "
          f"arguments {real_bytes / 1e9:.3f} GB (dry run {res['dry_argument_bytes'] / 1e9:.3f}); "
          f"peak predicted {predicted / 1e9:.3f} GB, measured "
          + (f"{measured / 1e9:.3f} GB" if measured is not None else "n/a")
          + f"; FLOPs {res['flops']:.4g} (dry run {res['dry_flops']:.4g}); "
          f"bit-equal to the plain step: {equal}")
    check(real_bytes == res["dry_argument_bytes"],
          f"{cfg.name} {shape}: argument bytes {real_bytes} != the dry run's "
          f"{res['dry_argument_bytes']}")
    if measured is not None and peak_rtol is not None:
        check(abs(predicted - measured) <= peak_rtol * measured,
              f"{cfg.name} {shape}: predicted peak {predicted} vs measured {measured}")
    check(res["flops"] == res["dry_flops"],
          f"{cfg.name} {shape}: FlopCounterMode {res['flops']} != dry run {res['dry_flops']}")
    check(equal, f"{cfg.name} {shape}: the mesh step is not bit-equal to the plain step")
    return res


def _dryrun_cmd(arch, shape, layers, multipod, out, mesh=""):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--json", out, "--device", "cuda"]
    if layers:
        cmd += ["--layers-override", str(layers)]
    if multipod:
        cmd.append("--multipod")
    if mesh:
        cmd += ["--mesh", mesh]
    return cmd


def phase13(repo: str) -> dict:
    """Phase 13: the mesh and dry-run tools (see the module docstring)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import apply_layers_override
    from repro_torch.launch.mesh import make_host_mesh
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh-", dir=os.path.join(repo, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out: dict = {"card": card_line()}
    procs = {}
    try:
        # The dry runs start first, each in a child process on the fake
        # group: (b)'s on the production meshes, and (a)'s train and
        # prefill pairs on a 1x1 mesh (the decode pair's runs in this
        # process, on the card's own mesh).
        t0 = time.perf_counter()
        for arch, shape, layers, mp in MESH_CHILDREN:
            tag = f"{arch}.{shape}.{'2x16x16' if mp else '16x16'}.g{layers}"
            path = os.path.join(tmp, tag + ".json")
            procs[tag] = (subprocess.Popen(_dryrun_cmd(arch, shape, layers, mp, path),
                                           cwd=repo, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True), path)
        for arch, shape, layers, _ in [p for p in MESH_PAIRS if p[3]]:
            tag = f"{arch}.{shape}.1x1.g{layers}"
            path = os.path.join(tmp, tag + ".json")
            procs[tag] = (subprocess.Popen(_dryrun_cmd(arch, shape, layers, False, path,
                                                       mesh="1x1"),
                                           cwd=repo, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True), path)

        def collect(tag):
            proc, path = procs.pop(tag)
            stdout, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"dry run {tag} exited {proc.returncode}: "
                  f"{stdout[-3000:]} {err[-2000:]}")
            with open(path) as f:
                res = json.load(f)
            check(res["status"] == "ok", f"dry run {tag}: {res}")
            return res

        # (a) One-card mesh: a real process group of one rank.
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh(data=1, model=1, device_type="cuda")
            pairs = []
            for arch, shape, layers, child in MESH_PAIRS:
                cfg = apply_layers_override(get_config(arch), layers)
                dry = collect(f"{arch}.{shape}.1x1.g{layers}") if child else None
                pairs.append(mesh_pair(cfg, shape, mesh, dry=dry))
                torch.cuda.empty_cache()
            out["one_card"] = pairs
        finally:
            dist.destroy_process_group()

        # (b) The production meshes.
        children = []
        for tag in list(procs):
            res = collect(tag)
            mem = res["memory"]
            coll = ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e9:.3f} GB"
                             for k, v in sorted(res["collectives"].items()))
            print(f"  dry run {tag}: per device arguments {mem['argument_bytes'] / 1e9:.3f} GB, "
                  f"temp {mem['temp_bytes'] / 1e9:.3f} GB, {res['flops_per_device']:.4g} FLOPs; "
                  f"{coll}; {res['lower_seconds']} s")
            children.append(dict(res, tag=tag))
            if tag.startswith("qwen2-7b.decode_32k.") and tag.endswith(".g0"):
                c, mesh_name = res["collectives"], tag.split(".")[2]
                check(c.get("all-gather", {"bytes": 0})["bytes"] < QWEN2_DECODE_GATHER_BYTES,
                      f"dry run {tag}: all-gather {c.get('all-gather')} not under "
                      f"{QWEN2_DECODE_GATHER_BYTES / 1e9} GB a device")
                check("all-to-all" in c, f"dry run {tag}: no all-to-all in {c}")
                ar = c.get("all-reduce", {})
                check((ar.get("count"), ar.get("bytes")) == QWEN2_DECODE_ALL_REDUCE[mesh_name],
                      f"dry run {tag}: all-reduce {ar}, not "
                      f"{QWEN2_DECODE_ALL_REDUCE[mesh_name]}")
        out["production"] = children
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        for proc, _ in procs.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


#: ConvNeXt-T's LayerNorm inputs at batch 8: (C, H x W of the plane, or 0
#: for the pooled vector) -> layers of that shape, by ``infer_shapes``.
LN_SHAPES = ((96, 56), (192, 28), (384, 14), (768, 7), (768, 0))


def phase14(repo: str) -> dict:
    """Phase 14: the channel LayerNorm kernel (see the module docstring)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.cnn import convnext_t, infer_shapes, init_network_params
    from repro_torch.core import PlannerConfig, synthesize
    from repro_torch.kernels.layernorm import layernorm_nchw, layernorm_nchw_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    net = convnext_t()
    shapes = infer_shapes(net)
    per_shape = {}
    for l in net.layers:
        if l.kind == "layernorm":
            s = shapes[l.inputs[0]]
            key = (s[0], s[1] if len(s) == 3 else 0)
            per_shape[key] = per_shape.get(key, 0) + 1
    check(sorted(per_shape) == sorted(LN_SHAPES) and sum(per_shape.values()) == 23,
          f"ConvNeXt-T's LayerNorm shapes {per_shape}")
    rows, max_ulps = [], 0.0
    for c, hw in LN_SHAPES:
        shape = (8, c, hw, hw) if hw else (8, c)
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).bfloat16()
        w = torch.randn((c,), device=dev, generator=gen)
        b = torch.randn((c,), device=dev, generator=gen)
        got = layernorm_nchw(x, w, b, 1e-6)
        want = layernorm_nchw_plain(x, w, b, 1e-6)
        # Both round one f32 value x_hat * w + b to bf16, their sums taken in
        # another order: one bf16 ulp at the scale of the two terms (an
        # output near 0, where they cancel, is many of its own ulps off).
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        x_hat = (xf - mean) * torch.rsqrt((xf - mean).square().mean(dim=1, keepdim=True) + 1e-6)
        bc = (1, -1) + (1,) * (x.ndim - 2)
        terms = (x_hat * w.reshape(bc)).abs() + b.reshape(bc).abs()
        torch.cuda.synchronize()
        ulp = bf16_ulp(torch.maximum(terms, torch.maximum(got.float().abs(),
                                                          want.float().abs())))
        ulps = ((got.float() - want.float()).abs() / ulp).max().item()
        check(got.dtype == torch.bfloat16 and ulps <= 1.0,
              f"layernorm_nchw {shape}: {ulps} bf16 ulps from its plain version")
        max_ulps = max(max_ulps, ulps)
        perm = (0, 2, 3, 1) if hw else (0, 1)
        xp = x.permute(*perm).contiguous()
        nbytes = 2 * 2 * x.numel()                # bf16 in and out, once each
        r = {"shape": list(shape), "layers": per_shape[(c, hw)],
             "ms": graph_ms([lambda: layernorm_nchw(x, w, b, 1e-6)]),
             "plain_ms": graph_ms([lambda: layernorm_nchw_plain(x, w, b, 1e-6)]),
             "library_ms": graph_ms([lambda: F.layer_norm(xp, (c,), w.bfloat16(),
                                                          b.bfloat16(), 1e-6)]),
             "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "max_ulps": ulps}
        rows.append(r)
        print(f"  layernorm_nchw {'x'.join(map(str, shape)):14s} x{r['layers']:2d}: "
              f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} | library (permuted copy) "
              f"{r['library_ms']:.4f} | bound {r['bound_ms']:.5f} (bytes) | {ulps:.2f} ulps")

    # The main path: full-width ConvNeXt-T, its bucket of 8 one CUDA graph.
    params = init_network_params(net, SEED, "cuda")
    prog = synthesize(net, params, device="h100", planner_config=PlannerConfig(batch=8))
    layernorm_nchw.launches = 0
    bp = prog.for_batch(8)
    check(bp.captured, "ConvNeXt-T's for_batch(8) did not capture a CUDA graph")
    built = layernorm_nchw.launches
    check(built == 2 * 23, f"layernorm_nchw: {built} wrapper launches in the warm-up "
                           "and the capture, 46 expected")
    x8 = torch.randn((8, 3, 224, 224), device=dev, generator=gen)
    replays = 4
    outs = []
    dev_counts = device_launches(lambda: outs.extend(bp(x8) for _ in range(replays)),
                                 ["layernorm_nchw_kernel"])
    check(layernorm_nchw.launches == built, "a replay called the LayerNorm wrapper")
    check(dev_counts["layernorm_nchw_kernel"] == 23 * replays,
          f"layernorm_nchw_kernel launched {dev_counts['layernorm_nchw_kernel']} times "
          f"in {replays} replays, {23 * replays} expected "
          f"({dev_counts['cudaGraphLaunch']} cudaGraphLaunch calls)")
    check(all(torch.equal(o, outs[0]) for o in outs), "two replays of one input differ")
    check(torch.equal(outs[0], prog.infer(x8)), "the replay differs from the eager walk")
    print(f"ConvNeXt-T for_batch(8): {built} wrapper launches (warm-up and capture); "
          f"on the card in {replays} replays {dev_counts}; replay bit-equal to the eager walk")
    total = lambda k: sum(r[k] * r["layers"] for r in rows)
    entry = {"name": "layernorm_nchw", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/layernorm_nchw.cu",
             "replaces": None, "launches": built,
             "replay_launches_on_card": {"layernorm_nchw_kernel":
                                         dev_counts["layernorm_nchw_kernel"]},
             "max_ulps": max_ulps, "ms": total("ms"), "plain_ms": total("plain_ms"),
             "bound_ms": total("bound_ms"), "bound_by": "bytes",
             "library_ms": total("library_ms"),
             "shapes": "ConvNeXt-T's 23 LayerNorms at batch 8, RELAXED"}
    print(f"layernorm_nchw, ConvNeXt-T's 23 layers at batch 8: {entry['ms']:.4f} ms "
          f"(bound {entry['bound_ms']:.4f} ms, plain {entry['plain_ms']:.4f}, library "
          f"{entry['library_ms']:.4f}); at most {max_ulps:.2f} bf16 ulps from plain")
    del prog, bp, params
    torch.cuda.empty_cache()
    return {"per_shape": rows, "entry": entry}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--baseline", metavar="TREE",
                    help="an older checkout whose int8 kernels and int8 logits phase 5 "
                         "compares with this tree's, in this call")
    ap.add_argument("--probe-src", help=argparse.SUPPRESS)   # the child of --baseline
    ap.add_argument("--probe-out", help=argparse.SUPPRESS)
    ap.add_argument("--warm-child", nargs=3, help=argparse.SUPPRESS)  # phase 9's
    ap.add_argument("--train-child", nargs=2, help=argparse.SUPPRESS)  # phase 12's
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
    if args.warm_child:
        warmstart_child(*args.warm_child)
        return 0
    if args.train_child:
        train_child(*args.train_child)
        return 0
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
        lib_copies = cold_copies(wm8_cm)
        check(all(wc.stride() == (1, wc.shape[0]) for wc in lib_copies),
              "torch._int_mm's second operand is not column-major")
        lib_calls = [lambda wc=wc: torch._int_mm(a32, wc) for wc in lib_copies]
        kdim, ndim = wm8.shape
        flops = 2.0 * batch * kdim * ndim
        nbytes = batch * kdim + kdim * ndim + 2 * batch * ndim + 8 * ndim
        row("matmul_mapmajor_int8", name, batch, calls, plain, lib_calls, flops, nbytes,
            H100_INT8_OPS, blocks=mm_grid_blocks_int8(batch, ndim, kdim))
        del calls, lib_calls, lib_copies
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
                def logged(bucket, _inner=r.server.launch):
                    buckets.append(([q.image for q in bucket.requests], bucket.batch,
                                    [q.future for q in bucket.requests]))
                    return _inner(bucket)
                r.server.launch = logged
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
            check(not any(serve_counts.values()),
                  f"serving {label}: a wrapper ran outside a graph: {serve_counts}")
            # Every response is checked before the launch counts, so that a
            # short count says whether the replays computed their buckets.
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
            try:
                check_device_launches(serve_dev, per_pass_s, passes,
                                      f"serving {label} x{replicas}")
            except AssertionError as e:
                raise AssertionError(
                    f"{e}; in the same window the host made "
                    f"{serve_dev['cudaGraphLaunch']} cudaGraphLaunch calls for "
                    f"{passes} replays, and all {n_checked} responses were "
                    "bit-equal to their bucket's BatchProgram") from None
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

    # ---- 8. calibration, timed groups, the parallelism baselines ----------
    results["phase8"], phase8_counts = phase8(
        net, params, cfg, (val_x, val_y), prog, prog8, served[8][0][0], rand, counted)
    phase_done("calibration_autotune_drift_baselines")

    # ---- 9. warm starts across processes ----------------------------------
    results["phase9"] = phase9(repo)
    phase_done("warm_starts")

    # ---- 10. the dense LM serving path: Qwen2-7B --------------------------
    results["phase10"] = phase10(repo)
    phase_done("dense_lm")

    # ---- 11. the MoE, hybrid-SSM, xLSTM and cross-attention families ------
    results["phase11"] = phase11(repo)
    phase_done("lm_families")

    # ---- 12. LM training: Qwen2-7B at full width, the other families ------
    results["phase12"] = phase12(repo)
    phase_done("lm_training")

    # ---- 13. the mesh and dry-run tools -----------------------------------
    results["phase13"] = phase13(repo)
    phase_done("mesh_dryrun")

    # ---- 14. the channel LayerNorm kernel (ConvNeXt-T) --------------------
    results["phase14"] = phase14(repo)
    phase_done("layernorm")

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
            "phase8_launches": phase8_counts[kern],
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
    summary.append(results["phase14"]["entry"])
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
