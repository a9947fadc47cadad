#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--out results.json]

Phases; each raises on failure, so a failing phase never exits 0:

1. the card's name and power limit; all four CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the shapes
   full-width AlexNet gives it (conv2-conv5, fc6-fc8), batch 1 and 8: the
   float kernels in RELAXED, IMPRECISE and PRECISE, TF32 off; the int8
   kernels bit for bit, bias and ReLU each on and off;
3. the RELAXED main path: full-width AlexNet (random weights from a seed)
   through ``synthesize(device="h100", PlannerConfig(batch=8))`` and
   ``for_batch(1)`` / ``for_batch(8)``, 4 batches each; the launch counters
   must show one float conv launch per kernel-routed conv group, three
   matmul launches per batch and no int8 launch; the logits must match the
   same program run on CPU copies of the weights (the plain versions)
   within 2 bf16 ulps, and the probabilities within what those logits
   allow; then one ``synthesize`` with a 16-image validation set and its
   gate record;
4. the int8 main path: the same network through ``synthesize(...,
   forced_mode=IMPRECISE_INT8)`` with the 16 images as calibration set,
   then ``for_batch(1)`` / ``for_batch(8)``, 4 batches each; every
   kernel-routed int8 layer must carry calibrated qparams, the int8 kernels
   must launch once per routed group and pass (the float ones never), and
   the logits must match the same program run on CPU copies of its
   prepared weights within mode_tolerance(IMPRECISE_INT8) of the row's
   largest |logit|; then one ``synthesize(..., allow_int8=True,
   max_degradation=0.05)`` through the loop and the gate;
5. times with CUDA events (median): each kernel, its plain version, one
   library call for the same function where PyTorch has one, and the bound
   from its bytes and operations; end to end at batch 1 and 8 for the
   RELAXED and the int8 program;
6. one ``torch.profiler`` window of three batch-8 requests per program:
   device time by kernel and the device's busy share of the host-clock time.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA or
without the repository beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
H100_BF16_FLOPS = 989e12      # dense tensor-core peak (data sheet, 700 W)
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak (data sheet, 700 W)
H100_BYTES_PER_S = 3.35e12    # HBM3
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


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    import torch.nn.functional as F

    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import (IMPL_KERNEL, ComputeMode, PlannerConfig,
                                  collect_activations, mode_tolerance, synthesize)
    from repro_torch.data import imagenet_like
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv_mapmajor.conv_mapmajor import (
        MAX_U, conv_mapmajor, conv_mapmajor_int8, conv_mapmajor_int8_plain,
        conv_mapmajor_plain, cuda_smem_bytes, cuda_smem_bytes_int8, kernel_smem_bytes,
        kernel_smem_bytes_int8)
    from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import (
        BLOCK_K, matmul_mapmajor, matmul_mapmajor_int8, matmul_mapmajor_int8_plain,
        matmul_mapmajor_plain)
    from repro_torch.kernels.matmul_mapmajor.ops import block_k

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
    check(_build.load("conv_mapmajor_int8").conv_mapmajor_int8_max_u() == MAX_U,
          "MAX_U disagrees with kMaxU in conv_mapmajor_int8.cu")
    check(_build.load("matmul_mapmajor_int8").matmul_mapmajor_int8_block_k() == BLOCK_K,
          "BLOCK_K disagrees with BK in matmul_mapmajor_int8.cu")
    for k, s in [(11, 4)] + [(k, 1) for _, _, _, k, _ in CONV_SHAPES]:
        for mode in modes:
            check(kernel_smem_bytes(k, k, s, 128, 128, mode)
                  == cuda_smem_bytes(k, k, s, 128, 128, mode),
                  "rule-1 envelope disagrees with the kernel's smem request")
        check(kernel_smem_bytes_int8(k, k, s, 128, 128)
              == cuda_smem_bytes_int8(k, k, s, 128, 128),
              "int8 rule-1 envelope disagrees with the int8 kernel's smem request")
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
    prog = synthesize(net, params, device="h100", planner_config=cfg)

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
    runs = 2 * (n_batches + 1)                      # served batches + warm-ups
    img_gen = torch.Generator().manual_seed(SEED + 1)

    def serve(program):
        """for_batch(1) and for_batch(8), n_batches each, counts read around."""
        served = {}
        reset_counts()
        for batch in (1, 8):
            bp = program.for_batch(batch)
            outs = []
            for _ in range(n_batches):
                x, _ = imagenet_like(img_gen, batch, hw=227, num_classes=1000,
                                     device="cuda")
                outs.append((x, bp(x)))
            torch.cuda.synchronize()
            served[batch] = outs
        return served, read_counts()

    served, launches = serve(prog)
    print(f"launches on the RELAXED path ({runs} forward passes): {launches}")
    check(launches["conv_mapmajor"] == runs * conv_kernel_groups,
          f"conv launches {launches['conv_mapmajor']} != {runs} x {conv_kernel_groups}")
    check(launches["matmul_mapmajor"] == runs * 3,
          f"matmul launches {launches['matmul_mapmajor']} != {runs} x 3")
    check(launches["conv_mapmajor_int8"] == launches["matmul_mapmajor_int8"] == 0,
          "an int8 kernel launched on the RELAXED path")
    results["launches"] = launches
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
                       forced_mode=int8)
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
    served8, launches8 = serve(prog8)
    print(f"launches on the int8 path ({runs} forward passes): {launches8}")
    check(launches8["conv_mapmajor_int8"] == runs * groups8["conv"],
          f"int8 conv launches {launches8['conv_mapmajor_int8']} != {runs} x {groups8['conv']}")
    check(launches8["matmul_mapmajor_int8"] == runs * 3,
          f"int8 matmul launches {launches8['matmul_mapmajor_int8']} != {runs} x 3")
    check(launches8["conv_mapmajor"] == launches8["matmul_mapmajor"] == 0,
          "a float kernel launched on the int8 path")
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
    results["int8"] = {"launches": launches8, "act_scales": act_scales,
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
    relaxed = ComputeMode.RELAXED
    bf16 = torch.bfloat16
    rows = []
    shapes = {name: (cin, cout) for name, cin, _, _, cout in CONV_SHAPES}
    cudnn_ms = {}
    for (name, batch), (x, w, b, hw) in conv_inputs.items():
        xb, wb = x.to(bf16), w.to(bf16)
        gi, go = x.shape[1], w.shape[0]
        k = w.shape[3]
        cin, cout = shapes[name]
        ms = cuda_ms(lambda: conv_mapmajor(xb, wb, b, out_hw=(hw, hw), mode=relaxed,
                                           apply_relu=True))
        plain = cuda_ms(lambda: conv_mapmajor_plain(xb, wb, b, out_hw=(hw, hw),
                                                    mode=relaxed, apply_relu=True), reps=5)
        # The layer's own NCHW operands: no SAME border, no zero lanes past
        # cin.  The library call and the bound do the layer's work, not the
        # kernel's padded work.
        x_nchw = xb[:, :, k // 2:k // 2 + hw, k // 2:k // 2 + hw, :] \
            .permute(0, 1, 4, 2, 3).reshape(batch, gi * 128, hw, hw)[:, :cin].contiguous()
        w_oihw = wb.permute(0, 1, 2, 5, 3, 4).reshape(go * 128, gi * 128, k, k)[
            :cout, :cin].contiguous()
        b_lib = b.reshape(-1)[:cout].to(bf16)
        lib = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=k // 2))
        cudnn_ms[(name, batch)] = lib
        flops = 2.0 * batch * hw * hw * cout * cin * k * k
        nbytes = 2 * (x_nchw.numel() + w_oihw.numel() + batch * cout * hw * hw) + 4 * cout
        rows.append(("conv_mapmajor", name, batch, ms, plain, lib, flops, nbytes,
                     H100_BF16_FLOPS))
    for (name, batch), (x8, w8, s8, b, hw) in conv8_inputs.items():
        k = w8.shape[3]
        cin, cout = shapes[name]
        ms = cuda_ms(lambda: conv_mapmajor_int8(x8, w8, s8, b, out_hw=(hw, hw),
                                                apply_relu=True))
        plain = cuda_ms(lambda: conv_mapmajor_int8_plain(x8, w8, s8, b, out_hw=(hw, hw),
                                                         apply_relu=True), reps=3)
        # The layer's own work: 1-byte activations and weights, bf16 out, f32
        # scale and bias; no PyTorch call computes an int8 conv.
        flops = 2.0 * batch * hw * hw * cout * cin * k * k
        nbytes = batch * cin * hw * hw + cout * cin * k * k + 2 * batch * cout * hw * hw \
            + 8 * cout
        rows.append(("conv_mapmajor_int8", name, batch, ms, plain, None, flops, nbytes,
                     H100_INT8_OPS))
    for (name, batch), (a, wm, bias) in mm_inputs.items():
        ab, wb = a.to(bf16), wm.to(bf16)
        ms = cuda_ms(lambda: matmul_mapmajor(ab, wb, bias, mode=relaxed,
                                             bk=block_k(128), apply_relu=True))
        plain = cuda_ms(lambda: matmul_mapmajor_plain(ab, wb, bias, mode=relaxed,
                                                      bk=block_k(128), apply_relu=True),
                        reps=5)
        bias_lib = bias.to(bf16)
        lib = cuda_ms(lambda: torch.addmm(bias_lib, ab, wb))
        kdim, ndim = wm.shape
        flops = 2.0 * batch * kdim * ndim
        nbytes = 2 * (a.numel() + wm.numel() + batch * ndim) + 4 * bias.numel()
        rows.append(("matmul_mapmajor", name, batch, ms, plain, lib, flops, nbytes,
                     H100_BF16_FLOPS))
    for (name, batch), (a8, wm8, s8, bias) in mm8_inputs.items():
        ms = cuda_ms(lambda: matmul_mapmajor_int8(a8, wm8, s8, bias, apply_relu=True))
        plain = cuda_ms(lambda: matmul_mapmajor_int8_plain(a8, wm8, s8, bias,
                                                           apply_relu=True), reps=5)
        # cuBLASLt's int8 product (int32 out, no flush) needs M > 16: A is
        # padded to 32 rows; B column-major, cuBLASLt's int8 layout.
        a32 = F.pad(a8, (0, 0, 0, 32 - batch))
        wm8_cm = wm8.t().contiguous().t()
        check(torch.equal(torch._int_mm(a32, wm8_cm)[:batch],
                          (a8.double() @ wm8.double()).to(torch.int32)),
              "torch._int_mm disagrees with the exact int32 product")
        lib = cuda_ms(lambda: torch._int_mm(a32, wm8_cm))
        kdim, ndim = wm8.shape
        flops = 2.0 * batch * kdim * ndim
        nbytes = batch * kdim + kdim * ndim + 2 * batch * ndim + 8 * ndim
        rows.append(("matmul_mapmajor_int8", name, batch, ms, plain, lib, flops, nbytes,
                     H100_INT8_OPS))
    print("kernel times (ms): kernel | plain | library | bound (by); float kernels "
          "RELAXED; int8 library: torch._int_mm at M=32, conv none (bf16 cuDNN beside)")
    per_shape = []
    for kern, name, batch, ms, plain, lib, flops, nbytes, peak in rows:
        t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        lib_s = f"{lib:.4f}" if lib is not None else \
            f"none (bf16 cuDNN {cudnn_ms[(name, batch)]:.4f})"
        print(f"  {kern:20s} {name} B={batch}: {ms:.4f} | {plain:.4f} | {lib_s} | "
              f"{bound:.5f} ({by})")
        per_shape.append({"kernel": kern, "layer": name, "batch": batch, "ms": ms,
                          "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                          "bound_by": by, "flops": flops, "bytes": nbytes})
    results["per_shape"] = per_shape

    e2e = {}
    for label, program, outs in (("relaxed", prog, served), ("int8", prog8, served8)):
        e2e[label] = {}
        for batch in (1, 8):
            bp = program.for_batch(batch)
            x = outs[batch][0][0]
            ms = cuda_ms(lambda: bp(x), reps=10)
            e2e[label][batch] = {"ms_per_batch": ms, "images_per_s": batch / ms * 1e3}
            print(f"end to end {label} B={batch}: {ms:.3f} ms per batch, "
                  f"{batch / ms * 1e3:.1f} img/s")
    results["end_to_end"] = e2e
    phase_done("times")

    # ---- 6. where the time goes: one profiled window at batch 8 each ------
    from torch.profiler import ProfilerActivity, profile
    results["profile_b8"] = {}
    for label, program, outs in (("relaxed", prog, served), ("int8", prog8, served8)):
        bp = program.for_batch(8)
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
            print(f"profile {label} B=8: {wall_ms:.3f} ms per batch on the host clock, "
                  f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}); top device "
                  "kernels:")
            for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
                print(f"  {ms:8.4f} ms  {name[:90]}")
        else:
            print(f"profile {label} B=8: the profiler recorded no device time (not measured)")
        results["profile_b8"][label] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                        "by_kernel_ms": by_kernel}
    phase_done("profile")

    # One entry per kernel: its launches on its main path; times summed over
    # the layers it serves in one batch-8 forward pass (float kernels in
    # RELAXED, int8 kernels under IMPRECISE_INT8).
    summary = []
    sources = {
        "conv_mapmajor": ("src/repro_torch/kernels/csrc/conv_mapmajor.cu",
                          "src/repro/kernels/conv_mapmajor/conv_mapmajor.py:106",
                          prog, launches),
        "matmul_mapmajor": ("src/repro_torch/kernels/csrc/matmul_mapmajor.cu",
                            "src/repro/kernels/matmul_mapmajor/matmul_mapmajor.py:67",
                            prog, launches),
        "conv_mapmajor_int8": ("src/repro_torch/kernels/csrc/conv_mapmajor_int8.cu",
                               "src/repro/kernels/conv_mapmajor/conv_mapmajor.py:168",
                               prog8, launches8),
        "matmul_mapmajor_int8": ("src/repro_torch/kernels/csrc/matmul_mapmajor_int8.cu",
                                 "src/repro/kernels/matmul_mapmajor/matmul_mapmajor.py:96",
                                 prog8, launches8)}
    for kern, (source, replaces, program, counts) in sources.items():
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
            "launches": counts[kern], "max_abs_err": max(errs[kern]),
            "ms": sum(r["ms"] for r in sel), "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": sum(libs) if None not in libs else None,
            "shapes": "+".join(r["layer"] for r in sel) + " at batch 8, "
                      + ("IMPRECISE_INT8" if program is prog8 else "RELAXED")}
        if kern == "conv_mapmajor_int8":
            entry["library_note"] = (
                "no PyTorch call computes an int8 conv; bf16 F.conv2d on the same "
                f"layers: {sum(cudnn_ms[(r['layer'], 8)] for r in sel):.4f} ms")
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
