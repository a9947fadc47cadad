"""Stage D as one CUDA graph per batch, on the card.

Every case here is marked ``gpu`` and skips without a card.  They import no
JAX, so they run where the port runs:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_stage_d.py``.

Full-width AlexNet (random weights from a seed) synthesized for the
``h100`` profile with ``PlannerConfig(batch=8)``, so conv2–conv5 and
fc6–fc8 run on the hand-written kernels, with TF32 off as in
chip_smoke.py.  A replay must equal the eager walk (``infer``) on the same
input bit for bit: both run the same kernels on the same operands.
"""
import gc
import threading
import weakref

import pytest
import torch

from repro_torch.cnn import alexnet, init_network_params
from repro_torch.core import (IMPL_KERNEL, ComputeMode, PlannerConfig,
                              full_f32, synthesize)
from repro_torch.data import imagenet_like
from repro_torch.kernels.conv_mapmajor.conv_mapmajor import (conv_mapmajor,
                                                             conv_mapmajor_int8)
from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import (
    matmul_mapmajor, matmul_mapmajor_int8)
from repro_torch.serving import ProgramCache, ServingConfig

WRAPPERS = (conv_mapmajor, conv_mapmajor_int8, matmul_mapmajor,
            matmul_mapmajor_int8)

MODES = [ComputeMode.RELAXED, ComputeMode.IMPRECISE_INT8, ComputeMode.PRECISE]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: Stage D captures a CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


_PROGRAMS = {}


def _program(mode):
    """One synthesized full-width AlexNet per mode, shared by the cases (the
    int8 one calibrated on 8 images)."""
    if mode not in _PROGRAMS:
        net = alexnet()
        params = init_network_params(net, 0, "cuda")
        cal = imagenet_like(1, 8, hw=227, num_classes=1000, device="cuda")
        _PROGRAMS[mode] = synthesize(net, params, cal, device="h100",
                                     planner_config=PlannerConfig(batch=8),
                                     forced_mode=mode)
    return _PROGRAMS[mode]


def _images(batch, seed):
    return imagenet_like(seed, batch, hw=227, num_classes=1000,
                         device="cuda")[0]


def _counts():
    return {fn: fn.launches for fn in WRAPPERS}


def _device_launches(fn, names):
    """Launches of each named ``__global__`` on the card while ``fn`` runs,
    from one ``torch.profiler`` window."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_replay_equals_eager_infer(cuda, mode, batch):
    prog = _program(mode)
    bp = prog.for_batch(batch)
    assert bp.captured and bp.graph_bytes > 0
    for seed in (2, 3):
        x = _images(batch, seed)
        got = bp(x)
        want = prog.infer(x)
        torch.cuda.synchronize()
        assert got.shape == (batch, 1000) and torch.isfinite(got).all()
        assert torch.equal(got, want), (
            f"{mode.value} B={batch}: replay differs from eager by "
            f"{(got - want).abs().max().item()}")


@pytest.mark.gpu
def test_precise_graph_stays_tf32_free_with_tf32_on(cuda):
    """PRECISE layers run inside ``full_f32`` (TF32 off for cuBLAS and
    cuDNN), which a graph bakes in at capture: with TF32 allowed
    everywhere else, a replay still equals the eager walk, which turns
    TF32 off around the same calls, and differs from the same layers run
    with TF32 on."""
    prog = _program(ComputeMode.PRECISE)
    x = _images(8, 7)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        bp = prog.for_batch(8)
        got, want = bp(x), prog.infer(x)
        fc6 = prog.prepared["fc6"]["w"]
        a = torch.randn(8, fc6.shape[0], device=cuda)
        with_tf32 = a @ fc6
        with full_f32():
            tf32_differs = not torch.equal(with_tf32, a @ fc6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tf32_differs                  # TF32 really was on outside


@pytest.mark.gpu
def test_replays_from_four_threads_return_each_callers_result(cuda):
    prog = _program(ComputeMode.RELAXED)
    bp = prog.for_batch(8)
    xs = [_images(8, 10 + t) for t in range(4)]
    want = [prog.infer(x) for x in xs]
    torch.cuda.synchronize()
    bad, done = [], []

    def caller(t):
        for _ in range(10):
            y = bp(xs[t])
            if not torch.equal(y, want[t]):
                bad.append(t)
        done.append(t)

    threads = [threading.Thread(target=caller, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120.0)
    assert not any(th.is_alive() for th in threads)
    assert sorted(done) == [0, 1, 2, 3] and not bad


@pytest.mark.gpu
def test_capture_failure_raises_and_never_falls_back(cuda):
    """A forward pass that synchronizes with the host (``.item()``) cannot be
    captured: for_batch raises, counts nothing and leaves the launch
    counters and the card usable."""
    prog = _program(ComputeMode.RELAXED)
    eager = prog.infer

    def syncing_infer(x):
        if x.abs().sum().item() < 0:                  # a host sync
            raise AssertionError("unreachable")
        return eager(x)

    compiles = prog.stage_d_compiles
    before = _counts()
    prog.infer = syncing_infer
    try:
        with pytest.raises(RuntimeError, match="capture"):
            prog.for_batch(2)
    finally:
        del prog.infer                                 # the method again
    assert prog.stage_d_compiles == compiles
    after = _counts()
    # the warm-up ran eagerly and counts one pass; a good build counts its
    # warm-up and its capture
    warm = {fn: after[fn] - before[fn] for fn in WRAPPERS}
    assert sum(warm.values()) >= 7                     # conv2-conv5 + fc6-fc8
    bp = prog.for_batch(2)
    assert {fn: fn.launches - after[fn] for fn in WRAPPERS} == \
        {fn: 2 * n for fn, n in warm.items()}
    x = _images(2, 4)
    assert torch.equal(bp(x), prog.infer(x))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [ComputeMode.RELAXED, ComputeMode.IMPRECISE_INT8],
                         ids=lambda m: m.value)
def test_replays_launch_the_kernels_and_leave_the_counters(cuda, mode):
    """Each replay launches every routed kernel once per layer on the card
    (counted by kernel name in a profiler window); the wrappers, which a
    replay does not call, count nothing."""
    prog = _program(mode)
    bp = prog.for_batch(8)
    routed = {"conv": 0, "dense": 0}
    for g in prog.plan.graph.groups:
        if prog.plan.for_layer(g.name).impl == IMPL_KERNEL:
            routed[g.anchor.kind] += 1
    assert routed["conv"] >= 4 and routed["dense"] == 3
    tag = "_int8" if mode is ComputeMode.IMPRECISE_INT8 else ""
    names = {f"conv_mapmajor{tag}_kernel": routed["conv"],
             f"matmul_mapmajor{tag}_split": 3, f"matmul_mapmajor{tag}_reduce": 3}
    x = _images(8, 5)
    before = _counts()

    def replays():
        for _ in range(3):
            bp(x)

    got = _device_launches(replays, names)
    assert got == {n: 3 * k for n, k in names.items()}
    assert _counts() == before


@pytest.mark.gpu
def test_eviction_frees_the_graph(cuda):
    """A bucket evicted from the program cache is no longer referenced by
    it, and once its last holder lets go, its graph's private pool goes
    back to the card (``empty_cache``)."""
    prog = _program(ComputeMode.RELAXED)
    cache = ProgramCache(config=ServingConfig(cache_entries=1))
    cache.admit(prog)
    bp = cache.get_or_build(prog, 4)
    x = _images(4, 6)
    y = bp(x)
    graph_bytes, ref = bp.graph_bytes, weakref.ref(bp)
    assert graph_bytes > 0
    cache.get_or_build(prog, 2)                        # evicts bucket 4
    assert cache.stats.evictions == 1
    assert torch.equal(bp(x), y)                       # a holder still replays
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    del bp
    gc.collect()
    torch.cuda.empty_cache()
    assert ref() is None
    assert held - torch.cuda.memory_reserved() >= graph_bytes
    assert torch.isfinite(y).all()                     # the clone survives
