"""The benchmark's operation and bound counts against hand counts, and the
device window's readers."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import roofline
from bench.profiling import START, DeviceWindow, read_events
from bench.reference import alexnet, googlenet

ALEXNET_MACS = {   # output H x W x Cout x Cin x K x K, and K x N for the dense layers
    "conv1": 55 * 55 * 96 * 3 * 11 * 11,
    "conv2": 27 * 27 * 256 * 96 * 5 * 5,
    "conv3": 13 * 13 * 384 * 256 * 3 * 3,
    "conv4": 13 * 13 * 384 * 384 * 3 * 3,
    "conv5": 13 * 13 * 256 * 384 * 3 * 3,
    "fc6": 6 * 6 * 256 * 4096,
    "fc7": 4096 * 4096,
    "fc8": 4096 * 1000,
}


def googlenet_macs() -> int:
    """Szegedy et al., Table 1, counted by hand."""
    macs = 112 * 112 * 64 * 3 * 49 + 56 * 56 * 64 * 64 + 56 * 56 * 192 * 64 * 9
    modules = [(28, 192, (64, 96, 128, 16, 32, 32)), (28, 256, (128, 128, 192, 32, 96, 64)),
               (14, 480, (192, 96, 208, 16, 48, 64)), (14, 512, (160, 112, 224, 24, 64, 64)),
               (14, 512, (128, 128, 256, 24, 64, 64)), (14, 512, (112, 144, 288, 32, 64, 64)),
               (14, 528, (256, 160, 320, 32, 128, 128)), (7, 832, (256, 160, 320, 32, 128, 128)),
               (7, 832, (384, 192, 384, 48, 128, 128))]
    for s, cin, (c1, c3r, c3, c5r, c5, cp) in modules:
        macs += s * s * (cin * (c1 + c3r + c5r + cp) + c3r * c3 * 9 + c5r * c5 * 25)
    return macs + 1024 * 1000


def test_flops_per_image_equal_hand_counts():
    a = alexnet.layers()
    assert roofline.flops_per_image(a, (3, 227, 227)) == 2 * sum(ALEXNET_MACS.values())
    assert roofline.flops_per_image(a, (3, 227, 227)) == 2_270_512_192
    g = googlenet.layers()
    assert roofline.flops_per_image(g, (3, 224, 224)) == 2 * googlenet_macs()


def test_bounds_equal_hand_counts():
    a = alexnet.layers()
    # conv2 at batch 8: 7.17 GFLOP against 5.3 MB, so bound by operations.
    flops = 2 * ALEXNET_MACS["conv2"] * 8
    nbytes = 2 * (8 * (96 * 27 * 27 + 256 * 27 * 27) + 256 * 96 * 25) + 4 * 256
    assert nbytes / roofline.HBM_BYTES_PER_S < flops / roofline.BF16_FLOPS
    assert roofline.bound_seconds(a, (3, 227, 227), ["conv2"], 8) == \
        pytest.approx(flops / 989e12, rel=1e-12)
    # fc6 at batch 8: 75 MB of bf16 weights, so bound by bytes.
    nbytes = 2 * (8 * 9216 + 9216 * 4096 + 8 * 4096) + 4 * 4096
    assert roofline.bound_seconds(a, (3, 227, 227), ["fc6"], 8) == \
        pytest.approx(nbytes / 3.35e12, rel=1e-12)
    # The four convolutions the kernel serves at batch 8: 15.7 us.
    four = roofline.bound_seconds(a, (3, 227, 227), ["conv2", "conv3", "conv4", "conv5"], 8)
    assert four == pytest.approx(2 * 8 * sum(ALEXNET_MACS[f"conv{i}"] for i in (2, 3, 4, 5))
                                 / 989e12, rel=1e-12)
    assert 15.6e-6 < four < 15.9e-6


def _reader(metric):
    path = Path(roofline.__file__).parent / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(name, t0, t1, **attrs):
    return SimpleNamespace(name=name, t_start=t0, t_end=t1, attrs=attrs)


def test_kernel_roofline_pct_credits_each_launch_with_its_replays_bound():
    a = alexnet.layers()
    convs = ["conv2", "conv3", "conv4", "conv5"]
    routing = {n: "xla" for n in ("conv1", "fc6", "fc7", "fc8")}
    routing.update({n: roofline.KERNEL_IMPL for n in convs})
    # Two replays of a bucket of 8, four launches of 50 us each; one stray
    # launch outside every dispatch span is timed but not credited.
    ops = [("void conv_mapmajor_kernel<__nv_bfloat16, 1, 2, 2>(ConvArgs)",
            r + 1e-4 * i, r + 1e-4 * i + 5e-5) for r in (1.0, 2.0) for i in range(4)]
    ops.append(("void conv_mapmajor_kernel<__nv_bfloat16, 1, 2, 2>(ConvArgs)", 3.5, 3.50005))
    ops.append(("void conv_mapmajor_int8_kernel<1>(Args)", 1.0, 1.1))
    run = SimpleNamespace(
        device=DeviceWindow(0.0, 4.0, ops), layers=a, input_shape=(3, 227, 227),
        routing=routing, kinds=None,
        spans=[_span("serve.dispatch", 0.99, 1.01, batch=8),
               _span("serve.dispatch", 1.99, 2.01, batch=8)])
    pct = roofline.kernel_roofline_pct(run, "conv", r"\bconv_mapmajor_kernel\b", 1)
    bound = roofline.bound_seconds(a, (3, 227, 227), convs, 8)
    assert pct == pytest.approx(100 * 2 * bound / (9 * 5e-5), rel=1e-6)
    run.device = None
    assert roofline.kernel_roofline_pct(run, "conv", r"\bconv_mapmajor_kernel\b", 1) is None


def test_device_window_busy_idle_and_labels():
    d = DeviceWindow(0.0, 1.0, [("k1", 0.1, 0.35), ("k2", 0.2, 0.4), ("m", 0.6, 0.7)])
    assert d.busy_s == pytest.approx(0.4)
    assert [(round(a, 6), round(b, 6)) for a, b in d.idle_intervals()] == \
        [(0.0, 0.1), (0.4, 0.6), (0.7, 1.0)]
    labels = dict(d.idle_by_span([_span("serve.dispatch", 0.35, 0.65),
                                  _span("serve.batch_wait", 0.0, 0.2)]))
    assert labels == {"no span": pytest.approx(0.3), "serve.dispatch": pytest.approx(0.2),
                      "serve.batch_wait": pytest.approx(0.1)}
    assert d.top_ops(2) == [["k1", pytest.approx(0.25)], ["k2", pytest.approx(0.2)]]
    assert [o[0] for o in d.ops_of("^k")] == ["k1", "k2"]


class _Event:
    """A profiler event as ``read_events`` reads it."""

    def __init__(self, name, start_s, dur_s, corr, device="CUDA"):
        self._v = (name, int(start_s * 1e9), int(dur_s * 1e9), corr)
        self._device = SimpleNamespace(name=device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._device


def test_a_replay_is_timed_by_its_graph_launch_and_the_copy_in_apart():
    events = [_Event(START, 100.0, 0.0, 0, "CPU")]
    for r in range(3):                     # a copy in, a cast, then one replay
        t = 100.1 + 0.01 * r
        events += [_Event("Memcpy HtoD (Pageable -> Device)", t, 4e-4, 10 + r),
                   _Event("cast_kernel", t + 4e-4, 5e-5, 20 + r),
                   _Event("cudaGraphLaunch", t + 4e-4, 1e-5, 30 + r, "CPU"),
                   _Event("conv_mapmajor_kernel", t + 6e-4, 6e-4, 30 + r),
                   _Event("add_kernel", t + 1.3e-3, 1e-4, 30 + r)]
    d = read_events(events, {START: 5.0}, 5.0, 6.0)
    assert d.graph_launches == 3 and len(d.ops) == 12
    assert d.graph_busy_s == pytest.approx(3 * 7e-4, rel=1e-6)
    run = SimpleNamespace(device=d)
    metrics = {m: _reader(m).read(run) for m in ("replay.device_ms.closed",
                                                 "tier.copy_in_ms.closed")}
    assert metrics == {"replay.device_ms.closed": pytest.approx(0.7, rel=1e-6),
                       "tier.copy_in_ms.closed": pytest.approx(0.4, rel=1e-6)}
    # A window that holds no replay reads nothing.
    quiet = read_events(events, {START: 5.0}, 6.5, 7.0)
    assert quiet.graph_launches == 0
    assert _reader("replay.device_ms.closed").read(SimpleNamespace(device=quiet)) is None
