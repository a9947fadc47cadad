"""The readers of the serving tier's phase and device spans: their arithmetic
on spans made by hand, nothing (and no error) where the program records no
such span, and a traced run of the tenth-width AlexNet cell on the CPU, where
the host phases read and the CUDA-event metrics find nothing."""
import json
from pathlib import Path

import pytest

from bench import harness
from bench.tests.test_bench_harness import CELL, SEED, make_root

REPO = Path(__file__).resolve().parents[2]
NAMES = ["tier.lookup_ms.closed", "tier.stack_ms.closed", "tier.copy_in_host_ms.closed",
         "tier.copy_out_ms.closed", "tier.scatter_ms.closed", "tier.loop_gap_ms.closed",
         "tier.copy_in_event_ms.closed", "replay.event_ms.closed",
         "tier.device_gap_ms.closed", "tier.request_p95_ms.open"]
EVENT_METRICS = {"tier.copy_in_event_ms.closed", "replay.event_ms.closed",
                 "tier.device_gap_ms.closed"}


def _reader(name):
    return harness._load_module(REPO / "bench" / "metrics" / f"{name}.py", "t_" + name)


class FakeRun:
    """What the span readers read: the spans and the window."""
    spans_named = harness.Run.spans_named

    def __init__(self, spans, t0=0.0, t_end=10.0):
        self.spans, self.t0, self.t_end = spans, t0, t_end


def _span(name, t0, t1, thread="replica-0", **attrs):
    from repro_torch.obs import Span
    return Span(name=name, span_id=0, parent_id=None, t_start=t0, t_end=t1,
                thread=thread, attrs=attrs)


def test_every_new_metric_has_one_reader_and_one_entry():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NAMES:
        assert (REPO / "bench" / "metrics" / f"{name}.py").exists()
        m = entries[name]
        assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "program_span")
        assert m["workloads"] == (["alexnet.single"] if name.endswith(".open")
                                  else ["alexnet.closed64", "googlenet.closed64"])


def test_the_readers_arithmetic_on_spans_made_by_hand():
    spans = [
        # Two replicas' dispatches; the last starts after the window.
        _span("serve.dispatch", 1.0, 1.004), _span("serve.dispatch", 1.005, 1.009),
        _span("serve.dispatch", 1.011, 1.015),
        _span("serve.dispatch", 2.0, 2.01, thread="replica-1"),
        _span("serve.dispatch", 2.03, 2.04, thread="replica-1"),
        _span("serve.dispatch", 10.5, 10.6),
        _span("serve.lookup", 1.0, 1.001), _span("serve.lookup", 1.005, 1.008),
        _span("dev.copy_in", 1.0015, 1.002, bucket=1), _span("dev.replay", 1.002, 1.003, bucket=1),
        _span("dev.copy_in", 1.0065, 1.007, bucket=2), _span("dev.replay", 1.007, 1.008, bucket=2),
        _span("dev.copy_in", 1.0125, 1.013, bucket=3), _span("dev.replay", 1.013, 1.014, bucket=3),
    ] + [_span("serve.request", 0.0 + i, 0.0 + i + 0.001 * (i + 1)) for i in range(10)]
    run = FakeRun(spans)
    read = {name: _reader(name).read(run) for name in NAMES}
    assert read["tier.lookup_ms.closed"] == pytest.approx(2.0)
    # replica-0: 1 ms and 2 ms; replica-1: 20 ms.
    assert read["tier.loop_gap_ms.closed"] == pytest.approx((1 + 2 + 20) / 3)
    assert read["tier.copy_in_event_ms.closed"] == pytest.approx(0.5)
    assert read["replay.event_ms.closed"] == pytest.approx(1.0)
    assert read["tier.device_gap_ms.closed"] == pytest.approx((3.5 + 4.5) / 2)
    # Ten requests of 1..10 ms: the nearest rank of the 95th percentile is the tenth.
    assert read["tier.request_p95_ms.open"] == pytest.approx(10.0)
    assert read["tier.stack_ms.closed"] is None


def test_a_program_without_these_spans_reads_nothing():
    run = FakeRun([_span("serve.dispatch", 1.0, 1.004), _span("serve.batch_wait", 0.9, 1.0)])
    assert {name: _reader(name).read(run) for name in NAMES} == dict.fromkeys(NAMES)


def test_a_traced_tiny_run_reads_the_host_phases_and_no_device_metric(tmp_path):
    root = make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"] += [{"name": n, "unit": "ms", "better": "lower", "source": "program_span",
                           "layer": "serving tier", "moves": "img_per_s", "workloads": [CELL]}
                          for n in NAMES]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = harness.run_cell(CELL, SEED, 0.3, True, root=root, device="cpu")[0]
    assert result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    host = [n for n in NAMES if n not in EVENT_METRICS]
    assert set(host) <= set(metrics) and not EVENT_METRICS & set(metrics)
    assert all(metrics[n] > 0 for n in host if n != "tier.loop_gap_ms.closed")
    assert metrics["tier.loop_gap_ms.closed"] >= 0
    # The phases sit inside the dispatch they split.
    phases = sum(metrics[n] for n in ("tier.lookup_ms.closed", "tier.stack_ms.closed",
                                      "tier.copy_in_host_ms.closed", "tier.copy_out_ms.closed",
                                      "tier.scatter_ms.closed"))
    assert phases < metrics["tier.request_p95_ms.open"]
