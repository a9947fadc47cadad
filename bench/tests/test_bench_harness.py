"""Whole runs of a small cell on the CPU: a cell made only of new files is
found by name, the program passes its check, and the control and each
fault the serving path can have fail it.

The cell is AlexNet at a tenth of its widths on 67 x 67 images with ten
classes, its kernels' plain versions routed as on the card.  At this size
and seed the check's numbers (error power, widest answer's power) read
about (1.7, 3.3) for the program as configured (bf16) and (12, 22) for
its own int8 path, so this cell's limits are (4, 10).  The card's cells
take their limits from their own readings.
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

from bench import harness

SEED = 1000003
CELL = "tiny.closed8"
REPO = Path(__file__).resolve().parents[2]


def make_root(root: Path) -> Path:
    """A checkout of the benchmark alone, with the small cell added as new
    files: a configuration, a traffic, a metric reader and its entries."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((REPO / "bench/configs/alexnet.json").read_text())
    cfg.update(scale=0.1, input_hw=67, num_classes=10, pool_images=16)
    cfg["planner"]["allow_pallas"] = True
    cfg["check"].update(error_power_limit=4.0, widest_answer_power_limit=10.0)
    (root / "bench/configs/tiny_alexnet.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/closed8.json").write_text('{"kind": "closed", "clients": 8}')
    (root / "bench/metrics/extra.answered.py").write_text(
        "def read(run):\n    return float(run.completed_in_window)\n")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny_alexnet", "source": "test", "reduced": [],
                        "file": "bench/configs/tiny_alexnet.json", "why": "test"}]
    spec["workloads"] = [{"name": CELL, "config": "tiny_alexnet", "traffic": "closed8",
                          "chips": 1, "why": "test"}]
    spec["end_to_end"] = [dict(m, workloads=[CELL]) if "workloads" in m else m
                          for m in spec["end_to_end"] if m["name"] != "p95_ms"]
    spec["per_layer"] = [{"name": "extra.answered", "unit": "img", "better": "higher",
                          "source": "host_clock", "layer": "test", "moves": "img_per_s",
                          "workloads": [CELL]},
                         {"name": "synth.abc_s", "unit": "s", "better": "lower",
                          "source": "program_span", "layer": "synthesis", "moves": "setup_s"}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def _run(root, trace=False, mode=None):
    torch.manual_seed(0)
    return harness.run_cell(CELL, SEED, 0.3, trace, root=root, device="cpu", mode=mode)[0]


def test_a_cell_made_of_new_files_is_found_and_passes(root):
    r = _run(root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 8
    assert set(r["metrics"]) == {"img_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["compared"]["value"] == r["attempted"]
    assert r["checks"]["error_power"]["value"] < 2.5
    assert r["checks"]["widest_answer_power"]["value"] < 5.0
    t = _run(root, trace=True)
    assert t["correct"] is True
    assert set(t["metrics"]) == {"extra.answered", "synth.abc_s"}
    assert t["metrics"]["extra.answered"]["value"] > 8


def test_the_control_fails(root):
    r = _run(root, mode="imprecise_int8")
    assert r["correct"] is False
    assert r["checks"]["error_power"]["value"] > 8.0
    assert r["checks"]["widest_answer_power"]["value"] > 15.0


def _armed_in_the_window(monkeypatch):
    """A flag that turns true when the measured window starts, so that a
    fault breaks the timed path and not the set-up."""
    armed = []
    window = harness.Session.window

    def arm(self, *args, **kwargs):
        armed.append(True)
        return window(self, *args, **kwargs)

    monkeypatch.setattr(harness.Session, "window", arm)
    return armed


def _alter_one_answer(out):
    out = out.clone()
    out[0] = out[0].roll(1)
    return out


def _drop_half_the_bucket(out):
    out = out.clone()
    half = out.shape[0] // 2
    out[half:2 * half] = out[:half]
    return out


@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_bucket])
def test_a_wrong_answer_where_it_is_produced_fails(root, monkeypatch, fault):
    from repro_torch.core.synthesizer import BatchProgram

    call = BatchProgram.__call__
    armed = _armed_in_the_window(monkeypatch)
    monkeypatch.setattr(BatchProgram, "__call__",
                        lambda self, x: fault(call(self, x)) if armed else call(self, x))
    assert _run(root)["correct"] is False


def test_an_answer_that_never_comes_fails(root, monkeypatch):
    from repro_torch.serving.server import SynthesisServer

    dispatch = SynthesisServer.dispatch_bucket
    armed, dropped = _armed_in_the_window(monkeypatch), []

    def drop_one(self, bucket):
        if armed and not dropped and len(bucket.requests) > 1:
            dropped.append(bucket.requests.pop())
        dispatch(self, bucket)

    monkeypatch.setattr(SynthesisServer, "dispatch_bucket", drop_one)
    monkeypatch.setattr(harness, "DRAIN_S", 0.5)
    r = _run(root)
    assert dropped and r["correct"] is False
    assert r["checks"]["unanswered"]["value"] >= 1 and r["failed"] >= 1


def test_host_counters_read_this_thread():
    import threading
    tid = threading.get_native_id()
    a = harness.host_counters({"main": tid})
    sum(i * i for i in range(200000))
    d = harness.host_delta(a, harness.host_counters({"main": tid}))
    assert set(d) == {"cpu_s", "main.cpu_s"}
    assert d["cpu_s"] > 0 and d["main.cpu_s"] >= 0
