"""A whole run on the CPU of a cell whose network needs a layer kind that
``bench/reference/ops.py`` does not build in: the program's ``avgpool``
(SAME padding, stride 2, a mean over the in-bounds elements only).  The
cell comes only as new files in a checkout of its own: a configuration, a
reference, a kind file and a traffic.  The program's network is handed to
the harness through ``repro_torch.cnn.WORKLOADS``, as a network the program
serves would be.

It passes its check; with a kind file that averages over the padding as
well, the same cell fails it.  At this size the check's numbers (error
power, widest answer's power) read 1.14-1.57 and 2.22-3.26 for the program
as configured (bf16) over eight seeds, and 254-484 and 610-1153 against the
wrong kind file, so this cell's limits are (4, 10), as the tenth-width
AlexNet cell's are.
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

from bench import harness

SEED = 2 ** 31 + 77
CELL = "pooled.closed8"
REPO = Path(__file__).resolve().parents[2]

REFERENCE = '''"""A small network with an average pool: conv, ReLU, avgpool (3, stride 2,
SAME), conv, ReLU, maxpool, flatten, dense, softmax."""
from .ops import chain


def layers(scale=1.0, num_classes=10):
    t = []
    chain(t, "conv1", "conv", ("input",), out=8, k=3, stride=1, padding="SAME")
    chain(t, "relu1", "relu")
    chain(t, "pool1", "avgpool", pool=3, stride=2, padding="SAME")
    chain(t, "conv2", "conv", out=16, k=3, stride=1, padding="SAME")
    chain(t, "relu2", "relu")
    chain(t, "pool2", "maxpool", pool=3, stride=2, padding="VALID")
    chain(t, "flat", "flatten")
    chain(t, "fc", "dense", out=num_classes)
    chain(t, "prob", "softmax")
    return t
'''

AVGPOOL = '''"""avgpool: the mean of each pool x pool window at ``stride``; SAME pads as
a conv does and counts only the in-bounds elements of a window, VALID pads
nothing.  Computed in float32 from the rounded input and rounded once."""
import torch
import torch.nn.functional as F

from bench.reference.ops import window_shape, same_pads

ROUNDED = True


def shape(layer, in_shapes):
    return window_shape(layer, in_shapes, layer["pool"])


def params(layer, in_shapes):
    return None


def apply(layer, p, xs, q):
    x, k, s = xs[0], layer["pool"], layer["stride"]
    ones = torch.ones_like(x[:1, :1])
    if layer["padding"] == "SAME":
        h0, h1 = same_pads(x.shape[2], k, s)
        w0, w1 = same_pads(x.shape[3], k, s)
        x, ones = F.pad(x, (w0, w1, h0, h1)), F.pad(ones, (w0, w1, h0, h1))
    total = F.avg_pool2d(x, k, s, divisor_override=1)
    count = F.avg_pool2d(ones, k, s, divisor_override=1)
    return total / DIVISOR


def work(layer, in_shapes, out_shape):
    return None
'''


def pooled(scale=1.0, num_classes=10, input_hw=31):
    """The program's description of the network in ``REFERENCE``."""
    from repro_torch.core.network import NetworkDescription

    net = NetworkDescription("pooled", (3, input_hw, input_hw))
    net.conv("conv1", 8, 3, padding="SAME", inputs=("input",))
    net.relu("relu1")
    net.avgpool("pool1", 3, 2, padding="SAME")
    net.conv("conv2", 16, 3, padding="SAME")
    net.relu("relu2")
    net.maxpool("pool2", 3, 2)
    net.flatten("flat")
    net.dense("fc", num_classes)
    net.softmax("prob")
    return net


def make_root(root: Path, count_padding: bool = False) -> Path:
    """A checkout of the benchmark with the cell added as new files only."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((REPO / "bench/configs/alexnet.json").read_text())
    cfg.update(network="pooled", input_hw=31, num_classes=10, pool_images=16)
    cfg["planner"]["allow_pallas"] = True
    cfg["check"].update(error_power_limit=4.0, widest_answer_power_limit=10.0)
    (root / "bench/configs/pooled.json").write_text(json.dumps(cfg))
    (root / "bench/reference/pooled.py").write_text(REFERENCE)
    kinds = root / "bench/reference/kinds"
    kinds.mkdir(exist_ok=True)
    (kinds / "avgpool.py").write_text(
        AVGPOOL.replace("DIVISOR", "(k * k)" if count_padding else "count"))
    (root / "bench/traffic/closed8.json").write_text('{"kind": "closed", "clients": 8}')
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "pooled", "source": "test", "reduced": [],
                        "file": "bench/configs/pooled.json", "why": "test"}]
    spec["workloads"] = [{"name": CELL, "config": "pooled", "traffic": "closed8",
                          "chips": 1, "why": "test"}]
    spec["end_to_end"] = [dict(m, workloads=[CELL]) if "workloads" in m else m
                          for m in spec["end_to_end"] if m["name"] != "p95_ms"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def workloads(monkeypatch):
    from repro_torch import cnn
    monkeypatch.setitem(cnn.WORKLOADS, "pooled", pooled)


def _run(root):
    torch.manual_seed(0)
    return harness.run_cell(CELL, SEED, 0.3, False, root=root, device="cpu")[0]


def test_a_cell_with_a_kind_from_a_file_passes_its_check(tmp_path, workloads):
    root = make_root(tmp_path)
    layers = harness.Cell.load(CELL, root).reference().layers()
    assert "avgpool" in {l["kind"] for l in layers}
    r = _run(root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 8
    assert set(r["metrics"]) == {"img_per_s", "setup_s"}
    assert r["checks"]["compared"]["value"] == r["attempted"]
    assert r["checks"]["error_power"]["value"] < 2.5


def test_a_wrong_kind_file_fails_the_check(tmp_path, workloads):
    r = _run(make_root(tmp_path, count_padding=True))
    assert r["correct"] is False
    assert r["checks"]["error_power"]["value"] > 8.0
