"""The reader of ``tier.overlap_share``: the share of the window's
``serve.dispatch`` spans whose bucket was launched while another bucket of
its replica was in flight, on spans made by hand, and nothing (and no error)
where no span says."""
import json

import pytest

from bench.tests.test_bench_trace_metrics import REPO, FakeRun, _reader, _span

CELLS = ["alexnet.closed64", "googlenet.closed64", "resnet50.closed64"]


def test_the_reader_has_one_entry():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in spec["per_layer"]}["tier.overlap_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "share", "higher", "program_span", "serving tier", "img_per_s")
    assert m["workloads"] == CELLS
    reports = {c for e in spec["end_to_end"] if e["name"] == "img_per_s" for c in e["workloads"]}
    assert set(CELLS) <= reports


@pytest.mark.parametrize("flags, share", [
    ([1, 1, 1, 1], 1.0),
    ([0, 1, 1, 1], 0.75),
    ([0, 0], 0.0),
    ([], None),                     # no serve.dispatch span in the window
    ([None, None], None),           # a program whose spans say nothing of it
])
def test_the_share_reads_the_dispatch_spans_flags(flags, share):
    # Overlapping dispatches of one replica, as a pipelined loop records them.
    spans = [_span("serve.dispatch", 1.0 + 0.002 * k, 1.003 + 0.002 * k, bucket=k,
                   **({} if f is None else {"overlapped": f})) for k, f in enumerate(flags)]
    # A span that starts after the window is not read; other spans are not.
    spans += [_span("serve.dispatch", 10.5, 10.6, overlapped=0),
              _span("serve.stack", 1.0, 1.001, overlapped=0)]
    assert _reader("tier.overlap_share").read(FakeRun(spans)) == share
