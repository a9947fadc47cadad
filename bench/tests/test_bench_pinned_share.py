"""The reader of ``tier.pinned_share.closed``: the share of the window's
``serve.stack`` spans whose rows went into the tier's pinned staging buffer,
on spans made by hand, and nothing (and no error) where no span says."""
import json

import pytest

from bench.tests.test_bench_trace_metrics import REPO, FakeRun, _reader, _span


@pytest.mark.parametrize("flags, share", [
    ([1, 1, 1], 1.0),
    ([1, 0, 1, 0], 0.5),
    ([], None),                     # no serve.stack span in the window
    ([None, None], None),           # spans that say nothing of pinning
])
def test_the_pinned_share_reads_the_stack_spans_flags(flags, share):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in spec["per_layer"]}["tier.pinned_share.closed"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "share", "higher", "program_span", "serving tier", "img_per_s")
    assert m["workloads"] == ["alexnet.closed64", "googlenet.closed64"]
    spans = [_span("serve.stack", 1.0 + k, 1.001 + k, bucket=k,
                   **({} if f is None else {"pinned": f})) for k, f in enumerate(flags)]
    # A span that starts after the window is not read.
    spans.append(_span("serve.stack", 10.5, 10.6, pinned=0))
    assert _reader("tier.pinned_share.closed").read(FakeRun(spans)) == share
