"""The reader of ``tier.presubmit_share.closed``: over the window's
``serve.stack`` spans, the rows written into the tier's pinned ring at
submit over all the buckets' rows, on spans made by hand, and nothing (and
no error) where no span says."""
import json

import pytest

from bench.tests.test_bench_trace_metrics import REPO, FakeRun, _reader, _span


@pytest.mark.parametrize("stacks, share", [
    ([(8, 8), (8, 8), (8, 8)], 1.0),
    ([(8, 8), (8, 6), (4, 2)], 0.8),  # two stacked at a launch, two padding rows
    ([(8, 0), (1, 0)], 0.0),          # no ring: every image stacked at the launch
    ([], None),                       # no serve.stack span in the window
    ([(8, None), (4, None)], None),   # spans that say nothing of it (the parent's)
])
def test_the_presubmit_share_reads_the_stack_spans_rows(stacks, share):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in spec["per_layer"]}["tier.presubmit_share.closed"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "share", "higher", "program_span", "serving tier", "img_per_s")
    assert m["workloads"] == ["alexnet.closed64", "googlenet.closed64", "resnet50.closed64"]
    spans = [_span("serve.stack", 1.0 + k, 1.001 + k, bucket=k, rows=rows, pinned=1,
                   **({} if pre is None else {"presubmitted": pre, "runs": 1}))
             for k, (rows, pre) in enumerate(stacks)]
    # A span that starts after the window is not read.
    spans.append(_span("serve.stack", 10.5, 10.6, rows=8, presubmitted=0, runs=1, pinned=1))
    got = _reader("tier.presubmit_share.closed").read(FakeRun(spans))
    assert got == (None if share is None else pytest.approx(share))
