"""tier.stack_ms.closed: mean ms of a ``serve.stack`` span (the bucket's
images stacked and zero-padded on the host), over the window."""


def read(run):
    spans = run.spans_named("serve.stack")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
