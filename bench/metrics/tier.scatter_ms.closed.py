"""tier.scatter_ms.closed: mean ms of a ``serve.scatter`` span (the device
events read, each answer handed to its future, the tier's counters), over
the window."""


def read(run):
    spans = run.spans_named("serve.scatter")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
