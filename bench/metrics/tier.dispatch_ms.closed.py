"""tier.dispatch_ms.closed: mean ms of a ``serve.dispatch`` span (one
bucket: stack, pad, copy in, replay, copy out, scatter), over the window."""


def read(run):
    spans = run.spans_named("serve.dispatch")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
