"""tier.queue_wait_ms.open: mean ms of a ``serve.batch_wait`` span (a
bucket's oldest request, from enqueue to flush), over the window."""


def read(run):
    spans = run.spans_named("serve.batch_wait")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
