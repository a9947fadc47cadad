"""tier.copy_in_host_ms.closed: mean ms of a ``serve.copy_in`` span (the
host's side of the bucket's pageable copy to the device and its cast), over
the window."""


def read(run):
    spans = run.spans_named("serve.copy_in")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
