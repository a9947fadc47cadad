"""tier.lookup_ms.closed: mean ms of a ``serve.lookup`` span (the program
cache's lookup of the bucket's program, the fingerprint included), over the
window."""


def read(run):
    spans = run.spans_named("serve.lookup")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
