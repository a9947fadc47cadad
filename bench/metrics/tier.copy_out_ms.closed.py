"""tier.copy_out_ms.closed: mean ms of a ``serve.copy_out`` span (the host
waits for the device, copies the answers back and widens them), over the
window."""


def read(run):
    spans = run.spans_named("serve.copy_out")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
