"""tier.copy_in_event_ms.closed: mean device ms of a ``dev.copy_in`` span
(the bucket's host-to-device copy and cast, between two CUDA events the
tier records), over the window; None off the card."""


def read(run):
    spans = run.spans_named("dev.copy_in")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
