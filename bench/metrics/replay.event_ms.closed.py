"""replay.event_ms.closed: mean device ms of a ``dev.replay`` span (the
copy into the graph's static input, the graph's replay and the output's
clone, between two CUDA events the tier records), over the window; None off
the card."""


def read(run):
    spans = run.spans_named("dev.replay")
    return 1e3 * sum(s.duration_s for s in spans) / len(spans) if spans else None
