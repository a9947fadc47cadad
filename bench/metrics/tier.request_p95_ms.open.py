"""tier.request_p95_ms.open: the 95th percentile (nearest rank) of the
``serve.request`` spans of the window, each from a request's enqueue to its
answer: the tier's share of ``p95_ms``; what is left of it is admission and
the client's wake-up."""
import math


def read(run):
    lat = sorted(s.duration_s for s in run.spans_named("serve.request"))
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
