"""p95_ms: the 95th percentile (nearest rank) of the latency of every request
sent in the window, from its due time (open loop) or its send time (closed
loop) to its answer.  A shed or failed request is infinitely late; where
that reaches the percentile there is no number."""
import math


def read(run):
    lat = sorted(run.latencies())
    if not lat:
        return None
    p = lat[math.ceil(0.95 * len(lat)) - 1]
    return None if math.isinf(p) else 1e3 * p
