"""tier.copy_in_ms.closed: device ms per bucket of the tier's host-to-device
copies of the stacked images, in the profiler's window, over the graph
launches (one a bucket) with an operation in the window."""


def read(run):
    d = run.device
    if d is None or not d.graph_launches:
        return None
    seconds = sum(b - a for _, a, b in d.ops_of(r"^Memcpy HtoD"))
    return 1e3 * seconds / d.graph_launches if seconds > 0 else None
