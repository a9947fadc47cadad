"""replay.device_ms.closed: device-busy ms per bucket's replay in the
profiler's window: the union of the times of the device operations that a
``cudaGraphLaunch`` launched, over the graph launches with an operation in
the window.  The tier's copies and casts around a replay are not in it."""


def read(run):
    d = run.device
    if d is None or not d.graph_launches or d.graph_busy_s <= 0:
        return None
    return 1e3 * d.graph_busy_s / d.graph_launches
