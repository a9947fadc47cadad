"""device.idle_pct.closed: the share of the profiler's window in which no
operation ran on the device."""


def read(run):
    d = run.device
    if d is None or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.seconds)
