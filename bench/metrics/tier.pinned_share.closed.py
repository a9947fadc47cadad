"""tier.pinned_share.closed: the share of the window's ``serve.stack`` spans
whose rows went into the tier's pinned staging buffer (``pinned`` 1) rather
than its plain host buffer (0); nothing where no span says either."""


def read(run):
    flags = [s.attrs["pinned"] for s in run.spans_named("serve.stack") if "pinned" in s.attrs]
    return sum(f == 1 for f in flags) / len(flags) if flags else None
