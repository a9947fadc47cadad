"""tier.presubmit_share.closed: over the window's ``serve.stack`` spans, the
bucket rows whose images were written into the tier's pinned ring at submit
(``presubmitted``) over all their rows (``rows``, padding included); nothing
where no span says."""


def read(run):
    spans = [s for s in run.spans_named("serve.stack") if "presubmitted" in s.attrs]
    rows = sum(s.attrs["rows"] for s in spans)
    return sum(s.attrs["presubmitted"] for s in spans) / rows if rows else None
