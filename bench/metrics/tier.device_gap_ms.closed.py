"""tier.device_gap_ms.closed: mean ms the device idles between consecutive
buckets of one replica, from the end of a bucket's ``dev.replay`` to the
start of the next one's ``dev.copy_in`` (the answers' copy back counted as
gap), over the window; None off the card."""


def read(run):
    ends = {(s.thread, s.attrs.get("bucket")): s.t_end for s in run.spans_named("dev.replay")}
    by_thread = {}
    for s in run.spans_named("dev.copy_in"):
        if (s.thread, s.attrs.get("bucket")) in ends:
            by_thread.setdefault(s.thread, []).append(s)
    gaps = []
    for thread, spans in by_thread.items():
        spans.sort(key=lambda s: s.t_start)
        gaps += [b.t_start - ends[thread, a.attrs.get("bucket")] for a, b in zip(spans, spans[1:])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
