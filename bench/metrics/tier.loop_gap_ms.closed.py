"""tier.loop_gap_ms.closed: mean ms on one replica's thread from the end of a
``serve.dispatch`` span to the start of the next (the loop's take, its locks
and wake-ups), over the window's consecutive pairs."""


def read(run):
    by_thread = {}
    for s in run.spans_named("serve.dispatch"):
        by_thread.setdefault(s.thread, []).append(s)
    gaps = []
    for spans in by_thread.values():
        spans.sort(key=lambda s: s.t_start)
        gaps += [b.t_start - a.t_end for a, b in zip(spans, spans[1:])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
