"""tier.overlap_share: the share of the window's ``serve.dispatch`` spans
whose bucket was launched while another bucket of its replica was in flight
(``overlapped`` 1) rather than behind an idle pipeline (0); nothing where no
span says either."""


def read(run):
    flags = [s.attrs["overlapped"] for s in run.spans_named("serve.dispatch")
             if "overlapped" in s.attrs]
    return sum(f == 1 for f in flags) / len(flags) if flags else None
