"""synth.bn_folded_share: of the batch norms the synthesizer met
(``synthesis.fold_bn``'s ``bn``), the share it folded into the convs before
them (``folded``); nothing where no span says (a network without batch
norms, or a program without the fold)."""


def read(run):
    spans = [s for s in run.spans if s.name == "synthesis.fold_bn" and s.attrs.get("bn")]
    if not spans:
        return None
    return sum(s.attrs.get("folded", 0) for s in spans) / sum(s.attrs["bn"] for s in spans)
