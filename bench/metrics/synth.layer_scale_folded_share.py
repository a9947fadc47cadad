"""synth.layer_scale_folded_share: of the layer scales the synthesizer met
(``synthesis.fold_scale``'s ``scale``), the share it folded into the convs
before them (``folded``); nothing where no span says (a network without
layer scales, or a program without the fold)."""


def read(run):
    spans = [s for s in run.spans if s.name == "synthesis.fold_scale" and s.attrs.get("scale")]
    if not spans:
        return None
    return sum(s.attrs.get("folded", 0) for s in spans) / sum(s.attrs["scale"] for s in spans)
