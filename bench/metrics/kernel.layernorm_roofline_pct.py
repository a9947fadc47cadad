"""kernel.layernorm_roofline_pct: the channel LayerNorm kernel's share of
its roofline (``bench.layer_roofline.kind_roofline_pct``): one launch of
``layernorm_nchw_kernel`` a ``layernorm`` layer and replay."""
from bench.layer_roofline import kind_roofline_pct


def read(run):
    return kind_roofline_pct(run, "layernorm", r"\blayernorm_nchw_kernel\b", 1)
