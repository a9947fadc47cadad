"""kernel.dwconv_roofline_pct: the depthwise convs' share of their roofline
(``bench.layer_roofline.kind_roofline_pct``): every ``dwconv`` layer runs on
the library, one launch of ATen's own depthwise kernel a layer and replay
(its bias added inside; ``conv_depthwise2d_forward_kernel_generic`` for a
7x7, the name without the suffix for the sizes ATen specializes), a kernel
no other layer launches."""
from bench.layer_roofline import kind_roofline_pct


def read(run):
    return kind_roofline_pct(run, "dwconv", r"\bconv_depthwise2d_forward_kernel(_generic)?\b", 1)
