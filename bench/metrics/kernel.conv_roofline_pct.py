"""kernel.conv_roofline_pct: the float map-major conv kernel's share of its
roofline (``bench.roofline.kernel_roofline_pct``): one launch per routed
conv layer and replay."""
from bench.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "conv", r"\bconv_mapmajor_kernel\b", 1)
