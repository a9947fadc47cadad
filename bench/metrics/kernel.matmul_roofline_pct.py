"""kernel.matmul_roofline_pct: the float map-major matmul's share of its
roofline (``bench.roofline.kernel_roofline_pct``): a split and a reduce
launch per routed dense layer and replay, timed together."""
from bench.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "dense", r"\bmatmul_mapmajor_(split|reduce)\b", 2)
