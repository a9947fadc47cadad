"""model.mfu_pct: the FLOPs of the images answered in the window (2 x the
multiply-adds of every conv and dense layer, padding slots left out) over
the window's seconds at the H100's dense bf16 peak."""
from bench.roofline import BF16_FLOPS, flops_per_image


def read(run):
    flops = run.completed_in_window * flops_per_image(run.layers, run.input_shape, run.kinds)
    return 100.0 * flops / (run.seconds * BF16_FLOPS) if flops else None
