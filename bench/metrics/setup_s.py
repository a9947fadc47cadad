"""setup_s: seconds from the start of bench/run.py to the window's start:
imports, CUDA's start, loading (the first run in a checkout: building) the
kernels, weights, synthesis, the bucket warm-ups and the image pool."""


def read(run):
    return run.setup_s
