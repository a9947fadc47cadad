"""stage_d.build_s: seconds of ``warm_replicas``: Stage D (warm-up and CUDA
graph capture) of every bucket the tier can release, and one call of each."""


def read(run):
    return run.stage_d_s
