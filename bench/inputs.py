"""What the benchmark makes from ``--seed``: weights, the image pool, the
calibration images and the order in which the pool is sent.

Weights are drawn on the device by one ``torch.Generator`` in two calls
(every weight, then every bias): He-normal weights, ``N(0, 2 / fan_in)``,
in the program's layout (conv OIHW, dense (K, N)), and biases
``N(0, BIAS_STD^2)`` so that the bias path is held to the reference too.
The images follow from the same generator: the pool, then the
calibration images.  One seed gives the same tensors on every run.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from bench.reference.ops import param_shapes

BIAS_STD = 0.1
SEED_MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)


def draw_weights(gen: torch.Generator, layers: Sequence[dict],
                 input_shape: Tuple[int, ...], device) -> Dict[str, Dict[str, torch.Tensor]]:
    spec = param_shapes(layers, input_shape)
    sizes = [math.prod(s) for _, s, _ in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    biases = torch.randn(sum(s[0] if len(s) == 4 else s[1] for _, s, _ in spec),
                         generator=gen, device=device) * BIAS_STD
    params, at, bt = {}, 0, 0
    for (name, shape, fan_in), n in zip(spec, sizes):
        n_out = shape[0] if len(shape) == 4 else shape[1]
        params[name] = {"w": flat[at:at + n].view(shape).mul_(math.sqrt(2.0 / fan_in)),
                        "b": biases[bt:bt + n_out]}
        at, bt = at + n, bt + n_out
    return params


def draw_images(gen: torch.Generator, n: int, input_shape: Tuple[int, ...],
                device) -> torch.Tensor:
    """``n`` standard-normal images (n, C, H, W) in float32 on ``device``."""
    return torch.randn((n, *input_shape), generator=gen, device=device)


def pool_order(seed: int, pool: int, n: int) -> np.ndarray:
    """Pool indices of ``n`` requests: seeded permutations of the pool, one
    after another, so every image is sent as often as every other."""
    rng = np.random.default_rng([int(seed) & SEED_MASK, 1])
    reps = -(-n // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:n]
