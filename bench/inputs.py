"""What the benchmark makes from ``--seed``: weights, the image pool, the
calibration images and the order in which the pool is sent.

Weights are drawn on the device by one ``torch.Generator`` in two calls
(every weight, then every bias): He-normal weights, ``N(0, 2 / fan_in)``,
in the program's layout (conv OIHW, dense (K, N), any other kind as its
file gives it), and biases ``N(0, BIAS_STD^2)`` so that the bias path is
held to the reference too.
The images follow from the same generator: the pool, then the
calibration images.  One seed gives the same tensors on every run.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.reference.ops import Kinds, param_shapes

BIAS_STD = 0.1
SEED_MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)


def draw_weights(gen: torch.Generator, layers: Sequence[dict],
                 input_shape: Tuple[int, ...], device,
                 kinds: Optional[Kinds] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``w`` and ``b`` of every layer whose kind has parameters, in layer
    order: the weights from one draw, then the biases (each layer's bias
    count, as its kind gives it) from a second."""
    spec = param_shapes(layers, input_shape, kinds)
    sizes = [math.prod(s) for _, s, _, _ in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    biases = torch.randn(sum(n_bias for *_, n_bias in spec),
                         generator=gen, device=device) * BIAS_STD
    params, at, bt = {}, 0, 0
    for (name, shape, fan_in, n_bias), n in zip(spec, sizes):
        params[name] = {"w": flat[at:at + n].view(shape).mul_(math.sqrt(2.0 / fan_in)),
                        "b": biases[bt:bt + n_bias]}
        at, bt = at + n, bt + n_bias
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
