"""Synthetic ImageNet-like images (no network access, no datasets).

The counterpart of ``repro.data.synthetic.imagenet_like``: each class has its
own spatial frequency and angle, plus per-image colour shift and pixel
noise, so classification is learnable and sensitive to precision.  Drawn
from a ``torch.Generator`` on the CPU and placed on ``device``, so a seed
gives the same images on every device (not the JAX package's bits).
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from ..device.profile import torch_device


def imagenet_like(generator: Union[torch.Generator, int], n: int, *,
                  hw: int = 64, num_classes: int = 10,
                  device: "str | torch.device | None" = "cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (n, 3, hw, hw) f32, labels (n,) int64)."""
    dev = torch_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    labels = torch.randint(0, num_classes, (n,), generator=generator)
    yy, xx = torch.meshgrid(torch.arange(hw, dtype=torch.float32),
                            torch.arange(hw, dtype=torch.float32), indexing="ij")
    lab = labels.float()[:, None, None]
    freqs = lab + 1
    angle = lab * (math.pi / num_classes)
    pattern = torch.sin((xx * torch.cos(angle) + yy * torch.sin(angle))
                        * freqs * (2 * math.pi / hw))
    base = pattern[:, None].repeat(1, 3, 1, 1)
    chroma = torch.randn((n, 3, 1, 1), generator=generator) * 0.1
    noise = torch.randn((n, 3, hw, hw), generator=generator) * 0.25
    return (base + chroma + noise).to(dev), labels.to(dev)
