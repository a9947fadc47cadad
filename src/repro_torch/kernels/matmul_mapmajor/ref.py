"""Library oracle for the compute-mode matmul kernel."""
from __future__ import annotations

import torch

from ...core.precision import ComputeMode, mode_dot


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
               mode: ComputeMode = ComputeMode.RELAXED) -> torch.Tensor:
    return mode_dot(a, b, mode)
