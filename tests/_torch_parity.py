"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both packages; outputs come back
as float32 numpy arrays and are compared under the JAX package's rule:
rtol = mode_tolerance(mode), atol = rtol * max(|reference|, 1).  JAX is
imported only where a helper needs it, so the ``gpu`` cases run on a
machine without JAX (``pytest --noconftest -m gpu``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision import ComputeMode, mode_tolerance

FLOAT_MODES = [ComputeMode.PRECISE, ComputeMode.RELAXED, ComputeMode.IMPRECISE]


def jax_mode(mode: ComputeMode):
    from repro.core.precision import ComputeMode as JaxMode
    return JaxMode(mode.value)


def to_jax(a: np.ndarray):
    import jax.numpy as jnp
    return jnp.asarray(a)


def to_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def as_np(t) -> np.ndarray:
    """A JAX array or torch tensor (bf16 included) as float32 numpy."""
    if isinstance(t, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(t).detach().float().cpu().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(t, jnp.float32))


def assert_close(got, want, mode: ComputeMode, rtol: float = None):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = mode_tolerance(mode) if rtol is None else rtol
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


def reference_params(net, seed: int = 0, bias_scale: float = 0.1) -> dict:
    """He-normal weights for a network description (either package's), made
    with numpy and shaped by the JAX package's shape inference, with nonzero
    biases (both packages' own inits set biases to zero, which would hide
    the bias epilogue)."""
    from repro.cnn.params import infer_shapes
    rng = np.random.default_rng(seed)
    shapes = infer_shapes(net)
    params = {}
    for l in net.layers:
        if l.kind not in ("conv", "dense"):
            continue
        in_shape = shapes[l.inputs[0]]
        if l.kind == "conv":
            fan_in = in_shape[0] * l.kernel * l.kernel
            shape = (l.out_channels, in_shape[0], l.kernel, l.kernel)
        else:
            fan_in = int(np.prod(in_shape))
            shape = (fan_in, l.out_channels)
        w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        params[l.name] = {"w": w.astype(np.float32)}
        if l.use_bias:
            b = rng.standard_normal((l.out_channels,)) * bias_scale
            params[l.name]["b"] = b.astype(np.float32)
    return params


def params_to_jax(np_params: dict) -> dict:
    return {n: {k: to_jax(v) for k, v in p.items()} for n, p in np_params.items()}
