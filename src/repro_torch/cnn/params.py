"""Weights ("model file") for the network DAGs: shapes, He init, hand-over.

``init_network_params`` draws He-initialized weights from a
``torch.Generator`` on the CPU and moves them to ``device``, so one seed
gives the same weights on every device.  ``params_from_numpy`` carries
weights made elsewhere (the JAX package's, handed over as numpy arrays in
the parity tests) into the port's dict of tensors; a prepared int8 weight
travels as the pair ``(q, scale)`` and arrives as a
:class:`~repro_torch.core.precision.QuantizedTensor`.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..core.network import NetworkDescription
from ..core.precision import QuantizedTensor
from ..device.profile import torch_device

Params = Dict[str, Dict[str, torch.Tensor]]


def _pool_out(h: int, size: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-h // stride)
    return (h - size) // stride + 1


def infer_shapes(net: NetworkDescription) -> Dict[str, Tuple[int, ...]]:
    """Per-layer output shapes (excluding batch)."""
    shapes: Dict[str, Tuple[int, ...]] = {"input": net.input_shape}
    for l in net.layers:
        ins = [shapes[i] for i in l.inputs]
        s = ins[0]
        if l.kind == "conv":
            _, h, w = s
            shapes[l.name] = (l.out_channels,
                              _pool_out(h, l.kernel, l.stride, l.padding),
                              _pool_out(w, l.kernel, l.stride, l.padding))
        elif l.kind == "dwconv":
            c, h, w = s
            shapes[l.name] = (c, _pool_out(h, l.kernel, l.stride, l.padding),
                              _pool_out(w, l.kernel, l.stride, l.padding))
        elif l.kind in ("relu", "lrn", "softmax", "bn", "layernorm", "gelu",
                        "scale"):
            shapes[l.name] = s
        elif l.kind == "add":
            if len(ins) != 2 or ins[0] != ins[1]:
                raise ValueError(f"{net.name}: add {l.name} needs two inputs of "
                                 f"one shape, got {ins}")
            shapes[l.name] = s
        elif l.kind == "pad":
            c, h, w = s
            shapes[l.name] = (c, h + sum(l.pads), w + sum(l.pads))
        elif l.kind in ("maxpool", "avgpool"):
            c, h, w = s
            shapes[l.name] = (c, _pool_out(h, l.pool_size, l.stride, l.padding),
                              _pool_out(w, l.pool_size, l.stride, l.padding))
        elif l.kind == "gap":
            shapes[l.name] = (s[0],)
        elif l.kind == "flatten":
            shapes[l.name] = (int(math.prod(s)),)
        elif l.kind == "dense":
            shapes[l.name] = (l.out_channels,)
        elif l.kind == "concat":
            shapes[l.name] = (sum(i[0] for i in ins),) + s[1:]
        else:
            raise ValueError(l.kind)
        if any(d <= 0 for d in shapes[l.name]):
            raise ValueError(
                f"{net.name}: layer {l.name} output shape {shapes[l.name]} "
                f"degenerate — input_hw too small for this topology")
    return shapes


def init_network_params(net: NetworkDescription,
                        generator: Union[torch.Generator, int],
                        device: "str | torch.device | None" = "cuda",
                        dtype: torch.dtype = torch.float32) -> Params:
    """He-normal weights (OIHW conv, (C, 1, K, K) dwconv, (K, N) dense) and
    zero biases, drawn on the CPU from ``generator`` (or a seed) and placed
    on ``device``; a ``bn`` or ``layernorm`` gets the identity (scale 1,
    shift 0) and a ``scale`` the factor 1, as fresh ones are."""
    dev = torch_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    shapes = infer_shapes(net)
    params: Params = {}
    for l in net.param_layers:
        in_shape = shapes[l.inputs[0]]
        if l.kind == "conv":
            cin = in_shape[0]
            shape = (l.out_channels, cin, l.kernel, l.kernel)
            fan_in = cin * l.kernel * l.kernel
        elif l.kind == "dwconv":
            shape = (in_shape[0], 1, l.kernel, l.kernel)
            fan_in = l.kernel * l.kernel
        else:
            fan_in = int(math.prod(in_shape))
            shape = (fan_in, l.out_channels)
        w = torch.randn(shape, generator=generator, dtype=torch.float32) \
            * math.sqrt(2.0 / fan_in)
        p = {"w": w.to(device=dev, dtype=dtype)}
        if l.use_bias:
            p["b"] = torch.zeros((shape[0] if l.kind == "dwconv" else l.out_channels,),
                                 dtype=dtype, device=dev)
        params[l.name] = p
    for l in net.layers:
        c = shapes[l.name][0]
        if l.kind in ("bn", "layernorm"):
            params[l.name] = {"w": torch.ones((c,), dtype=dtype, device=dev),
                              "b": torch.zeros((c,), dtype=dtype, device=dev)}
        elif l.kind == "scale":
            params[l.name] = {"w": torch.ones((c,), dtype=dtype, device=dev)}
    return params


def params_from_numpy(np_params: Mapping[str, Mapping[str, object]],
                      device: "str | torch.device | None" = "cuda") -> Params:
    """{layer: {"w": array, "b": array}} of numpy arrays -> the port's dict
    of tensors on ``device``, values and dtypes unchanged.  A value that is
    a pair ``(q, scale)`` (int8 payload, f32 scales) becomes a
    :class:`QuantizedTensor`."""
    dev = torch_device(device)

    def carry(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {name: {k: (QuantizedTensor(q=carry(v[0]), scale=carry(v[1]))
                       if isinstance(v, tuple) else carry(v))
                   for k, v in p.items()}
            for name, p in np_params.items()}
