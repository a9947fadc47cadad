"""Plain PyTorch reference of a CNN described as a table of layers.

The benchmark's own copy of each network (``bench/reference/<network>.py``)
is a list of layer records; this module infers their shapes, draws nothing
and imports nothing of the program under test.  The forward pass runs in
float32 with TF32 off, one library call per layer, at the precision a
configuration states:

  float32   every value in float32 (a PRECISE configuration);
  bfloat16  bf16 operands and activations with float32 accumulation (a
            RELAXED one): the images and the weights are rounded to bf16,
            a convolution or a dense layer multiplies them exactly and sums
            in float32, adds the float32 bias and rounds its output to bf16
            once; a normalization or a mean computes in float32 from bf16
            values and rounds its output; pooling, ReLU, concatenation and
            flattening are exact.  The logits are bf16.

The layers:

  conv      ``F.conv2d`` after an explicit pad; SAME pads ``total // 2``
            low and the rest high (out = ceil(in / stride)), VALID none;
  maxpool   the same split, padded with ``-inf``;
  lrn       across channels, ``x / (1 + alpha / size * sum x^2) ** beta``
            over a window of ``size`` channels centred on each one;
  dense     ``x @ w + b`` with ``w`` of shape (K, N);
  gap       the mean over H and W;  flatten  NCHW order;
  concat    along channels;  softmax  returned as log-probabilities.

Weights use the layout the program takes: conv ``w`` (O, I, K, K), dense
``w`` (K, N), each with a bias ``b``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Layer = Dict[str, object]


def layer(name: str, kind: str, inputs: Sequence[str], **attrs) -> Layer:
    return {"name": name, "kind": kind, "inputs": tuple(inputs), **attrs}


def chain(layers: List[Layer], name: str, kind: str, inputs=None, **attrs) -> str:
    """Append a layer fed by ``inputs`` (default: the previous layer)."""
    ins = inputs if inputs is not None else (layers[-1]["name"] if layers else "input",)
    layers.append(layer(name, kind, ins, **attrs))
    return name


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _out_hw(h: int, k: int, stride: int, padding: str) -> int:
    return -(-h // stride) if padding == "SAME" else (h - k) // stride + 1


def shapes(layers: Sequence[Layer], input_shape: Tuple[int, ...]
           ) -> Dict[str, Tuple[int, ...]]:
    """Output shape of every layer, batch excluded: (C, H, W) or (F,)."""
    out: Dict[str, Tuple[int, ...]] = {"input": tuple(input_shape)}
    for l in layers:
        ins = [out[i] for i in l["inputs"]]
        s = ins[0]
        kind = l["kind"]
        if kind == "conv":
            out[l["name"]] = (l["out"], _out_hw(s[1], l["k"], l["stride"], l["padding"]),
                              _out_hw(s[2], l["k"], l["stride"], l["padding"]))
        elif kind == "maxpool":
            out[l["name"]] = (s[0], _out_hw(s[1], l["pool"], l["stride"], l["padding"]),
                              _out_hw(s[2], l["pool"], l["stride"], l["padding"]))
        elif kind in ("relu", "lrn", "softmax"):
            out[l["name"]] = s
        elif kind == "gap":
            out[l["name"]] = (s[0],)
        elif kind == "flatten":
            out[l["name"]] = (math.prod(s),)
        elif kind == "dense":
            out[l["name"]] = (l["out"],)
        elif kind == "concat":
            out[l["name"]] = (sum(i[0] for i in ins),) + s[1:]
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return out


def param_shapes(layers: Sequence[Layer], input_shape: Tuple[int, ...]
                 ) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(layer, weight shape, fan-in) of every conv and dense layer, in order."""
    sh = shapes(layers, input_shape)
    result = []
    for l in layers:
        if l["kind"] == "conv":
            cin = sh[l["inputs"][0]][0]
            result.append((l["name"], (l["out"], cin, l["k"], l["k"]), cin * l["k"] ** 2))
        elif l["kind"] == "dense":
            fan_in = math.prod(sh[l["inputs"][0]])
            result.append((l["name"], (fan_in, l["out"]), fan_in))
    return result


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    h0, h1 = same_pads(x.shape[2], k, stride)
    w0, w1 = same_pads(x.shape[3], k, stride)
    return F.pad(x, (w0, w1, h0, h1), value=value)


#: The kinds whose output the stated precision rounds (the rest are exact).
ROUNDED = ("conv", "dense", "lrn", "gap")


def _apply(l: Layer, p, ins: List[torch.Tensor], q) -> torch.Tensor:
    x = ins[0]
    kind = l["kind"]
    if kind == "conv":
        if l["padding"] == "SAME":
            x = _pad_same(x, l["k"], l["stride"])
        return F.conv2d(x, q(p["w"]), p["b"], stride=l["stride"])
    if kind == "dense":
        return torch.addmm(p["b"], x.reshape(x.shape[0], -1), q(p["w"]))
    if kind == "relu":
        return torch.relu(x)
    if kind == "maxpool":
        if l["padding"] == "SAME":
            x = _pad_same(x, l["pool"], l["stride"], float("-inf"))
        return F.max_pool2d(x, l["pool"], l["stride"])
    if kind == "lrn":
        size, half = l["size"], l["size"] // 2
        sq = F.pad(x.square(), (0, 0, 0, 0, half, half))
        window = sum(sq[:, i:i + x.shape[1]] for i in range(size))
        return x / torch.pow(1.0 + (l["alpha"] / size) * window, l["beta"])
    if kind == "gap":
        return x.mean(dim=(2, 3))
    if kind == "flatten":
        return x.reshape(x.shape[0], -1)
    if kind == "concat":
        return torch.cat(ins, dim=1)
    if kind == "softmax":
        return torch.log_softmax(x.double(), dim=-1)
    raise ValueError(f"unknown layer kind {kind!r}")


PRECISIONS = ("float32", "bfloat16")


@torch.no_grad()
def forward(layers: Sequence[Layer], params, x: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """The network's last layer for images ``x`` (N, C, H, W) at ``precision``
    (``PRECISIONS``), computed in float32 with TF32 off; a closing softmax
    comes back as float64 log-probabilities."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    q = (lambda t: t.bfloat16().float()) if precision == "bfloat16" else (lambda t: t)
    acts = {"input": q(x.float())}
    with no_tf32():
        for l in layers:
            y = _apply(l, params.get(l["name"]), [acts[i] for i in l["inputs"]], q)
            acts[l["name"]] = q(y) if l["kind"] in ROUNDED else y
    return acts[layers[-1]["name"]]
