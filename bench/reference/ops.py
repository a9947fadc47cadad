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

The nine kinds built in here:

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

Any other kind is a file of its own, ``bench/reference/kinds/<kind>.py`` in
the checkout (:class:`Kinds`), which states its semantics and its precision
rule in its docstring and gives what a built-in kind gives (:class:`Kind`):

  shape(layer, in_shapes)         the output shape, batch excluded;
  params(layer, in_shapes)        None, or (weight shape in the program's
                                  layout, fan-in, bias count);
  apply(layer, p, xs, q)          the float32 forward from the operands
                                  ``xs`` (already rounded), with ``q`` the
                                  precision's rounding for the weights;
  ROUNDED                         whether the stated precision rounds the
                                  output;
  work(layer, in_shapes, out)     None, or (FLOPs, activation elements) of
                                  one image, for ``bench/roofline.py``.

A kind file may use the helpers here: ``same_pads``, ``out_hw``,
``pad_same`` and ``window_shape``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import math
from pathlib import Path
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Layer = Dict[str, object]
#: Where a checkout keeps its kind files, under its root.
KINDS_DIR = Path("bench") / "reference" / "kinds"


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


def out_hw(h: int, k: int, stride: int, padding: str) -> int:
    return -(-h // stride) if padding == "SAME" else (h - k) // stride + 1


def window_shape(l: Layer, ins: Sequence[Tuple[int, ...]], k: int) -> Tuple[int, int, int]:
    """(C, H, W) out of a k x k window at the layer's stride and padding."""
    s = ins[0]
    return (s[0], out_hw(s[1], k, l["stride"], l["padding"]),
            out_hw(s[2], k, l["stride"], l["padding"]))


def pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    h0, h1 = same_pads(x.shape[2], k, stride)
    w0, w1 = same_pads(x.shape[3], k, stride)
    return F.pad(x, (w0, w1, h0, h1), value=value)


def _none(*_):
    return None


class Kind(NamedTuple):
    """One layer kind: the functions listed in the module's docstring (a
    built-in kind without parameters or counted work leaves them out)."""
    shape: Callable
    apply: Callable
    ROUNDED: bool = False
    params: Callable = _none
    work: Callable = _none


def _conv_apply(l, p, xs, q):
    x = xs[0]
    if l["padding"] == "SAME":
        x = pad_same(x, l["k"], l["stride"])
    return F.conv2d(x, q(p["w"]), p["b"], stride=l["stride"])


def _maxpool_apply(l, p, xs, q):
    x = xs[0]
    if l["padding"] == "SAME":
        x = pad_same(x, l["pool"], l["stride"], float("-inf"))
    return F.max_pool2d(x, l["pool"], l["stride"])


def _lrn_apply(l, p, xs, q):
    x = xs[0]
    size, half = l["size"], l["size"] // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, half))
    window = sum(sq[:, i:i + x.shape[1]] for i in range(size))
    return x / torch.pow(1.0 + (l["alpha"] / size) * window, l["beta"])


def _conv_params(l, ins):
    cin = ins[0][0]
    return (l["out"], cin, l["k"], l["k"]), cin * l["k"] ** 2, l["out"]


def _dense_params(l, ins):
    fan_in = math.prod(ins[0])
    return (fan_in, l["out"]), fan_in, l["out"]


BUILTIN: Dict[str, Kind] = {
    "conv": Kind(
        shape=lambda l, ins: (l["out"],) + window_shape(l, ins, l["k"])[1:],
        apply=_conv_apply, ROUNDED=True, params=_conv_params,
        work=lambda l, ins, out: (2 * math.prod(out) * ins[0][0] * l["k"] ** 2,
                                  math.prod(ins[0]) + math.prod(out))),
    "dense": Kind(
        shape=lambda l, ins: (l["out"],),
        apply=lambda l, p, xs, q: torch.addmm(p["b"], xs[0].reshape(xs[0].shape[0], -1),
                                              q(p["w"])),
        ROUNDED=True, params=_dense_params,
        work=lambda l, ins, out: (2 * math.prod(ins[0]) * out[0], math.prod(ins[0]) + out[0])),
    "relu": Kind(shape=lambda l, ins: ins[0], apply=lambda l, p, xs, q: torch.relu(xs[0])),
    "maxpool": Kind(shape=lambda l, ins: window_shape(l, ins, l["pool"]), apply=_maxpool_apply),
    "lrn": Kind(shape=lambda l, ins: ins[0], apply=_lrn_apply, ROUNDED=True),
    "gap": Kind(shape=lambda l, ins: (ins[0][0],),
                apply=lambda l, p, xs, q: xs[0].mean(dim=(2, 3)), ROUNDED=True),
    "flatten": Kind(shape=lambda l, ins: (math.prod(ins[0]),),
                    apply=lambda l, p, xs, q: xs[0].reshape(xs[0].shape[0], -1)),
    "concat": Kind(shape=lambda l, ins: (sum(i[0] for i in ins),) + ins[0][1:],
                   apply=lambda l, p, xs, q: torch.cat(xs, dim=1)),
    "softmax": Kind(shape=lambda l, ins: ins[0],
                    apply=lambda l, p, xs, q: torch.log_softmax(xs[0].double(), dim=-1)),
}


class Kinds:
    """The layer kinds of one checkout: the nine built in here, then
    ``bench/reference/kinds/<kind>.py`` under ``root`` (by default the
    checkout this module is in), each file loaded once by this object and
    by no other, so one checkout's kinds never reach another's."""

    def __init__(self, root: Optional[Path] = None):
        root = Path(__file__).resolve().parents[2] if root is None else Path(root)
        self.dir = root / KINDS_DIR
        self._files: Dict[str, Kind] = {}

    def __getitem__(self, kind: str) -> Kind:
        if kind in BUILTIN:
            return BUILTIN[kind]
        if kind not in self._files:
            self._files[kind] = self._load(kind)
        return self._files[kind]

    def _load(self, kind: str) -> Kind:
        path = self.dir / f"{kind}.py"
        if not kind.isidentifier() or not path.is_file():
            raise FileNotFoundError(f"unknown layer kind {kind!r}: no file {path}")
        spec = importlib.util.spec_from_file_location(f"bench_kind_{kind}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        missing = [f for f in Kind._fields if not hasattr(module, f)]
        if missing:
            raise AttributeError(f"{path} lacks {', '.join(missing)}")
        return Kind(**{f: getattr(module, f) for f in Kind._fields})


def _kinds(kinds: Optional[Kinds]) -> Kinds:
    return Kinds() if kinds is None else kinds


def shapes(layers: Sequence[Layer], input_shape: Tuple[int, ...],
           kinds: Optional[Kinds] = None) -> Dict[str, Tuple[int, ...]]:
    """Output shape of every layer, batch excluded: (C, H, W) or (F,)."""
    kinds = _kinds(kinds)
    out: Dict[str, Tuple[int, ...]] = {"input": tuple(input_shape)}
    for l in layers:
        out[l["name"]] = tuple(kinds[l["kind"]].shape(l, [out[i] for i in l["inputs"]]))
    return out


def param_shapes(layers: Sequence[Layer], input_shape: Tuple[int, ...],
                 kinds: Optional[Kinds] = None
                 ) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """(layer, weight shape, fan-in, bias count) of every layer whose kind
    has parameters, in order."""
    kinds = _kinds(kinds)
    sh = shapes(layers, input_shape, kinds)
    result = []
    for l in layers:
        p = kinds[l["kind"]].params(l, [sh[i] for i in l["inputs"]])
        if p is not None:
            result.append((l["name"], tuple(p[0]), p[1], p[2]))
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


PRECISIONS = ("float32", "bfloat16")


@torch.no_grad()
def forward(layers: Sequence[Layer], params, x: torch.Tensor,
            precision: str = "float32", kinds: Optional[Kinds] = None) -> torch.Tensor:
    """The network's last layer for images ``x`` (N, C, H, W) at ``precision``
    (``PRECISIONS``), computed in float32 with TF32 off; a closing softmax
    comes back as float64 log-probabilities."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    kinds = _kinds(kinds)
    q = (lambda t: t.bfloat16().float()) if precision == "bfloat16" else (lambda t: t)
    acts = {"input": q(x.float())}
    with no_tf32():
        for l in layers:
            kind = kinds[l["kind"]]
            y = kind.apply(l, params.get(l["name"]), [acts[i] for i in l["inputs"]], q)
            acts[l["name"]] = q(y) if kind.ROUNDED else y
    return acts[layers[-1]["name"]]
