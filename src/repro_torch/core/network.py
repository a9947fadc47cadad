"""Network description (Cappuccino input #1) and the planned executor.

The counterpart of ``repro.core.network``: a framework-neutral DAG of layers
(plain data) and :func:`run_network` / :func:`collect_activations`, which
evaluate it on PyTorch tensors under an execution plan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .precision import ComputeMode


@dataclass(frozen=True)
class Layer:
    name: str
    kind: str                      # conv, relu, maxpool, avgpool, gap, lrn,
                                   # dense, flatten, concat, softmax, add,
                                   # bn, pad, dwconv, layernorm, gelu, scale
    inputs: Tuple[str, ...] = ()
    out_channels: int = 0
    kernel: int = 0
    stride: int = 1
    padding: str = "VALID"
    use_bias: bool = True
    pool_size: int = 0
    lrn_size: int = 5
    lrn_alpha: float = 1e-4
    lrn_beta: float = 0.75

    @property
    def has_params(self) -> bool:
        """Whether the layer multiplies by weights (conv, dense, dwconv).  A
        ``bn`` or ``layernorm`` carries a per-channel scale and shift instead
        (``w``, ``b``), a ``scale`` its per-channel factor (``w``)."""
        return self.kind in ("conv", "dense", "dwconv")

    @property
    def pads(self) -> Tuple[int, int]:
        """A ``pad`` layer's zeros before and after each spatial dimension:
        TF's ``fixed_padding`` for a following ``kernel`` x ``kernel`` conv."""
        total = self.kernel - 1
        return total // 2, total - total // 2

    @property
    def is_inexactable(self) -> bool:
        """Layers whose arithmetic mode the selector tunes."""
        return self.has_params

    @property
    def attrs(self) -> Tuple[object, ...]:
        """The fields of a ConvNeXt kind that change what it computes beyond
        its weights, for the fusion digest: a ``dwconv``'s kernel, stride
        and padding (a :class:`LayerNormLayer` adds its epsilon); empty for
        every other kind."""
        if self.kind == "dwconv":
            return (self.kernel, self.stride, self.padding)
        return ()


@dataclass(frozen=True)
class LayerNormLayer(Layer):
    """A ``layernorm`` layer: a :class:`Layer` with its epsilon, a field of
    its own class so that every other kind's layer keeps the JAX package's
    fields."""
    eps: float = 1e-6

    @property
    def attrs(self) -> Tuple[object, ...]:
        return (self.eps,)


def make_layer(**fields) -> Layer:
    """A layer of the class its ``kind`` takes (:class:`LayerNormLayer` for
    a ``layernorm``)."""
    return (LayerNormLayer if fields.get("kind") == "layernorm" else Layer)(**fields)


@dataclass
class NetworkDescription:
    name: str
    input_shape: Tuple[int, ...]            # (C, H, W), batch excluded
    layers: List[Layer] = field(default_factory=list)

    def __post_init__(self):
        names = [l.name for l in self.layers]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate layer names in {self.name}")

    def _tail(self) -> str:
        return self.layers[-1].name if self.layers else "input"

    def add(self, layer: Layer) -> str:
        self.layers.append(layer)
        return layer.name

    def conv(self, name, out_channels, kernel, stride=1, padding="SAME",
             inputs=None, use_bias=True):
        return self.add(Layer(name, "conv", tuple(inputs or (self._tail(),)),
                              out_channels=out_channels, kernel=kernel,
                              stride=stride, padding=padding, use_bias=use_bias))

    def relu(self, name, inputs=None):
        return self.add(Layer(name, "relu", tuple(inputs or (self._tail(),))))

    def maxpool(self, name, pool_size, stride, padding="VALID", inputs=None):
        return self.add(Layer(name, "maxpool", tuple(inputs or (self._tail(),)),
                              pool_size=pool_size, stride=stride, padding=padding))

    def avgpool(self, name, pool_size, stride, padding="VALID", inputs=None):
        return self.add(Layer(name, "avgpool", tuple(inputs or (self._tail(),)),
                              pool_size=pool_size, stride=stride, padding=padding))

    def gap(self, name, inputs=None):
        return self.add(Layer(name, "gap", tuple(inputs or (self._tail(),))))

    def lrn(self, name, size=5, alpha=1e-4, beta=0.75, inputs=None):
        return self.add(Layer(name, "lrn", tuple(inputs or (self._tail(),)),
                              lrn_size=size, lrn_alpha=alpha, lrn_beta=beta))

    def dense(self, name, out_channels, inputs=None, use_bias=True):
        return self.add(Layer(name, "dense", tuple(inputs or (self._tail(),)),
                              out_channels=out_channels, use_bias=use_bias))

    def flatten(self, name, inputs=None):
        return self.add(Layer(name, "flatten", tuple(inputs or (self._tail(),))))

    def concat(self, name, inputs):
        return self.add(Layer(name, "concat", tuple(inputs)))

    def softmax(self, name, inputs=None):
        return self.add(Layer(name, "softmax", tuple(inputs or (self._tail(),))))

    def residual(self, name, inputs):
        """``add``: the elementwise sum of two activations of one shape."""
        return self.add(Layer(name, "add", tuple(inputs)))

    def bn(self, name, inputs=None):
        """Inference batch norm as ``x * w[c] + b[c]`` (scale and shift)."""
        return self.add(Layer(name, "bn", tuple(inputs or (self._tail(),))))

    def pad(self, name, kernel, inputs=None):
        """Zero padding for a following ``kernel`` x ``kernel`` VALID conv
        (:attr:`Layer.pads`)."""
        return self.add(Layer(name, "pad", tuple(inputs or (self._tail(),)),
                              kernel=kernel))

    def dwconv(self, name, kernel, stride=1, padding="SAME", inputs=None):
        """Depthwise conv: one ``kernel`` x ``kernel`` filter per channel,
        weights (C, 1, K, K) and a bias (``w``, ``b``)."""
        return self.add(Layer(name, "dwconv", tuple(inputs or (self._tail(),)),
                              kernel=kernel, stride=stride, padding=padding))

    def layernorm(self, name, eps=1e-6, inputs=None):
        """LayerNorm over the channels at each pixel (or over a vector):
        biased variance plus ``eps``, then ``* w[c] + b[c]``."""
        return self.add(LayerNormLayer(name, "layernorm",
                                       tuple(inputs or (self._tail(),)), eps=eps))

    def gelu(self, name, inputs=None):
        """GELU in its exact form, ``x * Phi(x)`` (the erf)."""
        return self.add(Layer(name, "gelu", tuple(inputs or (self._tail(),))))

    def scale(self, name, inputs=None):
        """Per-channel scale ``x * w[c]`` with no shift (a layer scale)."""
        return self.add(Layer(name, "scale", tuple(inputs or (self._tail(),))))

    @property
    def param_layers(self) -> List[Layer]:
        return [l for l in self.layers if l.has_params]

    @property
    def inexactable_layers(self) -> List[str]:
        return [l.name for l in self.layers if l.is_inexactable]


def _resolve_plan(net: NetworkDescription, plan, modes):
    from .plan import ExecutionPlan

    if plan is not None:
        return plan.with_modes(modes) if modes else plan
    return ExecutionPlan.uniform(net, modes=modes)


def _execute(net: NetworkDescription, params, x, plan) -> Dict[str, torch.Tensor]:
    """Dispatch the network under its plan: group by group when the plan
    carries a graph program, else layer by layer.  Returns the materialized
    activations by name."""
    if plan.graph is not None:
        from .graph import execute_graph
        return execute_graph(plan.graph, plan, params, x)

    from .layer_ops import apply_layer

    acts: Dict[str, torch.Tensor] = {"input": x}
    for layer in net.layers:
        ins = [acts[i] for i in layer.inputs]
        acts[layer.name] = apply_layer(layer, plan.for_layer(layer.name),
                                       params.get(layer.name), ins)
    return acts


@torch.no_grad()
def run_network(net: NetworkDescription, params: Dict[str, Dict[str, torch.Tensor]],
                x: torch.Tensor, *,
                modes: Optional[Dict[str, ComputeMode]] = None,
                plan=None) -> torch.Tensor:
    """Evaluate the DAG under an :class:`~repro_torch.core.plan.ExecutionPlan`
    (default: the uniform ``"xla"`` plan); ``modes`` overlays the plan's."""
    eff = _resolve_plan(net, plan, modes or {})
    return _execute(net, params, x, eff)[net.layers[-1].name]


@torch.no_grad()
def collect_activations(net: NetworkDescription, params, x: torch.Tensor, *,
                        plan=None,
                        modes: Optional[Dict[str, ComputeMode]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Run the planned executor keeping every materialized activation (under
    a graph plan: every group output)."""
    eff = _resolve_plan(net, plan, modes or {})
    return _execute(net, params, x, eff)
