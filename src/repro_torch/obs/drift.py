"""Cost-model drift: predicted roofline latency vs measured dispatch time.

The counterpart of ``repro.obs.drift``.  For every parametric dispatch group
:func:`measure_drift` takes

* **predicted**: the planner's roofline estimate
  (:func:`repro_torch.core.planner.predict_group_seconds`, the
  :class:`~repro_torch.core.planner.LayerCost` rule 3 routed on, fused-group
  FLOP/byte ratio included), and
* **measured**: the wall time of the same dispatch unit
  (:func:`~repro_torch.core.layer_ops.apply_group` on the group's real input
  activation), min-of-``reps``, read on the registry's clock with the
  device synchronize inside the timed region.  On the card the unit is the
  group captured in one CUDA graph and each rep one replay (the port's
  counterpart of a jitted executable; eager timing there would measure the
  host's per-op dispatch); off it, eager calls.

and reports the per-group error.  Systematic drift (every group 10x off)
means the :class:`~repro_torch.device.DeviceProfile` numbers are wrong for
this card; selective drift (one group far off) means the cost model
mis-shapes that layer.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional

from .metrics import MetricsRegistry
from .trace import Tracer

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.synthesizer import SynthesizedProgram


@dataclass(frozen=True)
class GroupDrift:
    """One row of the drift table: a dispatch group's prediction error."""
    group: str
    kind: str                  # anchor layer kind ("conv" / "dense")
    impl: str                  # planned implementation ("xla" / "cuda_mapmajor")
    mode: str                  # planned compute mode
    predicted_s: float
    measured_s: float

    @property
    def ratio(self) -> float:
        """measured / predicted — 1.0 is a perfect model."""
        return self.measured_s / self.predicted_s if self.predicted_s else \
            float("inf")

    @property
    def error_pct(self) -> float:
        """Signed relative error in percent: +100 means the group ran at
        twice the predicted latency."""
        if not self.predicted_s:
            return float("inf")
        return (self.measured_s - self.predicted_s) / self.predicted_s * 100.0

    def as_dict(self) -> dict:
        return {"group": self.group, "kind": self.kind, "impl": self.impl,
                "mode": self.mode, "predicted_s": self.predicted_s,
                "measured_s": self.measured_s, "ratio": self.ratio,
                "error_pct": self.error_pct}


@dataclass
class DriftReport:
    """Per-group drift rows plus the aggregate a dashboard would alert on."""
    net_name: str
    batch: int
    groups: List[GroupDrift] = field(default_factory=list)

    @property
    def mean_abs_error_pct(self) -> float:
        if not self.groups:
            return float("nan")
        return sum(abs(g.error_pct) for g in self.groups) / len(self.groups)

    @property
    def worst(self) -> Optional[GroupDrift]:
        return max(self.groups, key=lambda g: abs(g.error_pct)) \
            if self.groups else None

    def as_dict(self) -> dict:
        return {"net": self.net_name, "batch": self.batch,
                "mean_abs_error_pct": self.mean_abs_error_pct,
                "groups": [g.as_dict() for g in self.groups]}

    def table(self) -> str:
        """The predicted-vs-measured table ``program.report()`` prints."""
        header = (f"{'group':<24} {'kind':<6} {'impl':<13} {'mode':<14} "
                  f"{'predicted':>11} {'measured':>11} {'ratio':>7} "
                  f"{'err%':>8}")
        lines = [f"cost-model drift (batch={self.batch}):", header,
                 "-" * len(header)]
        for g in self.groups:
            lines.append(
                f"{g.group:<24} {g.kind:<6} {g.impl:<13} {g.mode:<14} "
                f"{g.predicted_s * 1e6:>9.1f}us {g.measured_s * 1e6:>9.1f}us "
                f"{g.ratio:>7.2f} {g.error_pct:>+7.1f}%")
        if self.groups:
            lines.append(f"mean |error|: {self.mean_abs_error_pct:.1f}%")
        else:
            lines.append("(no parametric groups)")
        return "\n".join(lines)

    def record_to(self, registry: MetricsRegistry) -> None:
        """Publish the rows as ``plan_drift_*`` gauge series."""
        pred = registry.gauge(
            "plan_drift_predicted_seconds",
            "Planner roofline prediction per dispatch group", ("group",))
        meas = registry.gauge(
            "plan_drift_measured_seconds",
            "Measured per-group dispatch latency", ("group",))
        err = registry.gauge(
            "plan_drift_error_pct",
            "Signed relative prediction error per group (percent)",
            ("group",))
        for g in self.groups:
            pred.set(g.predicted_s, group=g.group)
            meas.set(g.measured_s, group=g.group)
            err.set(g.error_pct, group=g.group)


def measure_drift(program: "SynthesizedProgram", x=None, *,
                  batch: int = 1, reps: int = 3,
                  registry: Optional[MetricsRegistry] = None,
                  tracer: Optional[Tracer] = None) -> DriftReport:
    """Measure per-group dispatch latency and diff it against the plan.

    ``x`` defaults to zeros of shape ``(batch, *net.input_shape)`` on the
    program's device (drift is a latency property, not an accuracy one);
    pass real images to reuse a batch (its leading dimension then defines
    ``batch``).  With ``registry=`` the rows are also published as
    ``plan_drift_*`` gauges and timed on the registry's clock; with
    ``tracer=`` each group's timing runs under an ``obs.drift_probe`` span.
    """
    import torch

    from ..core.capture import time_dispatch
    from ..core.layer_ops import apply_group, apply_layer
    from ..core.network import collect_activations
    from ..core.planner import predict_group_seconds

    net, plan = program.net, program.plan
    if x is None:
        x = torch.zeros((batch, *net.input_shape), dtype=program.input_dtype,
                        device=program.device)
    else:
        batch = int(x.shape[0])
    clock = registry.clock if registry is not None else time.perf_counter
    predicted = predict_group_seconds(net, plan, batch=batch)
    acts = collect_activations(net, program.prepared, x, plan=plan)

    report = DriftReport(net_name=net.name, batch=batch)
    if plan.graph is not None:
        units = [(g, g.anchor) for g in plan.graph.groups]
    else:
        units = [(None, l) for l in net.layers]
    for group, anchor in units:
        name = group.name if group is not None else anchor.name
        if name not in predicted:
            continue
        lp = plan.for_layer(name)
        if group is not None:
            gplan = plan.for_group(group)
            ins = [acts[i] for i in group.inputs]

            def run(*a, g=group, gp=gplan):
                return apply_group(g, gp, program.prepared, list(a))
        else:
            ins = [acts[i] for i in anchor.inputs]

            def run(*a, l=anchor, p=lp):
                return apply_layer(l, p, program.prepared.get(l.name), list(a))
        if tracer is not None:
            with tracer.span("obs.drift_probe", group=name, reps=reps):
                measured = time_dispatch(run, ins, reps, clock)
        else:
            measured = time_dispatch(run, ins, reps, clock)
        report.groups.append(GroupDrift(
            group=name, kind=anchor.kind, impl=lp.impl, mode=lp.mode.value,
            predicted_s=predicted[name], measured_s=measured))
    if registry is not None:
        report.record_to(registry)
    program.drift = report      # program.report() appends the drift table
    return report
