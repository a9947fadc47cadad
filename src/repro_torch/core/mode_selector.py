"""Per-layer inexact-computing mode selection (Cappuccino §IV-C).

The counterpart of ``repro.core.mode_selector``: pure Python, the same
greedy algorithm and the same joint mode+impl refinement.

Cappuccino "analyzes the given CNN layer by layer to determine the best
matching computing mode for every layer", using the validation dataset, so
that "as many CNN layers as possible [run] in inexact modes, under user
specified constraints in terms of acceptable degradation in classification
accuracy".

Algorithm (greedy, fastest-mode-first — matches the paper's goal function):

  1. Measure reference metric (top-1 accuracy, or -loss for LM heads) with
     every layer PRECISE.
  2. Tentatively set *all* tunable layers to the fastest allowed mode and
     measure.  If within the constraint, done (this is the paper's observed
     outcome: "classification accuracy in imprecise mode turns out to be
     identical to the exact mode ... Cappuccino recommends imprecise in all
     layers").
  3. Otherwise, refine per layer: sweep layers in order of their measured
     individual sensitivity (most sensitive first), backing each off to the
     next-slower mode until the constraint holds.

The evaluation function is injected, so the same selector serves CNN top-1
accuracy and transformer validation loss.

:func:`refine_plan` is the plan-aware entry point (joint mode+impl
refinement): mode probes are evaluated *under the planned per-layer
implementations*, and the chosen modes feed back into the plan — a layer
pinned PRECISE leaves the inexact-mode map-major kernel for the
full-f32 library path, the analogue of RenderScript making vectorization
available only in the inexact modes (paper §IV-C).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

from .precision import ComputeMode, MODES_FASTEST_FIRST

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .plan import ExecutionPlan

# evaluate(modes: dict[layer, ComputeMode]) -> float metric (higher better)
EvalFn = Callable[[Dict[str, ComputeMode]], float]


@dataclass
class ModeSelectionReport:
    reference_metric: float
    final_metric: float
    modes: Dict[str, ComputeMode]
    evaluations: int
    trace: List[str] = field(default_factory=list)

    @property
    def degradation(self) -> float:
        return self.reference_metric - self.final_metric

    def summary(self) -> str:
        lines = [f"reference metric : {self.reference_metric:.4f}",
                 f"final metric     : {self.final_metric:.4f}",
                 f"degradation      : {self.degradation:.4f}",
                 f"evaluations      : {self.evaluations}"]
        for name, mode in self.modes.items():
            lines.append(f"  {name:28s} -> {mode.value}")
        return "\n".join(lines)


def select_modes(layer_names: Sequence[str], evaluate: EvalFn, *,
                 max_degradation: float = 0.0,
                 allow_int8: bool = False,
                 reference: Optional[float] = None) -> ModeSelectionReport:
    """Greedy per-layer mode assignment under an accuracy-drop constraint.

    ``reference`` supplies a pre-measured all-PRECISE metric; the synthesis
    fixed-point loop passes the first iteration's reference into later
    re-probes so the (mode-independent) baseline is not re-measured every
    round.
    """
    candidate_modes = [m for m in MODES_FASTEST_FIRST
                       if allow_int8 or m is not ComputeMode.IMPRECISE_INT8]
    fastest = candidate_modes[0]
    evals = 0
    trace: List[str] = []

    def run(modes: Dict[str, ComputeMode]) -> float:
        nonlocal evals
        evals += 1
        return float(evaluate(modes))

    precise = {n: ComputeMode.PRECISE for n in layer_names}
    if reference is None:
        ref = run(precise)
        trace.append(f"reference (all precise): {ref:.4f}")
    else:
        ref = float(reference)
        trace.append(f"reference (warm start): {ref:.4f}")

    # Step 2: all-fastest shortcut.
    modes = {n: fastest for n in layer_names}
    metric = run(modes)
    trace.append(f"all-{fastest.value}: {metric:.4f}")
    if ref - metric <= max_degradation:
        return ModeSelectionReport(ref, metric, modes, evals, trace)

    # Step 3: per-layer sensitivity = metric drop when only that layer is
    # inexact (paper: "in every layer, it utilizes the validation dataset to
    # measure the classification accuracy under different processing modes").
    sensitivity: List[Tuple[float, str]] = []
    for name in layer_names:
        probe = dict(precise)
        probe[name] = fastest
        m = run(probe)
        sensitivity.append((ref - m, name))
        trace.append(f"sensitivity[{name}] = {ref - m:.4f}")
    sensitivity.sort(reverse=True)  # most sensitive first

    modes = {n: fastest for n in layer_names}
    for drop, name in sensitivity:
        metric = run(modes)
        if ref - metric <= max_degradation:
            break
        # back this layer off through slower modes until it stops mattering
        for slower in candidate_modes[1:]:
            modes[name] = slower
            metric = run(modes)
            trace.append(f"back off {name} -> {slower.value}: {metric:.4f}")
            if ref - metric <= max_degradation:
                break
    final = run(modes)
    return ModeSelectionReport(ref, final, modes, evals, trace)


# evaluate_plan(plan) -> float metric (higher better)
PlanEvalFn = Callable[["ExecutionPlan"], float]


def refine_plan(plan: "ExecutionPlan", layer_names: Sequence[str],
                evaluate_plan: PlanEvalFn, *,
                max_degradation: float = 0.0,
                allow_int8: bool = False,
                reference: Optional[float] = None
                ) -> Tuple[ModeSelectionReport, "ExecutionPlan"]:
    """Joint mode+impl refinement of an execution plan (§IV-C on plans).

    1. Run the greedy mode selector, with every probe evaluated under the
       plan's per-layer implementations (not a fixed global backend).
    2. Fold the chosen modes back into the plan.
    3. Implementation feedback: a layer the selector pinned PRECISE leaves
       the map-major kernel for the library path — the kernel is reserved
       for the inexact modes, as RenderScript reserves vectorization for
       them; the library's full-f32 conv is the faithful f32 implementation.
    4. Re-measure once if step 3 changed anything, so the report's final
       metric describes the program actually emitted.
    """
    from .plan import enforce_precise_xla

    def evaluate(modes: Dict[str, ComputeMode]) -> float:
        return evaluate_plan(plan.with_modes(modes))

    report = select_modes(layer_names, evaluate,
                          max_degradation=max_degradation,
                          allow_int8=allow_int8, reference=reference)
    refined, switched = enforce_precise_xla(plan.with_modes(report.modes),
                                            layer_names)

    if switched:
        final = float(evaluate_plan(refined))
        trace = report.trace + [
            f"joint impl refinement: {', '.join(switched)} -> xla "
            f"(PRECISE); re-measured {final:.4f}"]
        report = dataclasses.replace(report, final_metric=final,
                                     evaluations=report.evaluations + 1,
                                     trace=trace)
    return report, refined
