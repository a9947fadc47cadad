"""(De)serialization of synthesis artifacts (DESIGN.md §13) for the port.

The counterpart of ``repro.artifacts.codec``.  A
:class:`~repro_torch.core.synthesizer.SynthesizedProgram` is lowered to plain
JSON documents plus one binary blob:

  program document   the network description, the converged
                     :class:`~repro_torch.core.plan.ExecutionPlan` (layer
                     plans, the :class:`~repro_torch.device.DeviceProfile`
                     via its own versioned JSON, the fused
                     :class:`~repro_torch.core.graph.GraphProgram`), the
                     shipped modes and the audit trail.  The network,
                     graph, plan and modes documents have the reference's
                     keys and values;
  weights blob       Stage B's prepared tensors as raw little-endian bytes,
                     described by a manifest of (layer, param, dtype, shape,
                     nbytes) entries.  A bf16 tensor goes out through its
                     bit pattern (numpy has no bf16); a
                     :class:`~repro_torch.core.precision.QuantizedTensor` as
                     its int8 payload plus its f32 scales.  The round trip is
                     exact, which the recomputed ``params_digest`` relies on.

Executables: the port's Stage D is a CUDA graph over ctypes launches, and no
torch format serializes one.  :func:`executables_supported` is ``False`` and
:func:`export_executable` raises :class:`ArtifactCodecError`: the reference's
plan-only fallback, where Stages A–C hydrate and Stage D captures again.

Decoding places every prepared tensor on an explicit ``device=`` (the card
by default); the caller recomputes the program's fingerprint and compares it
with the artifact's claimed identity (``store.py`` does).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.graph import FusedGroup, GraphProgram
from ..core.mode_selector import ModeSelectionReport
from ..core.network import Layer, NetworkDescription, make_layer
from ..core.parallelism import Parallelism
from ..core.plan import (ExecutionPlan, IterationRecord, LayerPlan,
                         SynthesisReport, ValidationRecord)
from ..core.precision import ComputeMode, QParams, QuantizedTensor
from ..core.synthesizer import SynthesizedProgram
from ..device.profile import DeviceProfile

#: Who wrote an artifact; a store reads only its own producer's programs.
PRODUCER = "repro_torch"


class ArtifactCodecError(ValueError):
    """An artifact document is malformed or cannot be reconstructed."""


# ---------------------------------------------------------------------------
# Network / graph structure
# ---------------------------------------------------------------------------

_LAYER_FIELDS = ("name", "kind", "inputs", "out_channels", "kernel",
                 "stride", "padding", "use_bias", "pool_size", "lrn_size",
                 "lrn_alpha", "lrn_beta")
#: Fields a kind adds to its layer document (the reference has no such
#: kind, so every other document keeps the reference's keys).
_KIND_FIELDS = {"layernorm": ("eps",)}


def encode_layer(layer: Layer) -> Dict[str, Any]:
    fields = _LAYER_FIELDS + _KIND_FIELDS.get(layer.kind, ())
    doc = {f: getattr(layer, f) for f in fields}
    doc["inputs"] = list(layer.inputs)
    return doc


def decode_layer(doc: Dict[str, Any]) -> Layer:
    try:
        fields = _LAYER_FIELDS + _KIND_FIELDS.get(doc["kind"], ())
        kwargs = {f: doc[f] for f in fields}
    except KeyError as e:
        raise ArtifactCodecError(f"layer document missing field {e}") from None
    kwargs["inputs"] = tuple(kwargs["inputs"])
    return make_layer(**kwargs)


def encode_network(net: NetworkDescription) -> Dict[str, Any]:
    return {"name": net.name,
            "input_shape": list(net.input_shape),
            "layers": [encode_layer(l) for l in net.layers]}


def decode_network(doc: Dict[str, Any]) -> NetworkDescription:
    return NetworkDescription(
        name=doc["name"], input_shape=tuple(doc["input_shape"]),
        layers=[decode_layer(l) for l in doc["layers"]])


def encode_graph(graph: Optional[GraphProgram]) -> Optional[Dict[str, Any]]:
    if graph is None:
        return None
    return {"net_name": graph.net_name,
            "output": graph.output,
            "trace": list(graph.trace),
            "groups": [{"name": g.name,
                        "inputs": list(g.inputs),
                        "layers": [encode_layer(l) for l in g.layers]}
                       for g in graph.groups]}


def decode_graph(doc: Optional[Dict[str, Any]]) -> Optional[GraphProgram]:
    if doc is None:
        return None
    groups = tuple(FusedGroup(name=g["name"],
                              layers=tuple(decode_layer(l)
                                           for l in g["layers"]),
                              inputs=tuple(g["inputs"]))
                   for g in doc["groups"])
    return GraphProgram(net_name=doc["net_name"], groups=groups,
                        output=doc["output"], trace=tuple(doc["trace"]))


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def encode_layer_plan(lp: LayerPlan) -> Dict[str, Any]:
    return {"impl": lp.impl,
            "parallelism": lp.parallelism.value,
            "mode": lp.mode.value,
            "u": lp.u,
            "reason": lp.reason,
            "vmem_budget": lp.vmem_budget,
            "qparams": (None if lp.qparams is None else
                        {"act_scale": float(lp.qparams.act_scale),
                         "zero_point": int(lp.qparams.zero_point)})}


def decode_layer_plan(doc: Dict[str, Any]) -> LayerPlan:
    qp = doc.get("qparams")
    return LayerPlan(impl=doc["impl"],
                     parallelism=Parallelism(doc["parallelism"]),
                     mode=ComputeMode(doc["mode"]),
                     u=int(doc["u"]),
                     reason=doc.get("reason", ""),
                     vmem_budget=doc.get("vmem_budget"),
                     qparams=(None if qp is None else
                              QParams(act_scale=qp["act_scale"],
                                      zero_point=qp["zero_point"])))


def encode_plan(plan: ExecutionPlan) -> Dict[str, Any]:
    return {"net_name": plan.net_name,
            "origin": plan.origin,
            "profile": plan.profile.to_json_dict(),
            "graph": encode_graph(plan.graph),
            "layers": {name: encode_layer_plan(lp)
                       for name, lp in plan.layers.items()}}


def decode_plan(doc: Dict[str, Any]) -> ExecutionPlan:
    try:
        profile = DeviceProfile.from_json_dict(doc["profile"])
    except ValueError as e:
        raise ArtifactCodecError(f"embedded device profile invalid: {e}") \
            from None
    return ExecutionPlan(
        net_name=doc["net_name"],
        layers={name: decode_layer_plan(lp)
                for name, lp in doc["layers"].items()},
        origin=doc.get("origin", "planner"),
        profile=profile,
        graph=decode_graph(doc.get("graph")))


# ---------------------------------------------------------------------------
# Reports (the audit trail a store hit must restore intact)
# ---------------------------------------------------------------------------

def encode_modes(modes: Dict[str, ComputeMode]) -> Dict[str, str]:
    return {n: m.value for n, m in modes.items()}


def decode_modes(doc: Dict[str, str]) -> Dict[str, ComputeMode]:
    return {n: ComputeMode(v) for n, v in doc.items()}


def encode_synthesis_report(r: Optional[SynthesisReport]
                            ) -> Optional[Dict[str, Any]]:
    if r is None:
        return None
    return {
        "iterations": [{"index": it.index,
                        "plan_fingerprint": it.plan_fingerprint,
                        "modes": encode_modes(it.modes),
                        "probe_metric": it.probe_metric,
                        "evaluations": it.evaluations}
                       for it in r.iterations],
        "converged": r.converged,
        "tie_broken": r.tie_broken,
        "max_iterations": r.max_iterations,
        "reference_accuracy": r.reference_accuracy,
        "validations": [{"plan_fingerprint": v.plan_fingerprint,
                         "modes": encode_modes(v.modes),
                         "accuracy": v.accuracy,
                         "degradation": v.degradation,
                         "passed": v.passed}
                        for v in r.validations],
        "fallbacks": list(r.fallbacks),
        "validated": r.validated,
        "gate_skipped_reason": r.gate_skipped_reason,
        "act_scales": dict(r.act_scales),
    }


def decode_synthesis_report(doc: Optional[Dict[str, Any]]
                            ) -> Optional[SynthesisReport]:
    if doc is None:
        return None
    return SynthesisReport(
        iterations=[IterationRecord(
            index=it["index"], plan_fingerprint=it["plan_fingerprint"],
            modes=decode_modes(it["modes"]),
            probe_metric=it["probe_metric"],
            evaluations=it["evaluations"]) for it in doc["iterations"]],
        converged=doc["converged"],
        tie_broken=doc["tie_broken"],
        max_iterations=doc["max_iterations"],
        reference_accuracy=doc.get("reference_accuracy"),
        validations=[ValidationRecord(
            plan_fingerprint=v["plan_fingerprint"],
            modes=decode_modes(v["modes"]), accuracy=v["accuracy"],
            degradation=v["degradation"], passed=v["passed"])
            for v in doc["validations"]],
        fallbacks=list(doc["fallbacks"]),
        validated=doc["validated"],
        gate_skipped_reason=doc.get("gate_skipped_reason"),
        act_scales=dict(doc.get("act_scales", {})))


def encode_mode_report(r: Optional[ModeSelectionReport]
                       ) -> Optional[Dict[str, Any]]:
    if r is None:
        return None
    return {"reference_metric": r.reference_metric,
            "final_metric": r.final_metric,
            "modes": encode_modes(r.modes),
            "evaluations": r.evaluations,
            "trace": list(r.trace)}


def decode_mode_report(doc: Optional[Dict[str, Any]]
                       ) -> Optional[ModeSelectionReport]:
    if doc is None:
        return None
    return ModeSelectionReport(
        reference_metric=doc["reference_metric"],
        final_metric=doc["final_metric"],
        modes=decode_modes(doc["modes"]),
        evaluations=doc["evaluations"],
        trace=list(doc["trace"]))


# ---------------------------------------------------------------------------
# Prepared weights: raw little-endian bytes + manifest (exact round trip)
# ---------------------------------------------------------------------------

#: The dtypes a prepared weight may have, by the name the manifest uses.
DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_NAMES = {dt: name for name, dt in DTYPES.items()}
#: Same-width integer types: a tensor's bit pattern, read as one of these,
#: goes to numpy, which fixes the byte order.
_BITS = {1: (torch.uint8, "<u1"), 2: (torch.int16, "<i2"),
         4: (torch.int32, "<i4"), 8: (torch.int64, "<i8")}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ArtifactCodecError(f"no artifact encoding for dtype {dtype}") \
            from None


def _dtype_from_name(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ArtifactCodecError(f"unknown weight dtype {name!r}") from None


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's elements as little-endian bytes, after a copy to the host
    (the same bytes on any machine)."""
    flat = t.detach().reshape(-1).contiguous().cpu()
    int_dtype, np_dtype = _BITS[flat.element_size()]
    return flat.view(int_dtype).numpy().astype(np_dtype, copy=False).tobytes()


def _tensor_from_bytes(raw: bytes, dtype: torch.dtype, shape,
                       device: torch.device) -> torch.Tensor:
    size = torch.empty((), dtype=dtype).element_size()
    int_dtype, np_dtype = _BITS[size]
    arr = np.frombuffer(raw, dtype=np_dtype).astype(
        np.dtype(np_dtype).newbyteorder("="))       # native order, a copy
    return torch.from_numpy(arr).view(int_dtype).view(dtype) \
        .reshape(tuple(shape)).to(device)


def encode_weights(prepared: Dict[str, Dict[str, object]]
                   ) -> Tuple[List[Dict[str, Any]], bytes]:
    """Prepared params -> (entry manifest, concatenated raw bytes).

    Deterministic order (layer name, then param name), so identical
    programs produce identical blobs and racing writers write the same
    content.  A :class:`QuantizedTensor` is one entry (its int8 payload)
    with its f32 scales described under ``"scale"`` and stored right after.
    """
    entries: List[Dict[str, Any]] = []
    chunks: List[bytes] = []
    for lname in sorted(prepared):
        for pname in sorted(prepared[lname]):
            v = prepared[lname][pname]
            t = v.q if isinstance(v, QuantizedTensor) else v
            raw = tensor_bytes(t)
            entry = {"layer": lname, "param": pname,
                     "dtype": dtype_name(t.dtype), "shape": list(t.shape),
                     "nbytes": len(raw)}
            chunks.append(raw)
            if isinstance(v, QuantizedTensor):
                sraw = tensor_bytes(v.scale)
                entry["scale"] = {"dtype": dtype_name(v.scale.dtype),
                                  "shape": list(v.scale.shape),
                                  "nbytes": len(sraw)}
                chunks.append(sraw)
            entries.append(entry)
    return entries, b"".join(chunks)


def decode_weights(entries: List[Dict[str, Any]], blob: bytes, *,
                   device: "str | torch.device" = "cuda"
                   ) -> Dict[str, Dict[str, object]]:
    """The inverse of :func:`encode_weights`, every tensor on ``device``."""
    device = torch.device(device)
    prepared: Dict[str, Dict[str, object]] = {}
    offset = 0

    def take(desc: Dict[str, Any], what: str) -> torch.Tensor:
        nonlocal offset
        n = int(desc["nbytes"])
        raw = blob[offset:offset + n]
        if len(raw) != n:
            raise ArtifactCodecError(
                f"weights blob truncated at {what}: wanted {n} bytes, "
                f"{len(raw)} left")
        offset += n
        dtype = _dtype_from_name(desc["dtype"])
        count = int(np.prod(desc["shape"], dtype=np.int64))
        if count * torch.empty((), dtype=dtype).element_size() != n:
            raise ArtifactCodecError(
                f"{what}: {n} bytes do not hold {desc['dtype']} "
                f"{desc['shape']}")
        return _tensor_from_bytes(raw, dtype, desc["shape"], device)

    for e in entries:
        what = f"{e['layer']}/{e['param']}"
        t = take(e, what)
        if "scale" in e:
            t = QuantizedTensor(q=t, scale=take(e["scale"], what + ".scale"))
        prepared.setdefault(e["layer"], {})[e["param"]] = t
    if offset != len(blob):
        raise ArtifactCodecError(
            f"weights blob has {len(blob) - offset} trailing bytes")
    return prepared


# ---------------------------------------------------------------------------
# Whole-program document
# ---------------------------------------------------------------------------

def encode_program(program: SynthesizedProgram) -> Dict[str, Any]:
    """The JSON half of a program artifact (weights travel separately)."""
    return {
        "fingerprint": program.fingerprint(),
        "net": encode_network(program.net),
        "plan": encode_plan(program.plan),
        "modes": encode_modes(program.modes),
        "parallelism": program.parallelism.value,
        "mode_report": encode_mode_report(program.mode_report),
        "synthesis_report": encode_synthesis_report(program.synthesis_report),
        "synthesis_seconds": program.synthesis_seconds,
        "vector_width": program.vector_width,
        "input_dtype": dtype_name(program.input_dtype),
    }


def decode_program(doc: Dict[str, Any],
                   prepared: Dict[str, Dict[str, object]]
                   ) -> SynthesizedProgram:
    """Rebuild the program around ``prepared`` (already on its device, from
    :func:`decode_weights`); the caller verifies the recomputed fingerprint
    against the artifact's claimed identity (store.py does)."""
    try:
        return SynthesizedProgram(
            net=decode_network(doc["net"]),
            plan=decode_plan(doc["plan"]),
            modes=decode_modes(doc["modes"]),
            parallelism=Parallelism(doc["parallelism"]),
            mode_report=decode_mode_report(doc.get("mode_report")),
            synthesis_seconds=float(doc.get("synthesis_seconds", 0.0)),
            synthesis_report=decode_synthesis_report(
                doc.get("synthesis_report")),
            prepared=prepared,
            vector_width=int(doc["vector_width"]),
            input_dtype=_dtype_from_name(doc["input_dtype"]))
    except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, ArtifactCodecError):
            raise
        raise ArtifactCodecError(f"program document invalid: {e}") from None


# ---------------------------------------------------------------------------
# Stage-D executables: none in the port (plan-only)
# ---------------------------------------------------------------------------

PLAN_ONLY_REASON = ("the port's Stage D is a CUDA graph over ctypes "
                    "launches, which no torch format serializes; Stage D "
                    "captures again (plan-only)")


def executables_supported(program: Optional[SynthesizedProgram] = None
                          ) -> bool:
    """Whether this build serializes Stage-D executables: never."""
    return False


def export_executable(program: SynthesizedProgram,
                      batch: int) -> Tuple[bytes, Dict[str, Any]]:
    """Always raises :class:`ArtifactCodecError`: the caller keeps a
    plan-only artifact, as the reference does where ``jax.export`` fails."""
    raise ArtifactCodecError(f"cannot serialize Stage D for batch {batch}: "
                             f"{PLAN_ONLY_REASON}")


__all__ = [
    "ArtifactCodecError", "DTYPES", "PLAN_ONLY_REASON", "PRODUCER",
    "decode_graph", "decode_layer", "decode_layer_plan", "decode_mode_report",
    "decode_modes", "decode_network", "decode_plan", "decode_program",
    "decode_synthesis_report", "decode_weights", "dtype_name",
    "encode_graph", "encode_layer", "encode_layer_plan", "encode_mode_report",
    "encode_modes", "encode_network", "encode_plan", "encode_program",
    "encode_synthesis_report", "encode_weights",
    "executables_supported", "export_executable", "tensor_bytes",
]
