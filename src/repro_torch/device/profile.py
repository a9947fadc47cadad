"""Device profiles: the hardware numbers synthesis consumes, for the card.

The PyTorch counterpart of ``repro.device.profile``: a frozen
:class:`DeviceProfile` carries every hardware number the planner reads
(per-dtype peak FLOP/s, memory bandwidth, the per-block budget behind
rule 1, the channel-group width behind map-major grouping), serializes to
versioned JSON, and folds into plan fingerprints through :meth:`identity`.

On Hopper the fields mean:

  ``vmem_budget``     the dynamic shared memory one block of the map-major
                      conv kernel may request (at most 232,448 bytes on an
                      H100); rule 1 compares the kernel's exact request
                      (``kernels/conv_mapmajor/conv_mapmajor.py::kernel_smem_bytes``)
                      with it;
  ``lane_width``      the widest channel group ``u`` (128, as in the JAX
                      package, so plans choose the same ``u``);
  ``supports_pallas`` whether the hand-written CUDA kernels compile for
                      this target (the name is kept from the JAX package,
                      where it gates the Pallas kernels).

Builtins: ``h100`` (H100 SXM data-sheet peaks, the default) and ``cpu``
(no kernels; the wrappers take their plain versions there).  Measured
profiles come from :mod:`repro_torch.device.calibrate`.

Validate a profile JSON from the command line:

    PYTHONPATH=src python -m repro_torch.device.profile profile.json
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, Tuple

PROFILE_SCHEMA_VERSION = 1

#: The widest map-major channel group ``u``.
LANE_WIDTH = 128

#: The most dynamic shared memory one block may use on Hopper (227 KB).
HOPPER_MAX_SMEM_PER_BLOCK = 232_448


class ProfileSchemaError(ValueError):
    """A profile document is malformed or from an unknown schema version."""


@dataclass(frozen=True)
class DeviceProfile:
    """One device's resource characteristics, as synthesis consumes them."""
    name: str
    peak_flops_f32: float
    peak_flops_bf16: float
    peak_flops_int8: float
    #: Device memory streaming bandwidth, bytes/s.
    hbm_bandwidth: float
    #: Shared memory (bytes) one block of the conv kernel may request.
    vmem_budget: int
    lane_width: int = LANE_WIDTH
    #: Inter-card link bandwidth, bytes/s per direction (0 = one card).
    link_bandwidth: float = 0.0
    #: Whether the hand-written CUDA kernels compile on this target.
    supports_pallas: bool = True
    #: "builtin" | "calibrated" | "file" — provenance, not identity.
    source: str = "builtin"
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("profile name must be non-empty")
        for f in ("peak_flops_f32", "peak_flops_bf16", "peak_flops_int8",
                  "hbm_bandwidth"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")
        if self.vmem_budget <= 0 or self.lane_width <= 0:
            raise ValueError("vmem_budget and lane_width must be positive")

    def peak_flops(self, dtype: str = "bf16") -> float:
        try:
            return {"f32": self.peak_flops_f32,
                    "float32": self.peak_flops_f32,
                    "bf16": self.peak_flops_bf16,
                    "bfloat16": self.peak_flops_bf16,
                    "int8": self.peak_flops_int8}[dtype]
        except KeyError:
            raise KeyError(f"no peak FLOP/s entry for dtype {dtype!r}") from None

    def ridge(self, dtype: str = "bf16") -> float:
        """FLOPs per byte where compute time equals memory time."""
        return self.peak_flops(dtype) / self.hbm_bandwidth

    def identity(self) -> str:
        """Digest of the name and every hardware number (not provenance)."""
        h = hashlib.sha256()
        h.update(self.name.encode())
        for v in (self.peak_flops_f32, self.peak_flops_bf16,
                  self.peak_flops_int8, self.hbm_bandwidth, self.vmem_budget,
                  self.lane_width, self.link_bandwidth, self.supports_pallas):
            h.update(f"|{v!r}".encode())
        return h.hexdigest()[:12]

    def to_json_dict(self) -> Dict[str, Any]:
        doc = dataclasses.asdict(self)
        doc["schema_version"] = PROFILE_SCHEMA_VERSION
        doc["identity"] = self.identity()
        return doc

    @classmethod
    def from_json_dict(cls, doc: Any) -> "DeviceProfile":
        if not isinstance(doc, dict):
            raise ProfileSchemaError("profile document must be a JSON object")
        version = doc.get("schema_version")
        if version != PROFILE_SCHEMA_VERSION:
            raise ProfileSchemaError(
                f"unknown profile schema_version {version!r} (this build reads "
                f"version {PROFILE_SCHEMA_VERSION})")
        missing = {"name", "peak_flops_f32", "peak_flops_bf16",
                   "peak_flops_int8", "hbm_bandwidth", "vmem_budget"} - set(doc)
        if missing:
            raise ProfileSchemaError(
                f"profile missing fields: {', '.join(sorted(missing))}")
        fields = {f.name for f in dataclasses.fields(cls)}
        profile = cls(**{k: v for k, v in doc.items() if k in fields})
        declared = doc.get("identity")
        if declared is not None and declared != profile.identity():
            raise ProfileSchemaError(
                f"profile identity mismatch: file says {declared}, fields hash "
                f"to {profile.identity()} (corrupt or hand-edited)")
        return profile

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "DeviceProfile":
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise ProfileSchemaError(f"{path}: not valid JSON ({e})") from None
        return cls.from_json_dict(doc)

    def summary(self) -> str:
        return (f"{self.name} [{self.source}]: "
                f"bf16 {self.peak_flops_bf16 / 1e12:.1f} TFLOP/s, "
                f"f32 {self.peak_flops_f32 / 1e12:.1f} TFLOP/s, "
                f"int8 {self.peak_flops_int8 / 1e12:.1f} TOP/s, "
                f"HBM {self.hbm_bandwidth / 1e9:.0f} GB/s, "
                f"ridge {self.ridge():.0f} FLOPs/B, "
                f"smem block {self.vmem_budget} B, "
                f"u<= {self.lane_width}, "
                f"kernels={'yes' if self.supports_pallas else 'plain-only'}")


#: NVIDIA H100 SXM, data-sheet dense peaks at the 700 W limit.
H100 = DeviceProfile(
    name="h100",
    peak_flops_f32=67e12,
    peak_flops_bf16=989e12,
    peak_flops_int8=1979e12,
    hbm_bandwidth=3.35e12,
    vmem_budget=HOPPER_MAX_SMEM_PER_BLOCK,
    lane_width=LANE_WIDTH,
    link_bandwidth=450e9,
    description="NVIDIA H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3")

#: A host without a card: the wrappers run their plain PyTorch versions.
CPU = DeviceProfile(
    name="cpu",
    peak_flops_f32=200e9,
    peak_flops_bf16=100e9,
    peak_flops_int8=400e9,
    hbm_bandwidth=40e9,
    vmem_budget=HOPPER_MAX_SMEM_PER_BLOCK,
    lane_width=LANE_WIDTH,
    supports_pallas=False,
    description="CPU host: plain PyTorch versions of the kernels only")

DEFAULT_PROFILE = H100

_REGISTRY: Dict[str, DeviceProfile] = {}


def register_profile(profile: DeviceProfile, *,
                     allow_replace: bool = False) -> DeviceProfile:
    """Add a profile to the registry (e.g. a calibrated measurement)."""
    if profile.name in _REGISTRY and not allow_replace:
        raise ValueError(f"profile {profile.name!r} already registered; "
                         "pass allow_replace=True to overwrite")
    _REGISTRY[profile.name] = profile
    return profile


for _p in (H100, CPU):
    register_profile(_p)


def get_profile(name: str) -> DeviceProfile:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown device profile {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}") from None


def registered_profiles() -> Tuple[DeviceProfile, ...]:
    """All registered profiles, sorted by name."""
    return tuple(_REGISTRY[n] for n in sorted(_REGISTRY))


def torch_device(device: "str | None" = "cuda"):
    """The ``torch.device`` an entry point makes its tensors on: ``cuda``
    unless the caller asks for another; raises if CUDA is asked for and is
    not available (nothing falls back to the CPU silently)."""
    import torch
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU (the kernels' plain versions)")
    return dev


def main(argv) -> int:
    """Validate profile JSON files: round-trip each and print a summary."""
    if not argv:
        print("usage: python -m repro_torch.device.profile PROFILE.json [...]")
        return 2
    bad = 0
    for path in argv:
        try:
            p = DeviceProfile.load(path)
            print(f"{path}: ok — {p.summary()}")
        except (OSError, ProfileSchemaError, ValueError, TypeError) as e:
            print(f"{path}: INVALID — {e}")
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
