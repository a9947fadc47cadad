"""Microbenchmark calibration: measure a :class:`DeviceProfile` on the card.

The counterpart of ``repro.device.calibrate``.  The planner's roofline is
only as good as its hardware numbers, so this module measures them:

  * :func:`measure_matmul_flops` — square matmuls of increasing size per
    operand type; the best sustained rate wins (small sizes are launch-bound,
    so the sweep's maximum approximates the peak).  bf16 through
    ``torch.matmul``; f32 with TF32 off (:func:`full_f32`), so the rate is
    the f32 FMA path PRECISE runs, not the TF32 tensor cores; int8 through
    ``torch._int_mm`` (int8 x int8 -> int32, the arithmetic of the int8
    kernels; the second operand column-major, the layout cuBLASLt's int8
    tensor-core kernels take: row-major runs about 7x slower on the H100).
  * :func:`measure_stream_bandwidth` — ``y = 2.5 * x`` in one launch over
    buffers too large to cache: one f32 read and one f32 write per element
    (the reference's ``2.5 * x + 1`` is two launches eagerly, or one with
    a broadcast operand, which PyTorch runs unvectorized).
  * :func:`calibrate` — both, folded into a copy of a builtin profile with
    ``source="calibrated"``.

Every timed call ends in ``torch.cuda.synchronize()`` inside the timed
region, and every timing loop takes an injectable ``clock``, so calibration
is deterministic under test (a stubbed clock yields exact rates).

The default sweeps are sized for the H100, not the TPU: its L2 holds 50 MB,
so the stream buffers are 256 and 512 MiB of f32 (well past it), and a
2048^3 bf16 matmul takes about 20 us, too short for a host clock around a
synchronize, so the matmul sweep runs up to 16384.

**Profile cache and fallback.**  :func:`resolve_profile` keeps measurements
in an on-disk cache keyed by ``(backend, device name)``, e.g.
``cuda__NVIDIA_H100_80GB_HBM3``, and reloads them on later runs.  Without a
card it measures nothing and returns the builtin ``cpu`` profile (``h100``
is the builtin for the card).  Only ``"auto"`` (or ``None``) passed to
:func:`resolve_profile` calibrates; a name looks up a builtin.

CLI (on the card: measure, cache and write a profile):

    PYTHONPATH=src python -m repro_torch.device.calibrate --out profile.json
"""
from __future__ import annotations

import argparse
import os
import re
import time
from dataclasses import replace
from typing import Callable, Optional, Sequence, Tuple

import torch

from .profile import CPU, H100, DeviceProfile, ProfileSchemaError, get_profile

Clock = Callable[[], float]

#: Square matmul sizes for the FLOP-rate sweep.
MATMUL_SWEEP: Tuple[int, ...] = (2048, 4096, 8192, 16384)
#: Streaming-probe buffer sizes (elements of f32): 256 and 512 MiB.
STREAM_SWEEP: Tuple[int, ...] = (1 << 26, 1 << 27)


def measurement_available() -> bool:
    """True when microbenchmarks measure a card.  On the CPU the kernels
    run their plain versions, so a measurement there would describe the
    host, not a deployment target."""
    return torch.cuda.is_available()


def _device() -> torch.device:
    return torch.device("cuda" if measurement_available() else "cpu")


def _best_seconds(fn: Callable[[], torch.Tensor], reps: int, clock: Clock,
                  device: torch.device) -> float:
    """Best-of-``reps`` wall time of ``fn`` (:func:`min_of_reps`; the first
    call warms up)."""
    from ..core.capture import min_of_reps, sync_device
    fn()
    sync_device(device)
    # A stubbed clock may tick 0.
    return max(min_of_reps(fn, reps, clock, device), 1e-12)


def measure_matmul_flops(dtype: torch.dtype = torch.bfloat16, *,
                         sizes: Sequence[int] = MATMUL_SWEEP,
                         reps: int = 3, clock: Clock = time.perf_counter,
                         seed: int = 0) -> float:
    """Best sustained matmul FLOP/s over a size sweep (2*n^3 per call).

    int8 operands are uniform in [-127, 127] and multiply through
    ``torch._int_mm`` into int32, the second one column-major (n must be a
    multiple of 8 and above 16); f32 runs with TF32 off."""
    from ..core.precision import full_f32
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    best_rate = 0.0
    for n in sizes:
        if dtype == torch.int8:
            a = torch.randint(-127, 128, (n, n), generator=gen, device=dev,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (n, n), generator=gen, device=dev,
                              dtype=torch.int8).t()

            def f(a=a, b=b):
                return torch._int_mm(a, b)
        else:
            a = torch.randn(n, n, generator=gen, device=dev).to(dtype)
            b = torch.randn(n, n, generator=gen, device=dev).to(dtype)

            def f(a=a, b=b):
                return torch.matmul(a, b)
        with full_f32():
            t = _best_seconds(f, reps, clock, dev)
        best_rate = max(best_rate, 2.0 * n ** 3 / t)
    return best_rate


def measure_stream_bandwidth(*, sizes: Sequence[int] = STREAM_SWEEP,
                             reps: int = 3, clock: Clock = time.perf_counter,
                             seed: int = 0) -> float:
    """Best sustained streaming bytes/s: ``y = 2.5 * x`` reads x and writes
    y, one launch per call."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    best_rate = 0.0
    for n in sizes:
        x = torch.randn(n, generator=gen, device=dev)
        y = torch.empty_like(x)
        t = _best_seconds(lambda: torch.mul(x, 2.5, out=y), reps, clock, dev)
        moved = 2 * n * 4              # one f32 read + one f32 write
        best_rate = max(best_rate, moved / t)
    return best_rate


def calibrate(base: Optional[DeviceProfile] = None, *,
              sizes: Sequence[int] = MATMUL_SWEEP,
              stream_sizes: Sequence[int] = STREAM_SWEEP,
              reps: int = 3, clock: Clock = time.perf_counter,
              seed: int = 0) -> DeviceProfile:
    """Measure this host's card and return a calibrated profile.

    ``base`` supplies what the microbenchmarks cannot see (the per-block
    shared-memory budget, the lane width, the link bandwidth, kernel
    support); by default the builtin for this backend."""
    if base is None:
        base = H100 if measurement_available() else CPU
    bf16 = measure_matmul_flops(torch.bfloat16, sizes=sizes, reps=reps,
                                clock=clock, seed=seed)
    f32 = measure_matmul_flops(torch.float32, sizes=sizes, reps=reps,
                               clock=clock, seed=seed)
    int8 = measure_matmul_flops(torch.int8, sizes=sizes, reps=reps,
                                clock=clock, seed=seed)
    bw = measure_stream_bandwidth(sizes=stream_sizes, reps=reps, clock=clock,
                                  seed=seed)
    return replace(
        base,
        peak_flops_bf16=bf16,
        peak_flops_f32=f32,
        peak_flops_int8=int8,
        hbm_bandwidth=bw,
        source="calibrated",
        description=(f"calibrated on backend={_backend()} "
                     f"device_kind={_device_kind()} (base {base.name})"))


# ---------------------------------------------------------------------------
# On-disk profile cache + deterministic resolution
# ---------------------------------------------------------------------------

def _backend() -> str:
    return "cuda" if measurement_available() else "cpu"


def _device_kind() -> str:
    return torch.cuda.get_device_name() if measurement_available() else "cpu"


def _sanitize(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", s).strip("_") or "unknown"


def default_cache_dir() -> str:
    """Where calibrated profiles persist between runs (env-overridable)."""
    env = os.environ.get("REPRO_TORCH_DEVICE_PROFILE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "device_profiles")


def cache_key(backend: Optional[str] = None,
              device_kind: Optional[str] = None) -> str:
    """Cache filename stem for the (backend, device name) pair."""
    backend = backend or _backend()
    device_kind = device_kind or _device_kind()
    return f"{_sanitize(backend)}__{_sanitize(device_kind)}"


def _cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, key + ".json")


def load_cached_profile(cache_dir: Optional[str] = None,
                        key: Optional[str] = None) -> Optional[DeviceProfile]:
    """The cached calibration for this device, or None on a miss; an
    unreadable or wrong-version entry counts as a miss (it is measured
    again and overwritten, never trusted)."""
    path = _cache_path(cache_dir or default_cache_dir(), key or cache_key())
    if not os.path.exists(path):
        return None
    try:
        return DeviceProfile.load(path)
    except (ProfileSchemaError, OSError):
        return None


def store_cached_profile(profile: DeviceProfile,
                         cache_dir: Optional[str] = None,
                         key: Optional[str] = None) -> str:
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    path = _cache_path(cache_dir, key or cache_key())
    tmp = path + ".tmp"
    profile.save(tmp)
    os.replace(tmp, path)              # atomic: readers never see a partial
    return path


def resolve_profile(device: "str | DeviceProfile | None" = None, *,
                    allow_calibration: bool = True,
                    use_cache: bool = True,
                    cache_dir: Optional[str] = None,
                    clock: Clock = time.perf_counter) -> DeviceProfile:
    """Turn a device spec into a profile:

      * a :class:`DeviceProfile` passes through untouched;
      * a registry name (``"h100"``) returns that profile;
      * ``None`` / ``"auto"`` means this host: the cached calibration if
        present, else a fresh one (stored) when a card is available, else
        the builtin ``cpu``.
    """
    if isinstance(device, DeviceProfile):
        return device
    if device is not None and device != "auto":
        return get_profile(device)
    if use_cache:
        cached = load_cached_profile(cache_dir)
        if cached is not None:
            return cached
    if allow_calibration and measurement_available():
        profile = calibrate(clock=clock)
        if use_cache:
            store_cached_profile(profile, cache_dir)
        return profile
    return H100 if measurement_available() else CPU


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="device_profile.json",
                    help="where to write the resolved profile JSON")
    ap.add_argument("--device", default="auto",
                    help="registry name, or 'auto' to calibrate/fall back")
    ap.add_argument("--force-measure", action="store_true",
                    help="run the microbenchmarks even without a card (the "
                         "numbers then describe this host's CPU)")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the on-disk profile cache entirely")
    args = ap.parse_args(argv)

    if args.force_measure:
        base = None if args.device == "auto" else get_profile(args.device)
        profile = calibrate(base)
    else:
        profile = resolve_profile(args.device, use_cache=not args.no_cache)
    profile.save(args.out)
    print(f"wrote {args.out}: {profile.summary()}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
