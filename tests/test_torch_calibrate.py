"""Port parity of device calibration and the rest of the profile module
(``repro_torch.device.calibrate``, ``register_profile``, the validator CLI).

Both packages measure on the CPU here, under the same stubbed clock and
explicit sweep sizes: a rate is work over the best stubbed interval, so the
port's rates must equal the reference's exactly.  Cache cases mirror
``tests/test_device_profile.py``; every cache lives under ``tmp_path``.
"""
import dataclasses
import importlib
import json

import jax.numpy as jnp
import pytest
import torch

from repro.device import profile as jax_profile
from repro_torch.device import (CPU, H100, DeviceProfile, calibrate,
                                cache_key, get_profile, load_cached_profile,
                                measure_matmul_flops, measure_stream_bandwidth,
                                measurement_available, register_profile,
                                registered_profiles, resolve_profile,
                                store_cached_profile)
from repro_torch.device import profile as profile_mod

# The packages export a function named ``calibrate`` over the module's name.
jax_calibrate = importlib.import_module("repro.device.calibrate")
calibrate_mod = importlib.import_module("repro_torch.device.calibrate")

SMALL = dict(sizes=(32, 64), stream_sizes=(1024, 4096), reps=3)


class StepClock:
    """Deterministic clock: each call advances by the next of ``steps``
    (cycling), so the best-of window differs between reps and sizes."""

    def __init__(self, steps=(3e-3, 1e-3, 2e-3, 5e-4, 4e-3)):
        self.now, self.i, self.steps = 0.0, 0, steps

    def __call__(self):
        t = self.now
        self.now += self.steps[self.i % len(self.steps)]
        self.i += 1
        return t


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
def test_matmul_rate_equals_reference_under_stubbed_clock(dtype):
    """Exact: both packages time the same number of calls on the same clock
    and divide 2 n^3 by the same best interval."""
    ours = measure_matmul_flops({"bf16": torch.bfloat16, "f32": torch.float32,
                                 "int8": torch.int8}[dtype],
                                sizes=SMALL["sizes"], reps=3, clock=StepClock())
    ref = jax_calibrate.measure_matmul_flops(
        {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": jnp.int8}[dtype],
        sizes=SMALL["sizes"], reps=3, clock=StepClock())
    assert ours == ref and ours > 0


def test_stream_rate_and_calibrate_equal_reference_under_stubbed_clock():
    ours = measure_stream_bandwidth(sizes=SMALL["stream_sizes"], reps=3,
                                    clock=StepClock())
    ref = jax_calibrate.measure_stream_bandwidth(
        sizes=SMALL["stream_sizes"], reps=3, clock=StepClock())
    assert ours == ref
    cal = calibrate(CPU, clock=StepClock(), **SMALL)
    jcal = jax_calibrate.calibrate(jax_profile.CPU_INTERPRET, clock=StepClock(),
                                   **SMALL)
    for f in ("peak_flops_bf16", "peak_flops_f32", "peak_flops_int8",
              "hbm_bandwidth"):
        assert getattr(cal, f) == getattr(jcal, f), f
    assert cal.source == "calibrated" and cal.name == "cpu"
    # the fields a microbenchmark cannot see come from the base
    assert (cal.vmem_budget, cal.lane_width, cal.supports_pallas) == \
        (CPU.vmem_budget, CPU.lane_width, CPU.supports_pallas)
    assert calibrate(CPU, clock=StepClock(), **SMALL) == cal


def test_probes_compute_what_they_count():
    """The stream probe writes 2.5 x into a preallocated output (one read,
    one write); the int8 probe's product through ``torch._int_mm`` with a
    column-major second operand is the exact int32 matmul."""
    x = torch.randn(64)
    y = torch.empty_like(x)
    torch.mul(x, 2.5, out=y)
    torch.testing.assert_close(y, 2.5 * x)
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (32, 32), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (32, 32), generator=gen, dtype=torch.int8).t()
    assert not b.is_contiguous()
    assert torch.equal(torch._int_mm(a, b), a.int() @ b.int())


@pytest.mark.parametrize("case", ["miss_then_hit", "corrupt_is_a_miss",
                                  "resolve_prefers_cache"])
def test_profile_cache(case, tmp_path):
    cache_dir = str(tmp_path / "profiles")
    cal = calibrate(CPU, clock=StepClock(), **SMALL)
    if case == "miss_then_hit":
        assert load_cached_profile(cache_dir) is None
        path = store_cached_profile(cal, cache_dir)
        assert path.endswith(cache_key() + ".json")
        assert load_cached_profile(cache_dir) == cal
        assert not any(p.name.endswith(".tmp")
                       for p in (tmp_path / "profiles").iterdir())
    elif case == "corrupt_is_a_miss":
        path = store_cached_profile(cal, cache_dir)
        with open(path, "w") as f:
            f.write("{broken")
        assert load_cached_profile(cache_dir) is None
    else:
        store_cached_profile(cal, cache_dir)
        assert resolve_profile("auto", cache_dir=cache_dir) == cal


def test_resolve_profile_falls_back_to_cpu_off_the_card(tmp_path, monkeypatch):
    """No card: nothing is measured, the builtin ``cpu`` every time, and the
    fallback is never cached; names and profiles resolve as before."""
    monkeypatch.setattr(calibrate_mod, "measurement_available", lambda: False)

    def no_calibration(*a, **k):
        raise AssertionError("calibrated without a card")
    monkeypatch.setattr(calibrate_mod, "calibrate", no_calibration)
    cache_dir = str(tmp_path / "empty")
    assert resolve_profile("auto", cache_dir=cache_dir) is CPU
    assert resolve_profile(None, cache_dir=cache_dir) is CPU
    assert load_cached_profile(cache_dir) is None
    assert resolve_profile("h100") is H100 and resolve_profile(CPU) is CPU
    assert cache_key("cuda", "NVIDIA H100 80GB HBM3") == \
        "cuda__NVIDIA_H100_80GB_HBM3"
    assert cache_key() == "cpu__cpu"
    with pytest.raises(KeyError):
        resolve_profile("tpu_v5e")


def test_resolve_profile_calibrates_once_on_a_card(tmp_path, monkeypatch):
    """With a card (stubbed here): a miss calibrates and stores, the next
    call returns the stored profile without measuring."""
    calls = []

    def fake_calibrate(base=None, *, clock=None, **kw):
        calls.append(1)
        return dataclasses.replace(H100, peak_flops_bf16=7e14,
                                   source="calibrated")
    monkeypatch.setattr(calibrate_mod, "measurement_available", lambda: True)
    monkeypatch.setattr(calibrate_mod, "_device_kind", lambda: "stub card")
    monkeypatch.setattr(calibrate_mod, "calibrate", fake_calibrate)
    cache_dir = str(tmp_path / "profiles")
    first = resolve_profile("auto", cache_dir=cache_dir)
    second = resolve_profile("auto", cache_dir=cache_dir)
    assert first == second and first.peak_flops_bf16 == 7e14
    assert len(calls) == 1
    assert (tmp_path / "profiles" / "cuda__stub_card.json").exists()
    assert measurement_available() == torch.cuda.is_available()


def test_register_profile_and_registry():
    names = [p.name for p in registered_profiles()]
    assert names == sorted(names) and {"cpu", "h100"} <= set(names)
    with pytest.raises(ValueError, match="already registered"):
        register_profile(dataclasses.replace(H100, description="dup"))
    mine = dataclasses.replace(H100, name="h100_test_register",
                               peak_flops_bf16=5e14)
    try:
        assert register_profile(mine) is mine
        assert get_profile("h100_test_register") is mine
        assert mine in registered_profiles()
        swapped = dataclasses.replace(mine, peak_flops_bf16=6e14)
        register_profile(swapped, allow_replace=True)
        assert get_profile("h100_test_register") is swapped
    finally:
        profile_mod._REGISTRY.pop("h100_test_register", None)
    assert "h100_test_register" not in [p.name for p in registered_profiles()]


def test_cli_writes_a_profile_the_port_and_the_reference_load(tmp_path, capsys):
    """``python -m repro_torch.device.calibrate --out`` off the card writes
    the ``cpu`` fallback; the validator accepts it, and so does the
    reference's loader (same schema, same identity digest); a damaged file
    is refused by both validators."""
    out = tmp_path / "profile.json"
    assert calibrate_mod.main(["--out", str(out), "--no-cache"]) == 0
    want = CPU if not torch.cuda.is_available() else None
    loaded = DeviceProfile.load(str(out))
    if want is not None:
        assert loaded == want
    assert "wrote" in capsys.readouterr().out
    assert profile_mod.main([str(out)]) == 0
    assert "ok" in capsys.readouterr().out
    ref = jax_profile.DeviceProfile.load(str(out))
    assert ref.identity() == loaded.identity()
    assert ref.peak_flops_int8 == loaded.peak_flops_int8
    named = tmp_path / "h100.json"
    assert calibrate_mod.main(["--out", str(named), "--device", "h100"]) == 0
    assert DeviceProfile.load(str(named)) == H100
    doc = json.loads(out.read_text())
    doc["hbm_bandwidth"] *= 2
    out.write_text(json.dumps(doc))
    assert profile_mod.main([str(out)]) == 1
    assert jax_profile.main([str(out)]) == 1
    assert profile_mod.main([]) == 2
    assert "bf16" in H100.summary() and "int8" in H100.summary()
