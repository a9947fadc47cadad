"""Warm start across processes in the port: zero synthesis, same bits.

The mirror of tests/test_warmstart_process.py.  Two interpreters share one
artifact directory; the first (cold) runs the fixed-point loop and a Stage-D
build per bucket, the second (warm) must read, from its own registry,

  * ``synthesis_iterations_total`` == 0 and a ``kind=program`` hit, with the
    cold process's fingerprint and its validated report;
  * one Stage-D build per bucket again, each a ``kind=executable`` miss and
    never invalid (plan-only: the port serializes no CUDA graph),

and an output digest equal to the cold process's.  The children import the
port only, on the CPU.
"""
import json
import os
import subprocess
import sys

import pytest

_PHASE_SCRIPT = r"""
import hashlib, json, sys
import numpy as np
import torch

from repro_torch.artifacts import ArtifactStore, executables_supported
from repro_torch.core import NetworkDescription, run_network, synthesize
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import ReplicaSet, ServingConfig
from repro_torch.serving.loadgen import warm_replicas

artifact_dir = sys.argv[1]

net = NetworkDescription("warmstart_tiny", (3, 8, 8))
net.conv("c1", 8, 3, padding="SAME", inputs=("input",))
net.relu("r1")
net.flatten("f")
net.dense("d1", 4)
rng = np.random.default_rng(0)
params = {"c1": {"w": torch.from_numpy(rng.standard_normal((8, 3, 3, 3)).astype(np.float32) / 5),
                 "b": torch.from_numpy(rng.standard_normal(8).astype(np.float32) / 10)},
          "d1": {"w": torch.from_numpy(rng.standard_normal((512, 4)).astype(np.float32) / 20),
                 "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32) / 10)}}
x = torch.from_numpy(rng.standard_normal((8, 3, 8, 8)).astype(np.float32))
labels = torch.argmax(run_network(net, params, x), -1)

registry = MetricsRegistry()
store = ArtifactStore(artifact_dir, registry=registry)
program = synthesize(net, params, validation=(x, labels),
                     max_degradation=0.25, registry=registry,
                     artifact_store=store)
tier = ReplicaSet(program,
                  config=ServingConfig(max_batch=4, artifact_dir=artifact_dir),
                  registry=registry)
warm_replicas(tier)
out = np.asarray(tier.infer_one(x[0].numpy()), dtype=np.float32)

def count(name, **labels):
    c = registry.get(name)
    return float(c.value(**labels)) if c is not None else 0.0

print("PHASE_RESULT " + json.dumps({
    "synthesis_iterations": count("synthesis_iterations_total"),
    "stage_d_compiles": tier.cache.stats.stage_d_compiles,
    "artifact_hits_program": count("artifact_hits_total", kind="program"),
    "artifact_hits_executable": count("artifact_hits_total", kind="executable"),
    "artifact_misses_executable": count("artifact_misses_total",
                                        kind="executable"),
    "artifact_invalid": count("artifact_invalid_total", kind="program")
    + count("artifact_invalid_total", kind="executable"),
    "executables_supported": int(executables_supported()),
    "fingerprint": program.fingerprint(),
    "output_digest": hashlib.sha256(out.tobytes()).hexdigest(),
    "validated": int(program.synthesis_report.validated),
    "jax_loaded": int(any(m == "jax" or m.startswith(("jax.", "repro."))
                          for m in sys.modules)),
}))
"""


def _run_phase(artifact_dir: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", _PHASE_SCRIPT, artifact_dir],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, f"phase failed:\n{proc.stdout}\n{proc.stderr}"
    for line in proc.stdout.splitlines():
        if line.startswith("PHASE_RESULT "):
            return json.loads(line[len("PHASE_RESULT "):])
    pytest.fail(f"no result marker in phase output:\n{proc.stdout}")


def test_two_process_warm_start(tmp_path):
    store_dir = str(tmp_path / "store")
    cold = _run_phase(store_dir)
    warm = _run_phase(store_dir)

    assert cold["jax_loaded"] == 0 and warm["jax_loaded"] == 0
    assert cold["synthesis_iterations"] >= 1
    assert cold["stage_d_compiles"] == 3            # buckets 1, 2, 4
    assert cold["validated"] == 1

    assert warm["synthesis_iterations"] == 0
    assert warm["artifact_hits_program"] >= 1
    assert warm["fingerprint"] == cold["fingerprint"]
    assert warm["validated"] == 1

    # Plan-only: Stage D is built again per bucket, a miss, never invalid.
    assert warm["executables_supported"] == 0
    assert warm["stage_d_compiles"] == 3
    assert warm["artifact_hits_executable"] == 0
    assert warm["artifact_misses_executable"] == 3
    assert cold["artifact_invalid"] == 0 and warm["artifact_invalid"] == 0

    assert warm["output_digest"] == cold["output_digest"]
