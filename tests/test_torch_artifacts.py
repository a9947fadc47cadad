"""Port parity of the persistent artifact store (``repro_torch.artifacts``).

Mirrors every case of tests/test_artifact_store.py on a scaled AlexNet with
numpy weights (tests/_torch_parity.py), on the CPU.  The port serializes no
Stage-D executable (a CUDA graph), so where the reference expects a hydrated
executable the port's case pins the plan-only behaviour: a
``kind=executable`` miss that is not invalid, and one Stage-D build per
bucket.  Besides the mirrors:

* the request key covers every ``PlannerConfig`` field and
  ``autotune_input``, where the reference's key for the same pair is one
  (a known defect of the reference, pinned here as a difference);
* the codec's network, graph, plan and modes documents equal the
  reference's ``encode_*`` for the same program;
* a store the JAX package wrote is a miss in the port, not invalid.
"""
import dataclasses
import hashlib
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import artifacts as jax_artifacts
from repro.artifacts import codec as jax_codec
from repro.cnn import alexnet as jax_alexnet
from repro.core import PlannerConfig as JaxPlannerConfig
from repro.core import lower_network as jax_lower_network
from repro.core import plan_network as jax_plan_network
from repro.core import synthesize as jax_synthesize
from repro.core.precision import ComputeMode as JaxMode
from repro.device.profile import DeviceProfile as JaxDeviceProfile
from repro_torch.artifacts import (ARTIFACT_SCHEMA_VERSION, ArtifactStore,
                                   executables_supported,
                                   synthesis_request_key)
from repro_torch.artifacts import codec
from repro_torch.cnn import alexnet, params_from_numpy
from repro_torch.core import (ComputeMode, PlannerConfig, lower_network,
                              plan_network, run_network, synthesize)
from repro_torch.device import H100
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import ProgramCache, ReplicaSet, ServingConfig
from repro_torch.serving.loadgen import warm_replicas

from _torch_parity import params_to_jax, reference_params

MAX_DEG = 0.25
KW = dict(scale=0.1, num_classes=10, input_hw=67)


@pytest.fixture(scope="module")
def tiny():
    net = alexnet(**KW)
    np_params = reference_params(jax_alexnet(**KW), seed=0)
    params = params_from_numpy(np_params, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 3, 67, 67)).astype(np.float32))
    labels = torch.argmax(run_network(net, params, x), -1)
    return net, params, x, labels, np_params


@pytest.fixture(scope="module")
def fresh_program(tiny):
    net, params, x, labels, _ = tiny
    return synthesize(net, params, validation=(x, labels),
                      max_degradation=MAX_DEG)


def _bytes(t):
    return t.detach().float().contiguous().numpy().tobytes()


# ------------------------------------------------------------ round trip ----
def test_round_trip_bitwise_identical(tiny, fresh_program, tmp_path):
    net, params, x, labels, _ = tiny
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program)
    assert fp == fresh_program.fingerprint()

    loaded = store.load_program(fp, device="cpu")
    assert loaded is not None
    assert loaded.fingerprint() == fp
    assert loaded.device == torch.device("cpu")
    r = loaded.synthesis_report
    assert r is not None and r.validated and r.converged
    assert len(r.iterations) == len(fresh_program.synthesis_report.iterations)
    assert loaded.modes == fresh_program.modes

    assert _bytes(fresh_program.infer(x)) == _bytes(loaded.infer(x))
    xb = x[:4]
    assert (_bytes(fresh_program.for_batch(4)(xb))
            == _bytes(loaded.for_batch(4)(xb)))
    assert store.hits == 1 and store.invalid == 0


def test_missing_fingerprint_is_a_miss(tmp_path):
    store = ArtifactStore(str(tmp_path))
    assert store.load_program("deadbeef-cafe", device="cpu") is None
    assert store.misses == 1 and store.invalid == 0


def test_synthesize_store_hit_zero_iterations(tiny, tmp_path):
    net, params, x, labels, _ = tiny
    root = str(tmp_path)

    reg_cold = MetricsRegistry()
    cold = synthesize(net, params, validation=(x, labels),
                      max_degradation=MAX_DEG, registry=reg_cold,
                      artifact_store=ArtifactStore(root, registry=reg_cold))
    assert reg_cold.get("synthesis_iterations_total").value() >= 1

    reg_warm = MetricsRegistry()
    store = ArtifactStore(root, registry=reg_warm)
    warm = synthesize(net, params, validation=(x, labels),
                      max_degradation=MAX_DEG, registry=reg_warm,
                      artifact_store=store)
    assert reg_warm.get("synthesis_iterations_total").value() == 0
    assert warm.fingerprint() == cold.fingerprint()
    assert warm.synthesis_report.validated
    assert warm.device == torch.device("cpu")       # where the params live
    assert store.hits >= 1
    assert _bytes(cold.infer(x)) == _bytes(warm.infer(x))


def test_different_knobs_never_alias(tiny, tmp_path):
    net, params, x, labels, _ = tiny
    root = str(tmp_path)
    synthesize(net, params, validation=(x, labels), max_degradation=MAX_DEG,
               artifact_store=ArtifactStore(root))
    k1 = synthesis_request_key(net, params, validation=(x, labels),
                               max_degradation=MAX_DEG)
    k2 = synthesis_request_key(net, params, validation=(x, labels),
                               max_degradation=0.5)
    k3 = synthesis_request_key(net, params, validation=(x, labels),
                               max_degradation=MAX_DEG, allow_int8=True)
    assert len({k1, k2, k3}) == 3


# ------------------------------------------------------- rejection paths ----
def test_truncation_rejected(fresh_program, tmp_path):
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program)
    weights = os.path.join(store.program_dir(fp), "weights.bin")
    with open(weights, "r+b") as f:
        f.truncate(os.path.getsize(weights) // 2)
    assert store.load_program(fp, device="cpu") is None
    assert store.invalid == 1 and store.stats()["invalid_program"] == 1


def test_bitflip_rejected(fresh_program, tmp_path):
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program)
    weights = os.path.join(store.program_dir(fp), "weights.bin")
    blob = bytearray(open(weights, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(weights, "wb") as f:
        f.write(blob)
    assert store.load_program(fp, device="cpu") is None
    assert store.invalid == 1


def test_semantic_tamper_rejected_despite_valid_sha(fresh_program, tmp_path):
    """program.json edited AND the manifest's sha fixed: the recomputed
    fingerprint no longer matches the artifact's identity."""
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program)
    d = store.program_dir(fp)
    doc = json.load(open(os.path.join(d, "program.json")))
    name, lp = next(iter(doc["plan"]["layers"].items()))
    lp["vmem_budget"] = int(lp["vmem_budget"] or 0) + 12345
    raw = (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()
    with open(os.path.join(d, "program.json"), "wb") as f:
        f.write(raw)
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    manifest["files"]["program.json"] = hashlib.sha256(raw).hexdigest()
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    assert store.load_program(fp, device="cpu") is None
    assert store.invalid == 1


def test_schema_version_bump_rejected(fresh_program, tmp_path):
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program)
    path = os.path.join(store.program_dir(fp), "manifest.json")
    manifest = json.load(open(path))
    manifest["schema_version"] = ARTIFACT_SCHEMA_VERSION + 1
    with open(path, "w") as f:
        json.dump(manifest, f)
    assert store.load_program(fp, device="cpu") is None
    assert store.invalid == 1


def test_index_version_bump_reads_as_none(fresh_program, tmp_path):
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program, request_key="req1")
    assert store.lookup("req1") == fp
    path = os.path.join(str(tmp_path), "index", "req1.json")
    with open(path, "w") as f:
        json.dump({"schema_version": ARTIFACT_SCHEMA_VERSION + 1,
                   "producer": "repro_torch", "fingerprint": fp}, f)
    assert store.lookup("req1") is None
    assert store.invalid == 1


def test_garbage_manifest_never_crashes(fresh_program, tmp_path):
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program)
    with open(os.path.join(store.program_dir(fp), "manifest.json"), "w") as f:
        f.write("not json {{{")
    assert store.load_program(fp, device="cpu") is None
    assert store.invalid == 1


# -------------------------------------------------------- concurrent puts ---
def test_concurrent_puts_one_winner_no_torn_reads(fresh_program, tmp_path):
    store = ArtifactStore(str(tmp_path))
    fp = fresh_program.fingerprint()
    n_writers, n_reads = 6, 24
    start = threading.Barrier(n_writers + 1)
    errors, loads = [], []

    def writer():
        try:
            start.wait(timeout=30.0)
            assert store.put_program(fresh_program) == fp
        except Exception as e:
            errors.append(e)

    def reader():
        try:
            start.wait(timeout=30.0)
            reader_store = ArtifactStore(str(tmp_path))
            for _ in range(n_reads):
                p = reader_store.load_program(fp, device="cpu")
                if p is not None:
                    loads.append(p.fingerprint())
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(n_writers)]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert all(loaded == fp for loaded in loads)
    assert store.writes == n_writers
    assert os.listdir(os.path.join(str(tmp_path), "programs")) == [fp]
    final = ArtifactStore(str(tmp_path))
    assert final.load_program(fp, device="cpu") is not None
    assert final.invalid == 0


# ------------------------------------------------------------- serving L3 ---
def test_cache_l3_warm_start_zero_compiles(tiny, fresh_program, tmp_path):
    """Plan-only: the warm tier builds every bucket again, each a
    ``kind=executable`` miss, never invalid, and serves the same bits."""
    net, params, x, labels, _ = tiny
    root = str(tmp_path)
    cfg = ServingConfig(max_batch=4, artifact_dir=root)

    cold_reg = MetricsRegistry()
    cold = ReplicaSet(fresh_program, config=cfg, registry=cold_reg)
    warm_replicas(cold)
    assert cold.cache.stats.stage_d_compiles == 3          # buckets 1, 2, 4
    assert cold.cache.store is not None
    assert cold.cache.store.writes == 0                    # no executable

    assert not executables_supported()
    warm_reg = MetricsRegistry()
    warm = ReplicaSet(fresh_program, config=cfg, registry=warm_reg)
    warm_replicas(warm)
    assert warm.cache.stats.stage_d_compiles == 3
    assert warm_reg.get("artifact_misses_total").value(kind="executable") == 3
    assert warm_reg.get("artifact_hits_total").value(kind="executable") == 0
    assert warm_reg.get("artifact_invalid_total").value(kind="executable") == 0
    a = warm.infer_one(x[0].numpy())
    b = fresh_program.infer(x[:1])[0]
    assert _bytes(torch.as_tensor(a)) == _bytes(b)


def test_executable_stamp_mismatch_is_plan_only_not_invalid(
        fresh_program, tmp_path):
    """No executable is written; a sidecar placed from elsewhere is never
    read: a plan-only miss, not invalid."""
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(fresh_program)
    assert store.put_executable(fresh_program, 2) is False
    meta_path = os.path.join(store.program_dir(fp), "exec_b2.json")
    assert not os.path.exists(meta_path)
    with open(meta_path, "w") as f:
        json.dump({"schema_version": ARTIFACT_SCHEMA_VERSION,
                   "jaxlib": "0.0.0-foreign", "platforms": ["tpu"]}, f)
    assert store.load_executable(fresh_program, 2) is None
    stats = store.stats()
    assert stats["invalid_executable"] == 0
    assert stats["misses_executable"] == 1


def test_executable_corruption_is_invalid(fresh_program, tmp_path):
    """The reference counts a corrupt executable invalid; the port reads no
    executable, so a corrupt sidecar is a plan-only miss, never a crash."""
    tracer = Tracer()
    store = ArtifactStore(str(tmp_path), tracer=tracer)
    fp = store.put_program(fresh_program)
    with open(os.path.join(store.program_dir(fp), "exec_b2.json"), "wb") as f:
        f.write(b"\x00" * 8)
    assert store.load_executable(fresh_program, 2) is None
    assert store.stats()["invalid_executable"] == 0
    assert store.stats()["misses_executable"] == 1
    assert tracer.by_name("serve.artifact_plan_only")
    assert store.load_program(fp, device="cpu") is not None


def test_store_spans_recorded(fresh_program, tmp_path):
    tracer = Tracer()
    store = ArtifactStore(str(tmp_path), tracer=tracer)
    fp = store.put_program(fresh_program)
    assert store.load_program(fp, device="cpu") is not None
    spans = tracer.by_name("serve.artifact_hydrate")
    assert spans and spans[0].attrs["kind"] == "program"


def test_program_cache_store_kwarg_round_trip(fresh_program, tmp_path):
    """ProgramCache(store=): write-back records plan-only, and a second
    cache on the same store builds the bucket again with the same bits."""
    tracer = Tracer()
    c1 = ProgramCache(store=ArtifactStore(str(tmp_path), tracer=tracer))
    c1.admit(fresh_program)
    built = c1.get_or_build(fresh_program, 2)
    assert built.compile_seconds > 0.0
    assert tracer.by_name("serve.artifact_plan_only")

    c2 = ProgramCache(store=ArtifactStore(str(tmp_path)))
    c2.admit(fresh_program)
    rebuilt = c2.get_or_build(fresh_program, 2)
    assert c2.stats.stage_d_compiles == 1
    assert c2.store.stats()["misses_executable"] == 1
    x = torch.zeros((2, 3, 67, 67))
    assert _bytes(built(x)) == _bytes(rebuilt(x))


# ------------------------------------------- differences from the reference --
@pytest.mark.parametrize("knob", ["planner_batch", "planner_u_max",
                                  "autotune_input"])
def test_request_key_covers_planner_config_and_autotune_input(tiny, knob):
    """Two PlannerConfigs (or two autotune inputs) give two port keys; the
    reference's key, which hashes neither, gives one for the same pair."""
    net, params, x, labels, np_params = tiny
    jnet = jax_alexnet(**KW)
    jparams = params_to_jax(np_params)
    if knob == "autotune_input":
        kw_a, kw_b = dict(autotune_input=x[:4]), dict(autotune_input=x[4:])
    else:
        field = {"planner_batch": ("batch", 1, 8),
                 "planner_u_max": ("u_max", 128, 64)}[knob]
        kw_a = dict(planner_config=PlannerConfig(**{field[0]: field[1]}))
        kw_b = dict(planner_config=PlannerConfig(**{field[0]: field[2]}))
    ours = {synthesis_request_key(net, params, autotune=True, **kw)
            for kw in (kw_a, kw_b)}
    assert len(ours) == 2
    # The reference's key takes no planner config and no autotune input.
    ref = {jax_artifacts.synthesis_request_key(jnet, jparams, autotune=True)
           for _ in (kw_a, kw_b)}
    assert len(ref) == 1


def test_synthesize_misses_on_another_planner_batch(tiny, tmp_path):
    net, params, x, labels, _ = tiny
    root = str(tmp_path)
    synthesize(net, params, planner_config=PlannerConfig(batch=8),
               forced_mode=ComputeMode.RELAXED,
               artifact_store=ArtifactStore(root))
    reg = MetricsRegistry()
    store = ArtifactStore(root, registry=reg)
    other = synthesize(net, params, planner_config=PlannerConfig(batch=1),
                       forced_mode=ComputeMode.RELAXED, artifact_store=store)
    assert store.hits == 0 and store.misses >= 1
    assert store.writes == 1
    again = synthesize(net, params, planner_config=PlannerConfig(batch=8),
                       forced_mode=ComputeMode.RELAXED, artifact_store=store)
    assert store.hits == 1
    assert len(os.listdir(os.path.join(root, "index"))) == 2
    assert other.plan.fingerprint() and again.synthesis_report is not None


def _same_profiles():
    """One set of hardware numbers in both packages' profile types."""
    tprof = dataclasses.replace(H100, vmem_budget=232_448)
    return JaxDeviceProfile(**dataclasses.asdict(tprof)), tprof


def test_codec_documents_equal_the_reference(tiny):
    """Network, graph and modes documents of the same program are equal;
    a plan document passes through the other package's codec unchanged in
    both directions (the two packages name their kernel impl differently,
    so their planned documents differ in those names only)."""
    net, params, x, labels, _ = tiny
    jnet = jax_alexnet(**KW)
    assert codec.encode_network(net) == jax_codec.encode_network(jnet)
    graph, jgraph = lower_network(net), jax_lower_network(jnet)
    assert codec.encode_graph(graph) == jax_codec.encode_graph(jgraph)
    modes = {n: ComputeMode.RELAXED for n in net.inexactable_layers}
    jmodes = {n: JaxMode.RELAXED for n in jnet.inexactable_layers}
    assert codec.encode_modes(modes) == jax_codec._encode_modes(jmodes)

    jprof, tprof = _same_profiles()
    ours = plan_network(net, modes=modes, graph=graph,
                        config=PlannerConfig(profile=tprof, batch=8,
                                             allow_pallas=True))
    ref = jax_plan_network(jnet, modes=jmodes, graph=jgraph,
                           config=JaxPlannerConfig(profile=jprof, batch=8,
                                                   allow_pallas=True))
    ours_doc, ref_doc = codec.encode_plan(ours), jax_codec.encode_plan(ref)
    assert codec.encode_plan(codec.decode_plan(ref_doc)) == ref_doc
    assert jax_codec.encode_plan(jax_codec.decode_plan(ours_doc)) == ours_doc
    assert ours_doc.keys() == ref_doc.keys()
    assert ours_doc["profile"] == ref_doc["profile"]
    assert ours_doc["graph"] == ref_doc["graph"]
    names = {"pallas_mapmajor": "cuda_mapmajor"}
    for name, lp in ref_doc["layers"].items():
        mine = dict(ours_doc["layers"][name])
        theirs = dict(lp, impl=names.get(lp["impl"], lp["impl"]))
        mine.pop("reason"), theirs.pop("reason")
        assert mine == theirs, name


def test_weights_round_trip_every_dtype():
    """bf16, int8 payloads with f32 scales, f32: bit-exact through the blob,
    on the device asked for."""
    from repro_torch.core.precision import quantize_int8
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 5, generator=g)
    prepared = {"a": {"w": w.to(torch.bfloat16), "b": torch.randn(6, generator=g)},
                "b": {"w": quantize_int8(w, channel_axis=0)}}
    entries, blob = codec.encode_weights(prepared)
    back = codec.decode_weights(entries, blob, device="cpu")
    assert torch.equal(back["a"]["w"].view(torch.int16),
                       prepared["a"]["w"].view(torch.int16))
    assert torch.equal(back["a"]["b"], prepared["a"]["b"])
    assert torch.equal(back["b"]["w"].q, prepared["b"]["w"].q)
    assert torch.equal(back["b"]["w"].scale, prepared["b"]["w"].scale)
    with pytest.raises(codec.ArtifactCodecError, match="truncated"):
        codec.decode_weights(entries, blob[:-3], device="cpu")


def test_reference_written_store_is_a_miss(tiny, tmp_path):
    """A directory the JAX package wrote is foreign: the port never
    hydrates it, counts a miss and no invalid, and synthesizes cold."""
    net, params, x, labels, np_params = tiny
    jnet = jax_alexnet(**KW)
    jprog = jax_synthesize(jnet, params_to_jax(np_params),
                           forced_mode=JaxMode.RELAXED)
    root = str(tmp_path)
    jfp = jax_artifacts.ArtifactStore(root).put_program(jprog,
                                                        request_key="jreq")
    store = ArtifactStore(root)
    assert store.load_program(jfp, device="cpu") is None
    assert store.lookup("jreq") is None
    assert store.misses == 1 and store.invalid == 0
    program = synthesize(net, params, forced_mode=ComputeMode.RELAXED,
                         artifact_store=store)
    assert store.hits == 0 and store.writes == 1
    assert store.load_program(program.fingerprint(), device="cpu") is not None
    assert np.isfinite(np.asarray(jnp.asarray(jprog.infer(
        jnp.asarray(x[:1].numpy()))))).all()
