"""Port parity of the CNN serving tier (``repro_torch.serving``) and of the
observability ``synthesize`` records, against the JAX package on the CPU.

* Batcher and dispatch: the same scripted arrivals and pumps, under one
  injected clock, go through both packages' tiers (duck-typed programs, no
  synthesis); bucket sizes, flush reasons, placements, steals, sheds, the
  Prometheus text of the tier's registry and its span JSONL are identical.
* Program cache and server: a real scaled SqueezeNet (weights made with
  numpy).  Through the port's server a request's output equals the
  bucket's ``for_batch`` on the same image batch bit for bit, and the JAX
  server's output within ``mode_tolerance(RELAXED)`` (rtol, with atol =
  rtol x max|reference|); Stage-D builds stay within ceil(log2 n) + 1.
* ``synthesize(tracer=, registry=)``: the same span names, in the same
  order, with the same attributes (fingerprints aside), and the same
  counter values (wall seconds aside) as the reference.
* ``serve_cnn.main()`` on the CPU prints the reference's banner lines.

The CUDA-graph Stage D itself needs the card: tests/test_torch_stage_d.py.
"""
import math
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.synthesizer as jax_synth
import repro.serving.batcher as jax_batcher
import repro_torch.core.synthesizer as torch_synth
import repro_torch.serving.batcher as torch_batcher
from repro import obs as jax_obs
from repro import serving as jax_serving
from repro.cnn import alexnet as jax_alexnet
from repro.cnn import squeezenet as jax_squeezenet
from repro.core import ComputeMode as JaxMode
from repro.core import synthesize as jax_synthesize
from repro_torch import obs, serving
from repro_torch.cnn import alexnet, params_from_numpy, squeezenet
from repro_torch.core import BatchProgram, ComputeMode, synthesize
from repro_torch.launch import serve_cnn
from repro_torch.serving import (ProgramCache, ReplicaSet, ServingConfig,
                                 SynthesisServer, run_offered_load,
                                 warm_replicas)

from _torch_parity import (assert_close, params_to_jax, reference_params,
                           to_jax)

SQ_KW = dict(scale=0.08, num_classes=10, input_hw=64)


class FakeClock:
    """Deterministic clock: returns ``start`` then advances by ``step``."""

    def __init__(self, start=100.0, step=0.001):
        self.now = start
        self.step = step

    def __call__(self):
        t, self.now = self.now, self.now + self.step
        return t


# ------------------------------------------------------- fake programs ----
class _FakeBatch:
    """Stage-D stand-in: doubles its input."""

    compile_seconds = 0.0
    graph_bytes = 0

    def __init__(self, to_numpy):
        self.to_numpy = to_numpy

    def __call__(self, x):
        return self.to_numpy(x) * 2.0


class FakeProgram:
    """Duck-typed SynthesizedProgram for either package's tier."""

    def __init__(self, port: bool, name="fakenet", fp="fake-fp"):
        self.net = SimpleNamespace(name=name, input_shape=(3,))
        self.plan = SimpleNamespace(profile=SimpleNamespace(name="fake_dev"))
        self._fp = fp
        if port:
            self.input_dtype = torch.float32
            self.device = torch.device("cpu")
            self._to_numpy = lambda x: x
        else:
            self.input_dtype = jnp.float32
            self._to_numpy = np.asarray
        self.built = []

    def fingerprint(self):
        return self._fp

    def for_batch(self, batch):
        self.built.append(_FakeBatch(self._to_numpy))
        return self.built[-1]


PACKAGES = {"reference": (jax_serving, jax_obs, jax_batcher, False),
            "port": (serving, obs, torch_batcher, True)}


def _img(v):
    return np.full(3, float(v), np.float32)


def _tier(pkg, monkeypatch, **cfg):
    """A fake-program tier of one package whose registry, tracer and batcher
    all read one deterministic clock."""
    srv, ob, batcher_mod, port = PACKAGES[pkg]
    clock = FakeClock()
    monkeypatch.setattr(batcher_mod, "time", SimpleNamespace(perf_counter=clock))
    registry = ob.MetricsRegistry(clock=clock)
    tracer = ob.Tracer(clock=clock)
    config = srv.ServingConfig(**cfg)
    return srv.ReplicaSet(FakeProgram(port), config=config,
                          registry=registry, tracer=tracer), clock


# Each script: tier config, then steps.  ("submit", n) admits n images (a
# shed is recorded, not raised); ("pump", replica, force) pumps; ("tick",
# dt) advances the clock; ("rr", k) sets the round-robin counter.
SCRIPTS = {
    "least_loaded_depth_and_deadline": (
        dict(replicas=2, dispatch="least_loaded", max_batch=4,
             max_delay_s=0.05, max_queue_depth=0),
        [("submit", 9), ("pump", 0, False), ("pump", 1, False),
         ("pump", 0, False), ("tick", 0.1), ("pump", 1, False),
         ("pump", 0, False), ("pump", None, True)]),
    "flush_depth_pads_to_pow2": (
        dict(replicas=1, max_batch=8, flush_depth=3, max_delay_s=60.0),
        [("submit", 3), ("pump", 0, False), ("submit", 5), ("pump", 0, False),
         ("pump", 0, False), ("pump", 0, True), ("pump", 0, True)]),
    "work_stealing_overflow": (
        dict(replicas=2, dispatch="work_stealing", max_batch=2,
             max_delay_s=60.0, max_queue_depth=0),
        [("submit", 8), ("pump", 1, True), ("pump", 1, True),
         ("pump", 1, False), ("pump", 1, False), ("pump", None, True),
         ("pump", None, True)]),
    "admission_sheds_at_bound": (
        dict(replicas=2, dispatch="least_loaded", max_batch=4,
             max_delay_s=60.0, max_queue_depth=3),
        [("submit", 8), ("pump", 0, True), ("submit", 3), ("pump", None, True),
         ("pump", None, True)]),
    "round_robin_falls_over_before_shedding": (
        dict(replicas=2, dispatch="work_stealing", max_batch=2,
             max_delay_s=60.0, max_queue_depth=2),
        [("submit", 4), ("pump", 0, True), ("rr", 1), ("submit", 1),
         ("submit", 2), ("pump", None, True), ("pump", None, True)]),
}


def _run_script(pkg, monkeypatch, name):
    cfg, steps = SCRIPTS[name]
    tier, clock = _tier(pkg, monkeypatch, **cfg)
    shed_error = PACKAGES[pkg][0].LoadShedError
    log, futures, k = [], [], 0
    for step in steps:
        if step[0] == "submit":
            for _ in range(step[1]):
                try:
                    futures.append((k, tier.submit(_img(k))))
                    log.append(("admit", k, [r.depth for r in tier.replicas]))
                except shed_error as e:
                    log.append(("shed", k, e.depths, e.max_queue_depth))
                k += 1
        elif step[0] == "pump":
            served = tier.pump(replica=step[1], force=step[2])
            log.append(("pump", step[1], served,
                        [r.depth for r in tier.replicas],
                        [r.stolen_requests for r in tier.replicas]))
        elif step[0] == "tick":
            clock.now += step[1]
        else:
            tier._rr = step[1]
    outs = {i: f.result(timeout=5.0).tolist() for i, f in futures}
    stats = tier.stats()
    return dict(log=log, outs=outs, stats=stats,
                prometheus=PACKAGES[pkg][1].to_prometheus(tier.registry),
                spans=tier.tracer.to_jsonl())


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_batcher_and_dispatch_decisions_match_reference(monkeypatch, name):
    """Same scripted arrivals, same clock: the same buckets (sizes, padding,
    flush reasons in the registry), placements, steals and sheds; identical
    Prometheus text and span JSONL."""
    ref = _run_script("reference", monkeypatch, name)
    ours = _run_script("port", monkeypatch, name)
    assert ours["log"] == ref["log"]
    assert ours["outs"] == ref["outs"]
    assert ours["stats"] == ref["stats"]
    assert ours["prometheus"] == ref["prometheus"]
    assert ours["spans"] == ref["spans"]
    # every admitted request came back as its own row, doubled
    for i, row in ours["outs"].items():
        assert row == (_img(i) * 2.0).tolist()


@pytest.mark.parametrize("case", ["policies", "config_validation",
                                  "exports", "artifact_dir"])
def test_serving_surface_matches_reference(case):
    if case == "policies":
        for pol in serving.DISPATCH_POLICIES:
            ours = serving.resolve_dispatch_policy(pol)
            ref = jax_serving.resolve_dispatch_policy(pol)
            for depths in ([3, 1, 2], [2, 2, 2], [0, 5], [9, 0, 0]):
                assert [ours.select(depths, rr) for rr in range(5)] == \
                    [ref.select(depths, rr) for rr in range(5)]
            assert ours.steals == ref.steals
        with pytest.raises(ValueError, match="unknown dispatch policy"):
            serving.resolve_dispatch_policy("random")
    elif case == "config_validation":
        bad = [dict(max_batch=6), dict(replicas=0), dict(cache_entries=0),
               dict(dispatch="random"), dict(max_queue_depth=-1),
               dict(max_batch=4, flush_depth=5), dict(max_delay_s=-1.0)]
        for kw in bad:
            with pytest.raises(ValueError):
                jax_serving.ServingConfig(**kw)
            with pytest.raises(ValueError):
                ServingConfig(**kw)
        cfg = ServingConfig(max_batch=4, replicas=3)
        assert cfg.with_replicas(1) == ServingConfig(max_batch=4, replicas=1)
        assert [serving.pow2_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == \
            [jax_serving.pow2_bucket(n) for n in (1, 2, 3, 5, 8, 9)]
    elif case == "exports":
        assert set(serving.__all__) == \
            set(jax_serving.__all__) - {"ServingEngine", "GenerationResult"}
    else:
        with pytest.raises(NotImplementedError, match="item 10"):
            ServingConfig(artifact_dir="/nonexistent")


@pytest.mark.parametrize("shim", ["batcher", "cache", "server", "loadgen"])
def test_deprecated_shims_warn_as_in_reference(shim):
    policy = serving.FlushPolicy(max_batch=4)
    with pytest.warns(DeprecationWarning):
        if shim == "batcher":
            serving.DynamicBatcher(policy)
        elif shim == "cache":
            ProgramCache(max_entries=2)
        elif shim == "server":
            SynthesisServer(FakeProgram(True), policy=policy)
        else:
            run_offered_load(FakeProgram(True), requests=2, policy=policy)


# --------------------------------------------- program cache (fakes) ------
@pytest.mark.parametrize("case", ["hits_and_compiles", "lru_evicts_and_releases",
                                  "requires_admit", "warm_replicas_share"])
def test_program_cache(case):
    prog = FakeProgram(True)
    if case == "hits_and_compiles":
        cache = ProgramCache()
        cache.admit(prog)
        a = cache.get_or_build(prog, 2)
        assert cache.get_or_build(prog, 2) is a
        assert cache.get_or_build(prog, 4) is not a
        assert cache.stats.as_dict() == {
            "hits": 1, "misses": 2, "stage_d_compiles": 2,
            "stage_d_seconds": 0.0, "evictions": 0, "hit_rate": 0.3333}
    elif case == "lru_evicts_and_releases":
        cache = ProgramCache(config=ServingConfig(cache_entries=2))
        cache.admit(prog)
        a1 = cache.get_or_build(prog, 1)
        cache.get_or_build(prog, 2)
        cache.get_or_build(prog, 1)                    # 1 is now newest
        cache.get_or_build(prog, 4)                    # evicts bucket 2
        assert cache.stats.evictions == 1 and len(cache) == 2

        def key(b):
            return ("fakenet", b, "fake-fp")

        assert key(2) not in cache and key(1) in cache and key(4) in cache
        assert cache.get_or_build(prog, 1) is a1        # order: 4, 1
        assert cache.get_or_build(prog, 2) is not prog.built[1]   # evicts 4
        assert cache.stats.stage_d_compiles == 4
        assert [key(b) in cache for b in (1, 2, 4)] == [True, True, False]
        # an evicted program stays usable for whoever still holds it
        np.testing.assert_array_equal(prog.built[1](np.ones(3)), 2.0)
    elif case == "requires_admit":
        with pytest.raises(KeyError):
            ProgramCache().get_or_build(prog, 1)
    else:
        tier = ReplicaSet(prog, config=ServingConfig(max_batch=4, replicas=2))
        seconds = warm_replicas(tier)
        assert len(seconds) == 2
        assert [r.warm_seconds for r in tier.replicas] == seconds
        assert tier.cache.stats.stage_d_compiles == 3
        assert tier.cache.stats.hits == 3


def test_program_cache_builds_each_bucket_once_under_races():
    """16 threads race for 4 buckets: each builds once, the rest are hits."""
    prog = FakeProgram(True)
    calls = []
    inner = prog.for_batch

    def slow_for_batch(batch):
        calls.append(batch)
        time.sleep(0.01)
        return inner(batch)

    prog.for_batch = slow_for_batch
    cache = ProgramCache()
    cache.admit(prog)
    got = {}

    def worker(t):
        got[t] = cache.get_or_build(prog, 1 << (t % 4))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30.0)
    assert not any(th.is_alive() for th in threads)
    assert sorted(calls) == [1, 2, 4, 8]
    assert cache.stats.stage_d_compiles == 4 and cache.stats.hits == 12
    assert all(got[t] is got[t % 4] for t in range(16))


# ------------------------------------------------- BatchProgram replay ----
class _FakeGraph:
    """CUDA-graph stand-in: replay computes static_out = 3 * static_in."""

    def __init__(self):
        self.static_in = self.static_out = None
        self.replays = 0

    def replay(self):
        time.sleep(0.0005)                 # widen any race between threads
        self.replays += 1
        self.static_out.copy_(self.static_in * 3)


def _captured(batch, width=3):
    """A BatchProgram over a stand-in graph, as for_batch builds on the card."""
    graph = _FakeGraph()
    graph.static_in = torch.zeros(batch, width)
    graph.static_out = torch.zeros(batch, width)
    return BatchProgram(batch=batch, input_shape=(batch, width),
                        plan_fingerprint="fp", compile_seconds=0.0,
                        _forward=None, _graph=graph,
                        _static_in=graph.static_in,
                        _static_out=graph.static_out)


def test_batch_program_replay_copies_clones_counts_and_serializes():
    """The replay path of a captured BatchProgram, with a stand-in graph:
    each of 4 threads gets its own input's result, the output is a clone
    (not the static tensor), and every call replays the graph once."""
    bp = _captured(2)
    graph = bp._graph
    assert bp.captured
    results, errors = {}, []

    def caller(t):
        x = torch.full((2, 3), float(t))
        for _ in range(25):
            y = bp(x)
            if not torch.equal(y, x * 3):
                errors.append(t)
        results[t] = y

    threads = [threading.Thread(target=caller, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30.0)
    assert not any(th.is_alive() for th in threads) and not errors
    assert all(results[t].data_ptr() != graph.static_out.data_ptr()
               for t in range(4))
    assert graph.replays == 100
    with pytest.raises(ValueError, match="for_batch"):
        bp(torch.zeros(3, 3))
    assert graph.replays == 100


def test_eviction_under_concurrent_dispatch_fails_no_request():
    """Two servers share a one-entry cache of captured programs and their
    threads alternate buckets 1 and 2, so each build evicts the program the
    other thread may hold: a held program stays callable, and no request
    fails."""
    prog = FakeProgram(True)
    prog.for_batch = lambda batch: (time.sleep(0.002), _captured(batch))[1]
    cfg = ServingConfig(cache_entries=1, max_batch=2)
    cache = ProgramCache(config=cfg)
    servers = [SynthesisServer(prog, config=cfg, cache=cache) for _ in range(2)]
    held = cache.get_or_build(prog, 1)
    cache.get_or_build(prog, 2)                       # evicts bucket 1
    assert cache.stats.evictions == 1
    assert torch.equal(held(torch.ones(1, 3)), torch.full((1, 3), 3.0))
    results, errors = [], []

    def client(t):
        for r in range(30):
            n = 1 + (r + t) % 2                       # buckets 1 and 2 in turn
            futs = [servers[t].submit(_img(10 * t + i)) for i in range(n)]
            servers[t].pump(force=True)
            for i, f in enumerate(futs):
                try:
                    results.append(np.array_equal(f.result(timeout=30),
                                                  3 * _img(10 * t + i)))
                except Exception as exc:               # noqa: BLE001
                    errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(results) == 90 and all(results)
    assert sum(s.stats.failed for s in servers) == 0
    assert cache.stats.evictions > 1


# ------------------------------------------- real programs (scaled nets) --
@pytest.fixture(scope="module")
def squeeze():
    """The scaled SqueezeNet, RELAXED, in both packages from one set of
    numpy weights."""
    jnet, net = jax_squeezenet(**SQ_KW), squeezenet(**SQ_KW)
    np_params = reference_params(jnet)
    ours = synthesize(net, params_from_numpy(np_params, "cpu"),
                      forced_mode=ComputeMode.RELAXED)
    ref = jax_synthesize(jnet, params_to_jax(np_params),
                         forced_mode=JaxMode.RELAXED)
    return ours, ref, np_params


def _images(n, seed, shape=(3, 64, 64)):
    return np.random.default_rng(seed).standard_normal((n, *shape)) \
        .astype(np.float32)


def test_server_round_trip_bitwise_and_within_reference(squeeze):
    """11 single requests: one bucket of 8 and a padded bucket of 4; each
    row equals its bucket's for_batch on the same (zero-padded) batch bit
    for bit and the JAX server's row within mode_tolerance(RELAXED); at
    most ceil(log2 11) + 1 Stage-D builds."""
    prog, jprog, _ = squeeze
    n = 11
    imgs = _images(n, 42)
    server = SynthesisServer(prog, config=ServingConfig(max_batch=8,
                                                        max_delay_s=60.0))
    futures = [server.submit(imgs[i]) for i in range(n)]
    assert server.drain() == n
    outs = np.stack([f.result(timeout=5.0) for f in futures])

    padded = np.concatenate([imgs[8:], np.zeros((1, 3, 64, 64), np.float32)])
    direct = np.concatenate([
        prog.for_batch(8)(torch.from_numpy(imgs[:8])).numpy(),
        prog.for_batch(4)(torch.from_numpy(padded)).numpy()[:3]])
    np.testing.assert_array_equal(outs, direct)
    assert server.cache.stats.stage_d_compiles <= math.ceil(math.log2(n)) + 1
    assert server.stats.completed == n and server.stats.failed == 0
    assert server.stats.bucket_counts == {8: 1, 4: 1}
    assert server.stats.padded_slots == 1

    jserver = jax_serving.SynthesisServer(
        jprog, config=jax_serving.ServingConfig(max_batch=8, max_delay_s=60.0))
    jfutures = [jserver.submit(imgs[i]) for i in range(n)]
    jserver.drain()
    assert_close(outs, np.stack([f.result(timeout=5.0) for f in jfutures]),
                 ComputeMode.RELAXED)


def record_buckets(tier):
    """Wrap every replica server's dispatch_bucket to log (images, batch) of
    each bucket it dispatches."""
    log = []
    for r in tier.replicas:
        def logged(bucket, _inner=r.server.dispatch_bucket):
            log.append(([q.image for q in bucket.requests], bucket.batch))
            _inner(bucket)
        r.server.dispatch_bucket = logged
    return log


def bucket_reference(prog, images, batch):
    """What the bucket's BatchProgram returns for these images, zero-padded
    to ``batch``: one row per image."""
    x = np.stack(images)
    x = np.concatenate([x, np.zeros((batch - len(x), *x.shape[1:]), x.dtype)])
    return prog.for_batch(batch)(torch.from_numpy(x)).numpy()[:len(images)]


@pytest.mark.parametrize("replicas,dispatch", [(1, "least_loaded"),
                                               (2, "least_loaded"),
                                               (2, "work_stealing")])
def test_threaded_tier_serves_every_request_bitwise(squeeze, replicas,
                                                    dispatch):
    """Threaded replicas: nothing shed or failed, every response equals its
    bucket's for_batch on the same (zero-padded) image batch bit for bit,
    and the tier's snapshot and trace hold the serving series and spans."""
    prog, _, _ = squeeze
    n = 12
    registry = obs.MetricsRegistry()
    tracer = obs.Tracer(clock=registry.clock)
    config = ServingConfig(max_batch=4, max_delay_s=0.002, replicas=replicas,
                           dispatch=dispatch)
    tier = ReplicaSet(prog, config=config, registry=registry, tracer=tracer)
    warm_replicas(tier)
    log = record_buckets(tier)
    imgs = list(_images(n, 7))             # one array object per request
    with tier:
        futs = [tier.submit(imgs[i]) for i in range(n)]
        outs = {id(imgs[i]): f.result(timeout=60.0) for i, f in enumerate(futs)}
    assert sum(len(images) for images, _ in log) == n
    for images, batch in log:
        want = bucket_reference(prog, images, batch)
        for row, img in zip(want, images):
            np.testing.assert_array_equal(outs[id(img)], row)
    stats = tier.stats()
    assert stats["submitted"] == n and stats["shed_requests"] == 0
    assert sum(r["completed"] for r in stats["replicas"]) == n
    assert sum(r["failed"] for r in stats["replicas"]) == 0
    assert tier.cache.stats.stage_d_compiles == 3
    snap = registry.snapshot()
    assert {"serving_dispatch_seconds", "serving_cache_hits_total",
            "serving_tier_submitted_total"} <= set(snap)
    names = {s.name for s in tracer.finished()}
    assert {"serve.dispatch", "serve.batch_wait",
            "synthesis.stage_d_compile"} <= names


def test_load_report_counts_the_run(squeeze):
    prog, _, _ = squeeze
    report = run_offered_load(prog, requests=10, config=ServingConfig(
        max_batch=4, max_delay_s=0.002, replicas=2), seed=3)
    assert report.admitted + report.shed_requests == report.requests == 10
    assert report.server_stats["failed"] == 0
    assert report.server_stats["completed"] == report.admitted
    assert len(report.latencies_ms) == report.admitted
    assert report.latencies_ms == sorted(report.latencies_ms)
    assert report.latency_ms(50) <= report.latency_ms(99)
    assert serving.percentile([], 50) != serving.percentile([], 50)   # nan


def test_failed_bucket_fails_every_future_and_is_not_served(squeeze):
    prog, _, _ = squeeze
    server = SynthesisServer(prog, config=ServingConfig(max_batch=4,
                                                        max_delay_s=60.0))
    server.cache.get_or_build = lambda program, batch: (_ for _ in ()).throw(
        RuntimeError("boom"))
    futs = [server.submit(np.zeros((3, 64, 64), np.float32)) for _ in range(3)]
    server.drain()
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=5.0)
    assert server.stats.failed == 3 and server.stats.completed == 0


def test_program_cache_distinguishes_weights(squeeze):
    """Mirror of the reference's test of the same name, asserting its
    intent: same network and plan, different weights -> distinct program
    fingerprints, two Stage-D builds, no hit, different outputs."""
    prog, _, _ = squeeze
    net = prog.net
    other = synthesize(net, params_from_numpy(
        reference_params(jax_squeezenet(**SQ_KW), seed=99), "cpu"),
        forced_mode=ComputeMode.RELAXED)
    assert other.plan.fingerprint() == prog.plan.fingerprint()
    assert other.fingerprint() != prog.fingerprint()
    cache = ProgramCache()
    cache.admit(prog)
    cache.admit(other)
    x = torch.from_numpy(_images(1, 5))
    out1 = cache.get_or_build(prog, 1)(x)
    out2 = cache.get_or_build(other, 1)(x)
    assert cache.stats.stage_d_compiles == 2 and cache.stats.hits == 0
    assert not torch.equal(out1, out2)


def test_for_devices_places_replicas_and_keeps_profiles_apart(squeeze):
    """One replica per profile on the CPU: two profiles -> two fingerprints,
    each bucket built once per profile; the outputs agree bit for bit
    (same weights, same routing)."""
    _, _, np_params = squeeze
    import dataclasses
    from repro_torch.device import CPU
    slow_cpu = dataclasses.replace(CPU, hbm_bandwidth=CPU.hbm_bandwidth / 2)
    net = squeezenet(**SQ_KW)
    tier = ReplicaSet.for_devices(
        net, params_from_numpy(np_params, "cpu"), [CPU, slow_cpu],
        torch_devices=["cpu", "cpu"], forced_mode=ComputeMode.RELAXED,
        config=ServingConfig(max_batch=2, max_delay_s=60.0, replicas=2))
    fps = {r.program.fingerprint() for r in tier.replicas}
    assert len(fps) == 2
    warm_replicas(tier)
    assert tier.cache.stats.stage_d_compiles == 4 and tier.cache.stats.hits == 0
    x = torch.from_numpy(_images(2, 9))
    a, b = (tier.cache.get_or_build(r.program, 2)(x) for r in tier.replicas)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="torch devices"):
        ReplicaSet.for_devices(net, {}, [CPU], torch_devices=["cpu", "cpu"])


# --------------------------------------------- synthesize(tracer, registry)
PENALTY = {"precise": 0.0, "relaxed": 0.01, "imprecise": 0.03}
WEIGHT = {"conv1": 2.0, "conv2": 0.5, "conv3": 0.2, "conv4": 0.2,
          "conv5": 0.2, "fc6": 0.1, "fc7": 0.1, "fc8": 3.0}


def _stub_metric(modes, gate_scale):
    return 1.0 - gate_scale * sum(WEIGHT[n] * PENALTY[m.value]
                                  for n, m in modes.items() if n in WEIGHT)


def _install_stubs(monkeypatch, module, gate_scale):
    """The shared deterministic evaluator of tests/test_torch_synthesis.py:
    both packages probe and gate the same accuracies; the gate's is
    ``gate_scale`` times harsher than Stage C's probes."""
    monkeypatch.setattr(module, "_accuracy_eval",
                        lambda net, params, images, labels, *rest:
                        lambda plan: _stub_metric(
                            {n: plan.for_layer(n).mode
                             for n in net.inexactable_layers}, 1.0))
    monkeypatch.setattr(module, "_program_accuracy",
                        lambda program, images, labels:
                        _stub_metric(program.modes, gate_scale))


def _span_view(tracer):
    """(name, attrs without fingerprints, parent name) in finish order."""
    spans = tracer.finished()
    by_id = {s.span_id: s for s in spans}
    return [(s.name, {k: v for k, v in s.attrs.items() if k != "fingerprint"},
             by_id[s.parent_id].name if s.parent_id in by_id else None)
            for s in spans]


def _counter_view(registry):
    snap = registry.snapshot()
    seconds = snap.pop("synthesis_seconds_total")
    return snap, seconds


@pytest.mark.parametrize("case", ["forced_squeezenet", "loop_tight",
                                  "loop_gate_demotes"])
def test_synthesize_spans_and_counters_match_reference(monkeypatch, case):
    """The same span names in the same order (attributes and nesting
    included, fingerprints aside) and the same counters (wall seconds
    aside, which must be positive) as the reference: forced mode on the
    scaled SqueezeNet; the fixed-point loop and gate on the scaled AlexNet
    under the shared stub evaluator (the gate-demotes case demotes)."""
    if case == "forced_squeezenet":
        jnet, net = jax_squeezenet(**SQ_KW), squeezenet(**SQ_KW)
        kw = dict(forced_mode=ComputeMode.RELAXED)
        jkw = dict(forced_mode=JaxMode.RELAXED)
    else:
        gate_scale = 3.0 if case == "loop_gate_demotes" else 1.0
        _install_stubs(monkeypatch, torch_synth, gate_scale)
        _install_stubs(monkeypatch, jax_synth, gate_scale)
        akw = dict(scale=0.1, num_classes=10, input_hw=67)
        jnet, net = jax_alexnet(**akw), alexnet(**akw)
        x = np.zeros((4, 3, 67, 67), np.float32)
        y = np.zeros((4,), np.int64)
        budget = 0.05 if case == "loop_gate_demotes" else 0.02
        kw = dict(validation=(torch.from_numpy(x), torch.from_numpy(y)),
                  max_degradation=budget)
        jkw = dict(validation=(to_jax(x), jnp.asarray(y)),
                   max_degradation=budget)
    np_params = reference_params(jnet)
    views = []
    for run, ob, n, p, k in (
            (synthesize, obs, net, params_from_numpy(np_params, "cpu"), kw),
            (jax_synthesize, jax_obs, jnet, params_to_jax(np_params), jkw)):
        registry = ob.MetricsRegistry()
        tracer = ob.Tracer(clock=registry.clock)
        run(n, p, registry=registry, tracer=tracer, **k)
        assert tracer.open_spans() == []
        views.append((_span_view(tracer), *_counter_view(registry)))
    (ours, ours_c, ours_s), (ref, ref_c, ref_s) = views
    assert ours == ref
    assert ours_c == ref_c
    assert ours_s["series"][0]["value"] > 0 and ref_s["series"][0]["value"] > 0
    names = [v[0] for v in ours]
    if case == "forced_squeezenet":
        assert names == ["synthesis.stage_a_plan"]
    else:
        assert "synthesis.stage_c_probe" in names
        assert names[-1] == "synthesis.validation_gate"
        assert ("synthesis.gate_demotion" in names) == \
            (case == "loop_gate_demotes")


# ------------------------------------------------------------ serve_cnn ---
def test_serve_cnn_main_prints_the_reference_banner(capsys, tmp_path):
    metrics, trace = tmp_path / "m.json", tmp_path / "t.jsonl"
    report = serve_cnn.main([
        "--net", "squeezenet", "--scale", "0.08", "--input-hw", "64",
        "--requests", "12", "--replicas", "2", "--device", "cpu",
        "--metrics-out", str(metrics), "--trace-out", str(trace)])
    out = capsys.readouterr().out
    for banner in ("synthesizing squeezenet", "  stages A-C in ",
                   "served 12/12 requests (0 shed) across 2 replica(s)",
                   "latency ms: p50 ", "batches: ", "cold start (warm-up): r0=",
                   "metrics snapshot:", "serving_cache_stage_d_compiles_total",
                   "synthesis_runs_total"):
        assert banner in out, banner
    assert report.server_stats["failed"] == 0
    assert metrics.exists() and trace.read_text().count("\n") > 0
    with pytest.raises(NotImplementedError, match="item 10"):
        serve_cnn.main(["--device", "cpu", "--artifact-dir", str(tmp_path)])
