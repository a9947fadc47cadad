"""The serving tier's trace: a bucket's host phases under ``serve.dispatch``,
the request and bucket ids that join a request's spans, the device spans
timed by CUDA events on the tracer's clock, and a tier without a tracer,
which records nothing of it.

No JAX here: the ``gpu`` case runs on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serving_trace.py``.
The CPU cases fake the card where they need one: a program that says it is
on ``cuda``, ``Tensor.to`` that keeps the tensor on the CPU, a
``Tensor.pin_memory`` that does nothing, and CUDA events stamped with the
host's clock.
"""
import statistics
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.obs import trace as trace_mod
from repro_torch.serving import ReplicaSet, ServingConfig, SynthesisServer
from repro_torch.serving import server as server_mod

PHASES = ["serve.lookup", "serve.stack", "serve.copy_in", "serve.replay",
          "serve.copy_out", "serve.scatter"]
#: How far a device span may stray outside its host phases on the card: the
#: anchor's bracket and the event's own latency.
SLACK_S = 20e-6


class _Doubler:
    compile_seconds = 0.0
    graph_bytes = 0

    def __call__(self, x):
        return x * 2.0


class FakeProgram:
    """A duck-typed program that doubles its input, on ``device``."""

    def __init__(self, device="cpu", shape=(3,)):
        self.net = SimpleNamespace(name="fakenet", input_shape=shape)
        self.plan = SimpleNamespace(profile=SimpleNamespace(name="fake_dev"))
        self.input_dtype = torch.float32
        self.device = torch.device(device)

    def fingerprint(self):
        return "fake-fp"

    def for_batch(self, batch):
        return _Doubler()


class FakeEvent:
    """A CUDA event stamped with the host's clock when recorded."""
    made = []

    def __init__(self, enable_timing=False):
        self.timing = enable_timing
        self.t = None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _boom(*args, **kwargs):
    raise AssertionError("called on the untraced path")


@pytest.fixture()
def fake_card(monkeypatch):
    """``cuda`` tensors stay on the CPU and pinning is a no-op; events,
    streams and synchronize are the host's."""
    to = torch.Tensor.to

    def to_cpu(self, *args, device=None, dtype=None, **kwargs):
        return to(self, dtype=dtype) if dtype is not None else self

    monkeypatch.setattr(torch.Tensor, "to", to_cpu)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *args, **kwargs: self)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    FakeEvent.made = []


def _children(spans):
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s)
    for kids in by_parent.values():
        kids.sort(key=lambda s: s.t_start)
    return by_parent


def _phases_of(dispatch, by_parent):
    return [s for s in by_parent.get(dispatch.span_id, []) if s.name in PHASES]


@pytest.fixture(scope="module")
def tiny_program():
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import ComputeMode, synthesize
    net = alexnet(scale=0.1, input_hw=67, num_classes=10)
    return synthesize(net, init_network_params(net, 0, "cpu"),
                      forced_mode=ComputeMode.RELAXED)


def test_a_buckets_phases_nest_under_its_dispatch_share_its_id_and_cover_it(tiny_program):
    tracer = obs.Tracer()
    server = SynthesisServer(tiny_program, config=ServingConfig(max_batch=4), tracer=tracer)
    rng = np.random.default_rng(0)
    futures = [server.submit(rng.standard_normal((3, 67, 67), np.float32)) for _ in range(14)]
    assert server.drain() == 14
    assert all(f.result(5.0).shape == (10,) for f in futures)
    spans = tracer.finished()
    by_parent = _children(spans)
    dispatches = [s for s in spans if s.name == "serve.dispatch"]
    assert [d.attrs["batch"] for d in dispatches] == [4, 4, 4, 2]
    waits = {s.attrs["bucket"]: s for s in spans if s.name == "serve.batch_wait"}
    coverage = []
    for d in dispatches:
        phases = _phases_of(d, by_parent)
        assert [p.name for p in phases] == PHASES
        assert d.attrs["bucket"] in waits
        assert all(p.attrs == {"bucket": d.attrs["bucket"]} for p in phases[:1] + phases[2:])
        assert phases[1].attrs == {"bucket": d.attrs["bucket"], "rows": d.attrs["batch"],
                                   "bytes": d.attrs["batch"] * 3 * 67 * 67 * 4, "pinned": 0,
                                   "presubmitted": 0, "runs": 0}
        assert d.t_start <= phases[0].t_start and phases[-1].t_end <= d.t_end
        assert all(a.t_end <= b.t_start for a, b in zip(phases, phases[1:]))
        coverage.append(sum(p.duration_s for p in phases) / d.duration_s)
    # A preemption can fall between two phases; the typical bucket is covered.
    assert statistics.median(coverage) >= 0.95
    # No device spans off the card.
    assert not {s.name for s in spans} & {"dev.copy_in", "dev.replay", "serve.clock_anchor"}


def test_a_failed_bucket_records_its_phases_to_the_one_that_raised():
    tracer = obs.Tracer()
    server = SynthesisServer(FakeProgram(), tracer=tracer,
                             config=ServingConfig(max_batch=4, max_delay_s=60.0))
    server.cache.get_or_build = lambda program, batch: _Raises()
    futures = [server.submit(np.zeros(3, np.float32)) for _ in range(3)]
    server.drain()
    for f in futures:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(5.0)
    spans = tracer.finished()
    (d,) = [s for s in spans if s.name == "serve.dispatch"]
    phases = _phases_of(d, _children(spans))
    assert [p.name for p in phases] == PHASES[:4] and d.attrs["error"] is True
    assert [p.attrs.get("error") for p in phases] == [None, None, None, True]
    assert sum(s.name == "serve.request" for s in spans) == 3


class _Raises:
    def __call__(self, x):
        raise RuntimeError("boom")


def test_request_ids_join_each_request_to_its_buckets_spans():
    tracer = obs.Tracer()
    tier = ReplicaSet(FakeProgram(), tracer=tracer, config=ServingConfig(
        replicas=2, dispatch="work_stealing", max_batch=2, max_delay_s=60.0,
        max_queue_depth=0))
    futures = [tier.submit(np.full(3, float(k), np.float32)) for k in range(9)]
    # Replica 1 empties its own queue (4 requests), then steals 2 of 5.
    assert [tier.pump(replica=1, force=True) for _ in range(3)] == [2, 2, 2]
    assert tier.drain() == 9 - 6
    spans = tracer.finished()
    requests = sorted((s for s in spans if s.name == "serve.request"),
                      key=lambda s: s.attrs["request"])
    assert [s.attrs["request"] for s in requests] == list(range(1, 10))
    released = {s.attrs["bucket"]: s for s in spans
                if s.name in ("serve.batch_wait", "serve.steal")}
    assert any(s.name == "serve.steal" for s in released.values())
    dispatches = {s.attrs["bucket"]: s for s in spans if s.name == "serve.dispatch"}
    assert set(dispatches) == set(released)
    by_parent = _children(spans)
    for k, (req, fut) in enumerate(zip(requests, futures)):
        np.testing.assert_array_equal(fut.result(5.0), np.full(3, 2.0 * k))
        bucket = req.attrs["bucket"]
        d = dispatches[bucket]
        assert req.parent_id is None and req.thread == d.thread
        assert req.t_end == fut.complete_time and req.t_start <= fut.submit_time + 1e-3
        assert d.t_start <= req.t_end <= d.t_end
        assert {p.attrs["bucket"] for p in _phases_of(d, by_parent)} == {bucket}
    for bucket, d in dispatches.items():
        assert sum(r.attrs["bucket"] == bucket for r in requests) == d.attrs["requests"]


def test_without_a_tracer_no_span_event_id_or_clock_read_is_added(fake_card, monkeypatch):
    made = []

    def untimed_event(enable_timing=False):
        # The untraced path's own events: one a slot, which the host waits
        # on for the answers; no timed event.
        assert not enable_timing
        made.append(FakeEvent())
        return made[-1]

    def program_stream(device=None):
        # Asked for only to record a slot's event on the program's card.
        assert device == program.device
        return None

    program = FakeProgram("cuda")
    monkeypatch.setattr(torch.cuda, "Event", untimed_event)
    monkeypatch.setattr(torch.cuda, "synchronize", _boom)
    monkeypatch.setattr(torch.cuda, "current_stream", program_stream)
    monkeypatch.setattr(trace_mod, "Span", _boom)
    reads = []

    def clock():
        reads.append(1)
        return time.perf_counter()

    tier = ReplicaSet(program, registry=obs.MetricsRegistry(clock=clock),
                      config=ServingConfig(max_batch=4, max_delay_s=60.0))
    assert tier.tracer is None
    futures = [tier.submit(np.full(3, float(k), np.float32)) for k in range(10)]
    assert all(r.request_id is None for r in tier.replicas[0].server.batcher._queue)
    reads.clear()
    assert tier.drain() == 10
    # The registry's two reads a bucket (its dispatch seconds), as before.
    assert len(reads) == 2 * 3
    assert [f.result(5.0)[0] for f in futures] == [2.0 * k for k in range(10)]
    assert tier.replicas[0].server._dev is server_mod._UNSET
    assert len(made) == server_mod.SLOTS


def test_device_spans_sit_inside_their_host_phases_on_the_tracers_clock(fake_card, monkeypatch):
    monkeypatch.setattr(server_mod, "ANCHOR_PERIOD_S", 0.0)     # anchor every bucket
    tracer = obs.Tracer()
    server = SynthesisServer(FakeProgram("cuda"), tracer=tracer,
                             config=ServingConfig(max_batch=2, max_delay_s=60.0))
    for k in range(7):
        server.submit(np.full(3, float(k), np.float32))
    assert server.drain() == 7
    spans = tracer.finished()
    # Four anchor events, and for each of the two slots three timed events
    # and the untimed one the answers wait on, made once and recorded again.
    assert len(FakeEvent.made) == 4 + 2 * 3 + 2
    assert sum(not e.timing for e in FakeEvent.made) == 2
    anchors = [s for s in spans if s.name == "serve.clock_anchor"]
    assert len(anchors) == 4 and anchors[0].parent_id is None
    assert "drift_us" not in anchors[0].attrs
    for a in anchors[1:]:
        assert abs(a.attrs["drift_us"]) < 50 and abs(a.attrs["drift_first_us"]) < 50
        assert a.attrs["since_first_s"] > 0 and a.attrs["error_us"] >= 0
    by_parent = _children(spans)
    for d in (s for s in spans if s.name == "serve.dispatch"):
        host = {p.name: p for p in _phases_of(d, by_parent)}
        dev = {s.name: s for s in by_parent[d.span_id] if s.name.startswith("dev.")}
        assert set(dev) == {"dev.copy_in", "dev.replay"}
        assert all(s.attrs == {"bucket": d.attrs["bucket"]} for s in dev.values())
        assert dev["dev.copy_in"].t_start >= host["serve.copy_in"].t_start - SLACK_S
        assert dev["dev.copy_in"].t_end == dev["dev.replay"].t_start
        assert dev["dev.replay"].t_end <= host["serve.copy_out"].t_end + SLACK_S


def test_tracer_records_many_spans_under_one_lock_and_gives_ids_without_it():
    tracer = obs.Tracer()
    acquired = []

    class CountingLock:
        def __init__(self):
            self._lock = threading.Lock()

        def __enter__(self):
            acquired.append(1)
            return self._lock.__enter__()

        def __exit__(self, *exc):
            return self._lock.__exit__(*exc)

    tracer._lock = CountingLock()
    with tracer.span("outer") as outer:
        tracer.new_id("bucket")
        tracer.record_spans([("a", 1.0, 2.0, outer, {"k": 1}), ("b", 1.5, 2.5, None, {})])
    assert len(acquired) == 2           # the two records, then the span's close
    a, b, o = tracer.finished()
    assert (a.parent_id, b.parent_id, a.attrs) == (o.span_id, None, {"k": 1})
    assert [a.span_id, b.span_id, o.span_id] == [2, 3, 1]
    assert [tracer.new_id("bucket"), tracer.new_id("request")] == [2, 1]


def test_a_held_span_nests_its_block_and_is_recorded_with_its_records():
    tracer = obs.Tracer()
    with tracer.held("outer", k=1) as outer:
        assert tracer.open_spans() == [outer]
        with tracer.span("inner"):
            pass
    # Off the stack at the block's end, and not recorded yet.
    assert tracer.open_spans() == [] and [s.name for s in tracer.finished()] == ["inner"]
    with tracer.span("next"):
        pass
    outer.t_end = outer.t_start + 1.0
    tracer.record_spans([("child", outer.t_start, outer.t_end, outer, {}), outer])
    inner, nxt, child, held = tracer.finished()
    assert held is outer and held.attrs == {"k": 1} and held.parent_id is None
    assert inner.parent_id == child.parent_id == outer.span_id and nxt.parent_id is None
    with pytest.raises(RuntimeError):
        with tracer.held("failed") as failed:
            raise RuntimeError("boom")
    assert failed.attrs["error"] is True and tracer.open_spans() == []
    assert obs.Tracer(enabled=False).held("x").__enter__() is None


def test_ids_stay_unique_under_many_threads():
    tracer = obs.Tracer()
    n_threads, n = 32, 200

    def work():
        for _ in range(n):
            tracer.new_id("request")
            with tracer.span("s") as s:
                tracer.record_spans([("r", 0.0, 1.0, s, {})])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    ids = [s.span_id for s in tracer.finished()]
    assert len(ids) == len(set(ids)) == 2 * n_threads * n
    assert tracer.new_id("request") == n_threads * n + 1


@pytest.mark.gpu
def test_device_spans_nest_in_their_host_phases_on_the_card():
    """Full-width AlexNet served by a traced tier for 3 s, so that the
    device clock is anchored again: each ``dev.copy_in`` starts no earlier
    than 20 us before its ``serve.copy_in``, each ``dev.replay`` ends no
    later than 20 us after its ``serve.copy_out``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device spans come from CUDA events")
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import ComputeMode, PlannerConfig, synthesize
    from repro_torch.serving import warm_replicas

    net = alexnet()
    program = synthesize(net, init_network_params(net, 0, "cuda"), device="h100",
                         planner_config=PlannerConfig(batch=8),
                         forced_mode=ComputeMode.RELAXED)
    tracer = obs.Tracer()
    tier = ReplicaSet(program, tracer=tracer, config=ServingConfig(max_batch=8))
    warm_replicas(tier)
    images = np.random.default_rng(0).standard_normal((16, 3, 227, 227), np.float32)
    stop = time.perf_counter() + 3.0

    def client(i):
        while time.perf_counter() < stop:
            tier.submit(images[i % 16]).result(30.0)

    with tier:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(60.0)
    assert not any(c.is_alive() for c in clients)
    spans = tracer.finished()
    by_parent = _children(spans)
    dispatches = [s for s in spans if s.name == "serve.dispatch"]
    assert len(dispatches) > 100
    for d in dispatches:
        kids = {s.name: s for s in by_parent[d.span_id]}
        assert kids["dev.copy_in"].t_start >= kids["serve.copy_in"].t_start - SLACK_S
        assert kids["dev.replay"].t_end <= kids["serve.copy_out"].t_end + SLACK_S
        assert 0 < kids["dev.replay"].duration_s < kids["serve.copy_out"].t_end - d.t_start
    anchors = [s for s in spans if s.name == "serve.clock_anchor"]
    assert len(anchors) >= 3 and all(a.attrs["error_us"] < 1e3 for a in anchors)
