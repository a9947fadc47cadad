"""Two buckets in flight: a dispatch is ``launch`` (lookup, stage, copy in,
replay and, on the card, the copy of the answers back and an event after it)
and ``finish`` (a wait on that event alone, the widen, the scatter), and a
serving loop on the card launches bucket k+1 before it finishes bucket k,
unless bucket k's answers have already landed.

The CPU cases drive two buckets in flight by hand, and the one serving loop,
``SynthesisServer.serve``, with a scripted ``take``, on the CPU and on a faked
card (``fake_card`` of tests/test_torch_serving_staging.py: ``Tensor.to``
keeps the tensor on the CPU, pinning does nothing, CUDA events count their
waits and the stream may not be waited for).  No JAX here: the ``gpu`` case
runs on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serving_pipeline.py``.
"""
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.serving import ReplicaSet, ServingConfig, SynthesisServer
from repro_torch.serving.server import PHASES

from test_torch_serving_staging import (FakeEvent, FakeProgram, _expected,  # noqa: F401
                                        fake_card, tiny_program)

#: How far a device span may stray outside its host phases on the card.
SLACK_S = 20e-6


class OnCard:
    """A program that says it is on ``cuda`` and otherwise is ``program``."""

    def __init__(self, program):
        self._program = program
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._program, name)


class Halver(FakeProgram):
    """A fake program on ``device`` whose bucket program halves its input
    into ``dtype``, or raises once where ``fail_next`` is set."""

    def __init__(self, device="cpu", dtype=torch.float32):
        super().__init__(device)
        self.dtype = dtype

    def for_batch(self, batch):
        program = self

        class Half:
            compile_seconds = 0.0
            graph_bytes = 0

            def __call__(self, x):
                if program.fail_next:
                    program.fail_next = False
                    raise RuntimeError("boom")
                return (x * 0.5).to(program.dtype)

        return Half()


def _bucket(server, images):
    """A released bucket of ``images``, taken by force from the server's
    own batcher."""
    futures = [server.submit(im) for im in images]
    bucket = server.batcher.take(force=True)
    assert [r.future for r in bucket.requests] == futures
    return bucket


def _scripted(buckets, stopping):
    """A ``take`` for ``SynthesisServer.serve`` that hands out ``buckets`` in
    turn, then sets ``stopping`` and returns None."""
    queue = list(buckets)

    def take():
        if queue:
            return queue.pop(0)
        stopping.set()
        return None

    return take


def _serve(server, take, stopping):
    """Run ``server.serve(take, stopping)`` on a thread of its own to its end."""
    loop = threading.Thread(target=server.serve, args=(take, stopping))
    loop.start()
    loop.join(10.0)
    assert not loop.is_alive()


def _idle(server):
    return all(s.flight is None for s in server._slots)


def _server(program, **kwargs):
    config = ServingConfig(max_batch=8, max_delay_s=60.0)
    return SynthesisServer(program, config=config, **kwargs)


@pytest.mark.parametrize("card", [False, True])
def test_two_buckets_in_flight_answer_as_np_stack_bit_for_bit(request, tiny_program, card):
    """Off the card the scaled AlexNet's ``BatchProgram``; on the faked card
    a program that doubles its input and keeps it (a real program cannot run
    where ``Tensor.to`` is faked)."""
    program = tiny_program
    if card:
        request.getfixturevalue("fake_card")
        program = FakeProgram("cuda")
    server = _server(program)
    rng = np.random.default_rng(3)
    batches = [rng.standard_normal((n, *program.net.input_shape), np.float32)
               for n in (8, 3, 5, 1)]
    buckets = []

    def launch(images):
        buckets.append(_bucket(server, list(images)))
        return server.launch(buckets[-1])

    # A in flight, B launched behind it; A finished; C behind B; and so on.
    flights = [launch(batches[0])]
    for images in batches[1:]:
        flights.append(launch(images))
        server.finish(flights[-2])
    server.finish(flights[-1])
    assert [f.slot.index for f in flights] == [0, 1, 0, 1]
    if card:
        # Each bucket's rows of its slot: the images, then zeros, whatever
        # the larger bucket before it in that slot left there.
        for x, images in zip(program.inputs, batches):
            np.testing.assert_array_equal(x[:len(images)].numpy(), images)
            assert not x[len(images):].any()
    for images, bucket in zip(batches, buckets):
        want = _expected(program, server.cache, bucket.batch, list(images))
        for i, req in enumerate(bucket.requests):
            np.testing.assert_array_equal(req.future.result(5.0), want[i])
    assert server.stats.completed == sum(len(b) for b in batches)
    assert server.stats.bucket_counts == {8: 2, 4: 1, 1: 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_answer_is_unchanged_after_later_buckets_reuse_both_slots(fake_card, dtype):
    program = Halver("cuda", dtype)
    server = _server(program)
    first = _bucket(server, [np.full(3, 2.0 + k, np.float32) for k in range(4)])
    server.finish(server.launch(first))
    answers = [r.future.result(5.0) for r in first.requests]
    kept = [a.copy() for a in answers]
    # Two later buckets in flight at once: one in each slot's staging and
    # answer buffers, the first one's slot among them.
    second = server.launch(_bucket(server, [np.full(3, 100.0, np.float32)] * 8))
    third = server.launch(_bucket(server, [np.full(3, -50.0, np.float32)] * 8))
    with pytest.raises(RuntimeError, match="in flight"):
        server.launch(_bucket(server, [np.zeros(3, np.float32)]))
    server.finish(second)
    server.finish(third)
    assert {second.slot.index, third.slot.index} == {0, 1}
    # Every image went through a row of the ring, none through a staging buffer.
    assert all(slot.staging is None for slot in server._slots)
    for got, want in zip(answers, kept):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
        assert not np.shares_memory(got, server._ring.views)
        for slot in server._slots:
            assert not np.shares_memory(got, slot.answers.view(torch.uint8).numpy())
    assert [a[0] for a in answers] == [1.0, 1.5, 2.0, 2.5]
    # Each finish waited on its own slot's event, never on the stream.
    assert len(fake_card) == 3


@pytest.mark.parametrize("card", [False, True])
def test_a_launch_that_raises_fails_only_its_own_futures(request, card):
    waits = request.getfixturevalue("fake_card") if card else None
    program = Halver("cuda" if card else "cpu")
    server = _server(program)
    served = _bucket(server, [np.full(3, 4.0, np.float32)] * 2)
    in_flight = server.launch(served)
    program.fail_next = True
    failed = _bucket(server, [np.full(3, 8.0, np.float32)] * 3)
    raised = server.launch(failed)
    assert isinstance(raised.error, RuntimeError)
    server.finish(in_flight)
    assert [r.future.result(5.0).tolist() for r in served.requests] == [[2.0] * 3] * 2
    assert not any(r.future.done() for r in failed.requests)
    server.finish(raised)
    for r in failed.requests:
        with pytest.raises(RuntimeError, match="boom"):
            r.future.result(5.0)
    assert (server.stats.completed, server.stats.failed) == (2, 3)
    # The failed bucket's finish waited for its copy in before its rows went
    # back; each of the next two buckets waits for its own slot's event.
    again = [_bucket(server, [np.full(3, 6.0 * k, np.float32)]) for k in (1, 2)]
    for bucket in again:
        server.dispatch_bucket(bucket)
    assert [b.requests[0].future.result(5.0)[0] for b in again] == [3.0, 6.0]
    if waits is not None:
        first, second = (slot.done for slot in server._slots)
        assert waits == [first, second, first, second]
        assert server._ring.free == len(server._ring.buffer)


@pytest.mark.parametrize("device", ["cuda:0", "cuda:1"])
def test_each_slot_event_is_recorded_on_the_programs_device(fake_card, device):
    """A replica on another card than the thread's current one: the slot's
    event follows the bucket's copies onto that card's stream, after a
    replay and after a launch that raised, so that a finish or a staging
    waits for this card's work and not for another card's."""
    program = Halver(device)
    server = _server(program)
    served = server.launch(_bucket(server, [np.full(3, 2.0, np.float32)] * 3))
    program.fail_next = True
    failed = server.launch(_bucket(server, [np.full(3, 4.0, np.float32)]))
    mine = torch.cuda.current_stream(torch.device(device))
    assert mine is not torch.cuda.current_stream()
    assert served.slot.done.stream is mine and failed.slot.done.stream is mine
    server.finish(served)
    server.finish(failed)
    assert [r.future.result(0).tolist() for r in served.bucket.requests] == [[1.0] * 3] * 3
    assert fake_card == [served.slot.done, failed.slot.done]


@pytest.mark.parametrize("landed", [False, True])
def test_a_bucket_whose_answers_landed_is_finished_before_the_next_launch(
        fake_card, monkeypatch, landed):
    """In the serving loop the bucket in flight is finished behind the next
    launch only while its event is pending: one whose answers have landed
    is answered first, and the next bucket is launched behind nothing.  A
    finished bucket, its answer rows with it, is freed before the next
    launch or take (where it is freed moves the clients' turn on the
    interpreter)."""
    monkeypatch.setattr(FakeEvent, "landed", landed)
    tracer = obs.Tracer()
    server = _server(Halver("cuda"), tracer=tracer)
    server._dev = None            # no timed events here
    log, finished, alive = [], [], []

    def count_alive():
        alive.append(sum(r() is not None for r in finished))

    for name in ("launch", "finish"):
        def logged(arg, _inner=getattr(server, name), _name=name):
            log.append(_name)
            if _name == "finish":
                finished.append(weakref.ref(arg))
            else:
                count_alive()
            return _inner(arg)
        setattr(server, name, logged)
    buckets = [_bucket(server, [np.full(3, float(k), np.float32)] * 2) for k in range(3)]
    stopping = threading.Event()
    scripted = _scripted(buckets, stopping)

    def take():
        count_alive()
        return scripted()

    _serve(server, take, stopping)
    assert alive == [0] * 7
    if landed:
        assert log == ["launch", "finish"] * 3
    else:
        assert log == ["launch", "launch", "finish", "launch", "finish", "finish"]
    assert [b.requests[0].future.result(0)[0] for b in buckets] == [0.0, 0.5, 1.0]
    dispatches = sorted((s for s in tracer.finished() if s.name == "serve.dispatch"),
                        key=lambda s: s.attrs["bucket"])
    assert [d.attrs["overlapped"] for d in dispatches] == ([0, 0, 0] if landed else [0, 1, 1])
    assert _idle(server) and tracer.open_spans() == []


@pytest.mark.parametrize("tier", [False, True])
def test_with_an_empty_queue_the_loop_finishes_a_bucket_before_it_waits(fake_card, tier):
    program = Halver("cuda")
    config = ServingConfig(max_batch=4, max_delay_s=60.0)
    front = ReplicaSet(program, config=config) if tier else SynthesisServer(program, config=config)
    server = front.replicas[0].server if tier else front
    log = []
    for name in ("launch", "finish"):
        def logged(arg, _inner=getattr(server, name), _name=name):
            log.append(_name)
            return _inner(arg)
        setattr(server, name, logged)
    wait = server.batcher.not_empty.wait

    def logged_wait(timeout=None):
        log.append("wait")
        return wait(timeout)

    server.batcher.not_empty.wait = logged_wait
    # A full bucket, queued before the loop starts, flushes at its first
    # take; with a 60 s deadline nothing but the loop's own finish can answer
    # it while the loop runs.
    futures = [front.submit(np.full(3, float(k), np.float32)) for k in range(4)]
    with front:
        assert [f.result(5.0)[0] for f in futures] == [0.0, 0.5, 1.0, 1.5]
        deadline = time.perf_counter() + 5.0
        while "wait" not in log and time.perf_counter() < deadline:
            time.sleep(0.001)
        assert log[:3] == ["launch", "finish", "wait"]
        assert _idle(server)
    assert _idle(server)


@pytest.mark.parametrize("drain", [True, False])
def test_stop_leaves_no_launched_future_unanswered(fake_card, monkeypatch, drain):
    program = Halver("cuda")
    tier = ReplicaSet(program, config=ServingConfig(max_batch=4, max_delay_s=0.0005,
                                                    max_queue_depth=0))
    launched, lock = [], threading.Lock()
    launch = SynthesisServer.launch

    def logged(self, bucket):
        with lock:
            launched.append(bucket)
        return launch(self, bucket)

    monkeypatch.setattr(SynthesisServer, "launch", logged)
    tier.start()
    futures = [tier.submit(np.full(3, float(k), np.float32)) for k in range(203)]
    # Stop while the loop is busy: after its first launch, however late the
    # thread gets going on a loaded host.
    deadline = time.perf_counter() + 10.0
    while not launched and time.perf_counter() < deadline:
        time.sleep(0.0005)
    tier.stop(drain=drain)
    assert launched
    done = [r.future for b in launched for r in b.requests]
    assert all(f.done() for f in done)
    if drain:
        assert len(done) == len(futures)
        assert [f.result(0)[0] for f in futures] == [0.5 * k for k in range(203)]
    assert _idle(tier.replicas[0].server)


def test_pipelined_replicas_with_stealing_answer_every_client_under_stress(fake_card):
    """Two pipelined replicas on the faked card, stealing from each other,
    under 16 client threads and a switch interval of 10 us: every answer is
    its own image halved, and nothing is left in flight."""
    tier = ReplicaSet(Halver("cuda"), tracer=obs.Tracer(), config=ServingConfig(
        replicas=2, dispatch="work_stealing", max_batch=4, max_delay_s=0.0005,
        max_queue_depth=0))
    for r in tier.replicas:
        r.server._dev = None      # no timed events here
    wrong, served = [], []

    def client(k):
        for i in range(60):
            v = float(1000 * k + i)
            got = tier.submit(np.full(3, v, np.float32)).result(30.0)
            if got.tolist() != [0.5 * v] * 3:
                wrong.append((v, got))
            served.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with tier:
            clients = [threading.Thread(target=client, args=(k,)) for k in range(16)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(c.is_alive() for c in clients)
    assert not wrong and len(served) == 16 * 60
    assert all(_idle(r.server) for r in tier.replicas)
    flags = [s.attrs["overlapped"] for s in tier.tracer.finished() if s.name == "serve.dispatch"]
    assert len(flags) == sum(r.server.stats.batches for r in tier.replicas) and any(flags)
    assert tier.tracer.open_spans() == []


def test_dispatch_spans_carry_overlapped_and_leave_no_span_open(fake_card):
    tracer = obs.Tracer()
    server = _server(Halver("cuda"), tracer=tracer)
    server._dev = None            # no timed events here: the spans' shape only
    buckets = [_bucket(server, [np.full(3, float(k), np.float32)] * 5) for k in range(3)]
    stopping, seen = threading.Event(), []
    scripted = _scripted(buckets, stopping)

    def take():
        # Before each take, no span is open, and after the first launch one
        # bucket is in flight.
        seen.append((tracer.open_spans(), sum(s.flight is not None for s in server._slots)))
        return scripted()

    _serve(server, take, stopping)
    assert seen == [([], 0), ([], 1), ([], 1), ([], 1)]
    assert tracer.open_spans() == [] and _idle(server)
    # Outside the loop a bucket is finished at once.
    server.dispatch_bucket(_bucket(server, [np.zeros(3, np.float32)]))
    assert _idle(server)
    spans = tracer.finished()
    dispatches = sorted((s for s in spans if s.name == "serve.dispatch"),
                        key=lambda s: s.attrs["bucket"])
    assert [d.attrs["overlapped"] for d in dispatches] == [0, 1, 1, 0]
    phases = {}
    for s in spans:
        if s.name in PHASES:
            phases.setdefault(s.parent_id, []).append(s)
    for d in dispatches:
        mine = sorted(phases[d.span_id], key=lambda s: s.t_start)
        assert [p.name for p in mine] == list(PHASES)
        assert all(p.attrs["bucket"] == d.attrs["bucket"] for p in mine)
        assert d.t_start <= mine[0].t_start and mine[-1].t_end <= d.t_end
    # The next bucket's launch lies inside the bucket in flight's dispatch,
    # between its replay and its copy out.
    for a, b in zip(dispatches[:2], dispatches[1:3]):
        a_phases = {p.name: p for p in phases[a.span_id]}
        b_lookup = next(p for p in phases[b.span_id] if p.name == "serve.lookup")
        assert a_phases["serve.replay"].t_end <= b_lookup.t_start
        assert b_lookup.t_end <= a_phases["serve.copy_out"].t_start <= a.t_end


@pytest.mark.parametrize("tier", [False, True])
def test_both_fronts_run_the_one_loop_and_a_dispatch_in_it_is_serial(
        fake_card, monkeypatch, tier):
    """``start()`` of the standalone server and of the replica tier runs
    ``SynthesisServer.serve`` on the front's thread, and ``dispatch_bucket``
    called on that thread, at the running loop's first take, has answered
    its bucket and left nothing in flight when it returns."""
    program = Halver("cuda")
    config = ServingConfig(max_batch=4, max_delay_s=0.001)
    front = ReplicaSet(program, config=config) if tier else SynthesisServer(program, config=config)
    server = front.replicas[0].server if tier else front
    serve, calls, inside = SynthesisServer.serve, [], []

    def recording(self, take, stopping):
        calls.append((self, threading.current_thread().name, stopping))

        def probing():
            if not inside:
                bucket = self.batcher.take(force=True)
                self.dispatch_bucket(bucket)
                inside.append(([r.future.done() for r in bucket.requests], _idle(self)))
            return take()

        return serve(self, probing, stopping)

    monkeypatch.setattr(SynthesisServer, "serve", recording)
    # Queued before the loop starts: the first take's dispatch answers them.
    first = [front.submit(np.full(3, float(k), np.float32)) for k in range(4)]
    with front:
        assert [f.result(5.0)[0] for f in first] == [0.0, 0.5, 1.0, 1.5]
        # The loop itself serves what comes next.
        later = [front.submit(np.full(3, 10.0 + k, np.float32)) for k in range(4)]
        assert [f.result(5.0)[0] for f in later] == [5.0, 5.5, 6.0, 6.5]
    assert calls == [(server, "replica-0" if tier else "synthesis-server", front._stopping)]
    assert inside == [([True] * 4, True)]
    assert _idle(server) and server.stats.batches == 2


@pytest.mark.gpu
def test_on_the_card_the_loop_overlaps_and_answers_as_serial_pumps():
    """Full-width AlexNet under 64 closed-loop client threads for 3 s (the
    benchmark's closed cells' load): some buckets carry ``overlapped`` 1,
    each launched inside the dispatch of the bucket before it, and each
    bucket with 0 is launched after that one's scatter and its replay's
    end; every answer equals a serial ``pump()`` of the same bucket bit for
    bit; each ``dev.copy_in`` starts no earlier than 20 us before its
    ``serve.copy_in``, each ``dev.replay`` ends no later than 20 us after
    its ``serve.copy_out``.  AlexNet's replay is short enough to have
    landed before many launches, so how many overlap depends on the host.
    With two buckets' worth of clients no third bucket is ever queued
    behind the two in flight, so the pipeline would drain after every
    bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pipeline overlaps the device's replay")
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import ComputeMode, PlannerConfig, synthesize
    from repro_torch.serving import warm_replicas

    net = alexnet()
    program = synthesize(net, init_network_params(net, 0, "cuda"), device="h100",
                         planner_config=PlannerConfig(batch=8),
                         forced_mode=ComputeMode.RELAXED)
    tracer = obs.Tracer()
    config = ServingConfig(max_batch=8, max_queue_depth=0)
    tier = ReplicaSet(program, tracer=tracer, config=config)
    warm_replicas(tier)
    images = np.random.default_rng(0).standard_normal((16, 3, 227, 227), np.float32)
    buckets, launch = [], tier.replicas[0].server.launch

    def logged(bucket):
        buckets.append(([r.image for r in bucket.requests], [r.future for r in bucket.requests]))
        return launch(bucket)

    tier.replicas[0].server.launch = logged
    stop = time.perf_counter() + 3.0

    def client(i):
        k = i
        while time.perf_counter() < stop:
            tier.submit(images[k % 16]).result(30.0)
            k += 7

    with tier:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(64)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(60.0)
    assert not any(c.is_alive() for c in clients)
    spans = tracer.finished()
    dispatches = [s for s in spans if s.name == "serve.dispatch"]
    assert len(dispatches) > 100
    assert any(d.attrs["overlapped"] for d in dispatches)
    kids = {}
    for s in spans:
        kids.setdefault(s.parent_id, {})[s.name] = s
    dispatches.sort(key=lambda d: d.t_start)
    for a, b in zip(dispatches, dispatches[1:]):
        if b.attrs["overlapped"]:
            assert b.t_start < a.t_end
        else:
            assert a.t_end <= b.t_start
            assert kids[a.span_id]["dev.replay"].t_end <= b.t_start + SLACK_S
    for d in dispatches:
        k = kids[d.span_id]
        assert k["dev.copy_in"].t_start >= k["serve.copy_in"].t_start - SLACK_S
        assert k["dev.replay"].t_end <= k["serve.copy_out"].t_end + SLACK_S
    serial = SynthesisServer(program, cache=tier.cache, registry=obs.MetricsRegistry(),
                             config=ServingConfig(max_batch=8, max_delay_s=60.0))
    for imgs, futures in buckets:
        again = [serial.submit(im) for im in imgs]
        assert serial.pump(force=True) == len(imgs)
        for f, g in zip(futures, again):
            np.testing.assert_array_equal(f.result(0), g.result(60.0))
