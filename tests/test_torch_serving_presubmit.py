"""Images written at submit: on the card each request's image goes, by the
ring's copier that the submitting thread hands it to, into a row of its
server's pinned ring (``SLOTS * max_batch`` rows and one a queued request, up
to ``RING_QUEUE_BUCKETS`` buckets' worth, handed out in admission order),
and a bucket's launch copies its rows to the card, one asynchronous copy a
run of consecutive rows, and zeroes its padding rows there.  The request
keeps the client's image.  A request that got no row (the ring exhausted,
``max_queue_depth`` 0) has its image written by the launch into the slot's
staging buffer.  A row goes back to its ring at its bucket's finish, after
the slot's event and the row's own copy have been waited for.  The answers
are the stack path's, bit for bit.

The CPU cases run on the faked card of tests/test_torch_serving_staging.py.
No JAX here: the ``gpu`` case runs on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serving_presubmit.py``.
"""
import ctypes
import gc
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.serving import LoadShedError, ReplicaSet, ServingConfig, SynthesisServer
from repro_torch.kernels import _build
from repro_torch.serving.rows import RowRing
from repro_torch.serving.server import RING_QUEUE_BUCKETS, SLOTS

from test_torch_serving_staging import FakeProgram, fake_card  # noqa: F401


def _server(program, tracer=None, **config):
    server = SynthesisServer(program, tracer=tracer, config=ServingConfig(
        max_delay_s=60.0, **{"max_batch": 4, **config}))
    server._dev = None            # no timed events here
    return server


def _images(n, seed=0):
    return list(np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32))


def _copiers():
    """The process's threads named ``row-copier``."""
    names = []
    for task in os.listdir("/proc/self/task"):
        try:
            names.append(open(f"/proc/self/task/{task}/comm").read().strip())
        except OSError:       # a thread that ended meanwhile
            pass
    return names.count("row-copier")


def _stacks(tracer):
    return [(s.attrs["rows"], s.attrs["presubmitted"], s.attrs["runs"])
            for s in tracer.finished() if s.name == "serve.stack"]


@pytest.mark.parametrize("sizes", [[4, 4, 4], [4, 3, 1, 2, 4], [2, 3, 4, 1, 3]])
def test_rows_written_at_submit_answer_as_the_stack_path_bit_for_bit(fake_card, sizes):
    """The same buckets through a server with a ring and one without
    (``max_queue_depth`` 0, every image stacked at the launch): the same
    device inputs, padding rows zeroed whatever a fuller bucket of that size
    left there, and the same answers, bit for bit."""
    images = _images(sum(sizes))
    got = []
    for depth in (2, 0):
        program, tracer = FakeProgram("cuda"), obs.Tracer()
        server = _server(program, tracer, max_queue_depth=depth)
        futures, k = [], 0
        for n in sizes:
            futures.append([server.submit(im) for im in images[k:k + n]])
            k += n
            assert server.pump(force=True) == n
        for n, x in zip(sizes, program.inputs):
            assert x.shape == (1 << (n - 1).bit_length(), 3) and not x[n:].any()
        got.append(([x.numpy() for x in program.inputs],
                    [[f.result(5.0) for f in fs] for fs in futures], _stacks(tracer)))
    (inputs, answers, stacks), (inputs0, answers0, stacks0) = got
    for x, x0 in zip(inputs, inputs0):
        np.testing.assert_array_equal(x, x0)
    for fs, fs0 in zip(answers, answers0):
        for a, a0 in zip(fs, fs0):
            np.testing.assert_array_equal(a, a0)
    k = 0
    for n, fs in zip(sizes, answers):
        for i, a in enumerate(fs):
            np.testing.assert_array_equal(a, images[k + i] * 2.0)
        k += n
    batches = [1 << (n - 1).bit_length() for n in sizes]
    # A ring of 2 + 2 * 4 = 10 rows: a bucket whose rows wrap round it is
    # copied in two runs; without a ring every image is stacked at the
    # launch and copied by one run from the staging buffer.
    assert [(b, p) for b, p, _ in stacks] == list(zip(batches, sizes))
    assert all(r in (1, 2) for _, _, r in stacks)
    assert stacks0 == [(b, 0, 1) for b in batches]


def test_a_bucket_whose_rows_wrap_round_the_ring_is_copied_in_two_runs(fake_card):
    program, tracer = FakeProgram("cuda"), obs.Tracer()
    server = _server(program, tracer, max_queue_depth=2)
    ring_rows = 2 + 2 * 4
    images = _images(12, seed=1)
    for k in range(0, 12, 4):
        futures = [server.submit(im) for im in images[k:k + 4]]
        if k == 8:
            assert [r.row[1] for r in server.batcher._queue] == [8, 9, 0, 1]
        assert server.pump(force=True) == 4
        for f, im in zip(futures, images[k:k + 4]):
            np.testing.assert_array_equal(f.result(5.0), im * 2.0)
    assert _stacks(tracer) == [(4, 4, 1), (4, 4, 1), (4, 4, 2)]
    assert len(server._ring.buffer) == ring_rows and server._ring.free == ring_rows
    assert all(slot.staging is None for slot in server._slots)


def test_a_shed_request_and_a_refused_image_keep_no_row(fake_card):
    tier = ReplicaSet(FakeProgram("cuda"), config=ServingConfig(
        max_batch=2, max_delay_s=60.0, max_queue_depth=2))
    server = tier.replicas[0].server
    futures = [tier.submit(im) for im in _images(2)]
    ring = server._ring
    assert len(ring.buffer) == 2 + 2 * 2 and ring.free == 4
    with pytest.raises(LoadShedError):
        tier.submit(np.zeros(3, np.float32))
    assert ring.free == 4 and tier.shed_requests == 1
    tier.pump(force=True)
    with pytest.raises(ValueError, match="shape"):
        tier.submit(np.zeros(4, np.float32))
    assert ring.free == 6 and tier.submitted == 2 and tier.replicas[0].peak_depth == 2
    assert [f.result(5.0).tolist() for f in futures] == [(im * 2.0).tolist() for im in _images(2)]


@pytest.mark.parametrize("depth", [1, 0])
def test_requests_without_a_row_are_stacked_at_the_launch_and_counted(fake_card, depth):
    """``max_queue_depth`` 1 gives a ring of 1 + 2 * 2 = 5 rows, which a
    server that admits everything runs out of; 0 gives none.  A request
    without a row keeps its own image, and ``presubmitted`` counts only the
    rows written at submit."""
    program, tracer = FakeProgram("cuda"), obs.Tracer()
    server = _server(program, tracer, max_batch=2, max_queue_depth=depth)
    images = _images(7, seed=2)
    futures = [server.submit(im) for im in images]
    queued = server.batcher._queue
    assert [r.row is not None for r in queued] == [k < 5 * depth for k in range(7)]
    assert all(r.image is im for r, im in zip(queued, images) if r.row is None)
    assert server.drain() == 7
    for f, im in zip(futures, images):
        np.testing.assert_array_equal(f.result(5.0), im * 2.0)
    if depth:
        # The third bucket: a row, then a stacked image, in two runs.
        assert _stacks(tracer) == [(2, 2, 1), (2, 2, 1), (2, 1, 2), (1, 0, 1)]
        assert server._ring.free == 5
    else:
        assert server._ring is None
        assert _stacks(tracer) == [(2, 0, 1)] * 3 + [(1, 0, 1)]


@pytest.mark.parametrize("threaded", [False, True])
def test_two_replicas_with_stealing_give_each_row_back_to_its_own_ring(
        fake_card, threaded):
    tier = ReplicaSet(FakeProgram("cuda"), config=ServingConfig(
        replicas=2, dispatch="work_stealing", max_batch=4,
        max_delay_s=0.001 if threaded else 60.0, max_queue_depth=16))
    images = _images(24, seed=3)
    sent = []
    if threaded:
        with tier:
            def client(k):
                for i in range(k, len(images), 4):
                    sent.append((i, tier.submit(images[i])))
                    sent[-1][1].result(30.0)
            clients = [threading.Thread(target=client, args=(k,)) for k in range(4)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(60.0)
        assert not any(c.is_alive() for c in clients)
    else:
        sent = [(i, tier.submit(images[i])) for i in range(9)]
        # Replica 1 empties its own queue, then steals from replica 0's: the
        # stolen rows are replica 0's ring's, read by replica 1's launch.
        served = sum(tier.pump(replica=1, force=True) for _ in range(3))
        assert tier.drain() == 9 - served
        assert sum(r.stolen_requests for r in tier.replicas) > 0
    assert len(sent) == (24 if threaded else 9)
    for i, f in sent:
        np.testing.assert_array_equal(f.result(5.0), images[i] * 2.0)
    rings = [r.server._ring for r in tier.replicas]
    assert rings[0] is not rings[1]
    assert all(ring.free == len(ring.buffer) == 16 + 2 * 4 for ring in rings)
    assert sum(r.server.stats.completed for r in tier.replicas) == len(sent)


def test_many_clients_against_two_stealing_replicas_keep_rows_and_bounds(fake_card):
    """16 client threads (more than the cores), each retrying what was shed,
    against two stealing replicas whose queues hold 4, with the interpreter
    switching threads every 10 us: every answer is its own image's (a row
    handed out twice, or read before its copy, would give another's), no
    queue was ever admitted past its bound, and every row is back."""
    tier = ReplicaSet(FakeProgram("cuda"), config=ServingConfig(
        replicas=2, dispatch="work_stealing", max_batch=4, max_delay_s=0.0005,
        max_queue_depth=4))
    images = _images(16 * 12, seed=6)
    wrong, interval = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with tier:
            def client(k):
                for i in range(k, len(images), 16):
                    while True:
                        try:
                            future = tier.submit(images[i])
                            break
                        except LoadShedError:
                            time.sleep(1e-4)
                    if not np.array_equal(future.result(30.0), images[i] * 2.0):
                        wrong.append(i)
            clients = [threading.Thread(target=client, args=(k,)) for k in range(16)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(c.is_alive() for c in clients)
    assert wrong == []
    assert sum(r.server.stats.completed for r in tier.replicas) == len(images)
    assert max(r.peak_depth for r in tier.replicas) <= 4
    assert all(r.server._ring.free == 4 + 2 * 4 for r in tier.replicas)


def test_a_row_is_not_handed_out_again_before_its_buckets_event_was_waited_for(
        fake_card, monkeypatch):
    log = fake_card                # each wait on an event, and now each row given back
    give_back = RowRing.give_back
    monkeypatch.setattr(RowRing, "give_back", lambda self, row: (
        log.append(("row", row)), give_back(self, row))[-1])
    program = FakeProgram("cuda")
    server = _server(program, max_queue_depth=2)          # 10 rows
    images = _images(11, seed=4)
    first = [server.submit(im) for im in images[:4]]
    flight = server.launch(server.batcher.take(force=True))
    # While the first bucket is in flight its rows stay out: the next six
    # requests take the other six rows, and the seventh gets none.
    later = [server.submit(im) for im in images[4:11]]
    assert [r.row[1] if r.row else None for r in server.batcher._queue] == \
        [4, 5, 6, 7, 8, 9, None]
    assert log == []
    server.finish(flight)
    assert log == [flight.slot.done] + [("row", i) for i in range(4)]
    # Given back after the wait, in order: the next claims take them.
    assert [server.claim_row()[1] for _ in range(2)] == [0, 1]
    for f, im in zip(first, images):
        np.testing.assert_array_equal(f.result(5.0), im * 2.0)
    assert not any(f.done() for f in later)


@pytest.mark.parametrize("tier", [False, True])
def test_a_submits_copy_holds_neither_the_batchers_lock_nor_the_admission_lock(
        fake_card, tier):
    """A client blocked in the middle of writing its image into its row:
    meanwhile a take releases the request queued before it, and (in a tier)
    another client's submit is admitted."""
    config = ServingConfig(max_batch=4, max_delay_s=60.0)
    front = ReplicaSet(FakeProgram("cuda"), config=config) if tier else \
        SynthesisServer(FakeProgram("cuda"), config=config)
    server = front.replicas[0].server if tier else front
    entered, release = threading.Event(), threading.Event()

    class SlowImage:
        """Hands out its pixels only once released, when asked for float32."""
        shape = (3,)

        def __array__(self, dtype=None, copy=None):
            if dtype is not None:
                entered.set()
                assert release.wait(10.0)
            return np.full(3, 7.0, dtype or np.float32)

    before = front.submit(np.full(3, 1.0, np.float32))
    slow = []
    writer = threading.Thread(target=lambda: slow.append(front.submit(SlowImage())))
    writer.start()
    try:
        assert entered.wait(10.0)
        bucket = server.batcher.take(force=True)
        assert [r.future for r in bucket.requests] == [before]
        if tier:
            other = front.submit(np.full(3, 2.0, np.float32))
            assert server.batcher.depth == 1
    finally:
        release.set()
        writer.join(10.0)
    assert not writer.is_alive()
    server.dispatch_bucket(bucket)
    assert front.drain() == (2 if tier else 1)
    assert before.result(5.0).tolist() == [2.0] * 3
    assert slow[0].result(5.0).tolist() == [14.0] * 3
    if tier:
        assert other.result(5.0).tolist() == [4.0] * 3


def test_a_request_admitted_and_still_being_written_counts_against_the_bound(fake_card):
    tier = ReplicaSet(FakeProgram("cuda"), config=ServingConfig(
        max_batch=2, max_delay_s=60.0, max_queue_depth=1))
    entered, release = threading.Event(), threading.Event()

    class SlowImage:
        def __array__(self, dtype=None, copy=None):
            if dtype is not None:
                entered.set()
                assert release.wait(10.0)
            return np.full(3, 3.0, dtype or np.float32)

    slow = []
    writer = threading.Thread(target=lambda: slow.append(tier.submit(SlowImage())))
    writer.start()
    try:
        assert entered.wait(10.0)
        assert tier.replicas[0].depth == 0
        with pytest.raises(LoadShedError):
            tier.submit(np.zeros(3, np.float32))
    finally:
        release.set()
        writer.join(10.0)
    assert not writer.is_alive()
    assert tier.drain() == 1 and slow[0].result(5.0).tolist() == [6.0] * 3
    assert tier.shed_requests == 1 and tier.replicas[0].peak_depth == 1


def test_the_ring_copies_on_its_worker_and_joins_it_when_it_goes(fake_card):
    """The copier (built with the host's C++ compiler) is a thread of its
    own: a write only enqueues the copy and ``ready`` waits for it.  A row
    then holds ``np.asarray(image, np.float32)`` of what was written, and
    the ring keeps no source once the row is back."""
    gc.collect()
    threads = _copiers()
    ring = RowRing(5, (2, 3))
    assert _copiers() == threads + 1
    rng = np.random.default_rng(5)
    images = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(3)]
    images += [rng.standard_normal((2, 3)), rng.standard_normal((2, 3)).tolist()]
    claimed = [ring.claim() for _ in images]
    assert claimed == [0, 1, 2, 3, 4] and ring.claim() is None
    for r, im in zip(claimed, images):
        assert ring.write(r, im) is None
    for r, im in zip(claimed, images):
        ring.ready(r)
        np.testing.assert_array_equal(ring.views[r], np.asarray(im, np.float32))
    for r in claimed:
        ring.give_back(r)
    assert ring.free == 5 and ring._sources == [None] * 5
    del ring
    gc.collect()
    assert _copiers() == threads


def test_a_failed_build_of_the_copier_raises(fake_card, monkeypatch):
    """No second copy path: where the copier cannot be built, making the
    ring, and so the first submit on the card, raises."""
    def no_compiler(name):
        raise RuntimeError("no C++ compiler (c++, g++) on PATH")
    monkeypatch.setattr(_build, "load", no_compiler)
    with pytest.raises(RuntimeError, match="compiler"):
        RowRing(2, (3,))
    server = _server(FakeProgram("cuda"), max_queue_depth=2)
    with pytest.raises(RuntimeError, match="compiler"):
        server.submit(np.zeros(3, np.float32))
    assert server.batcher.depth == 0


@pytest.mark.parametrize("depth,rows", [(2, 10), (4 * RING_QUEUE_BUCKETS, 40), (4096, 40)])
def test_the_ring_holds_the_slots_buckets_and_at_most_its_queue_buckets(
        fake_card, depth, rows):
    """``SLOTS * max_batch`` rows and one a request the queue may hold, up to
    ``RING_QUEUE_BUCKETS`` buckets: a deep admission bound pins no more; its
    later requests take the staging path."""
    server = _server(FakeProgram("cuda"), max_queue_depth=depth)
    assert rows == SLOTS * 4 + min(depth, RING_QUEUE_BUCKETS * 4)
    futures = [server.submit(im) for im in _images(rows + 3, seed=8)]
    assert len(server.ring().buffer) == rows
    assert [r.row is not None for r in server.batcher._queue] == \
        [k < rows for k in range(rows + 3)]
    assert server.drain() == rows + 3
    for f, im in zip(futures, _images(rows + 3, seed=8)):
        np.testing.assert_array_equal(f.result(5.0), im * 2.0)
    assert server.ring().free == rows


def test_a_request_keeps_the_clients_image_after_its_row_is_handed_out_again(fake_card):
    """What a launch sees as a request's image is the client's array, not its
    row: once the bucket is finished the row holds a later request's image,
    and the first request's image still reads as it was sent."""
    program = FakeProgram("cuda")
    server = _server(program, max_queue_depth=2)          # 10 rows
    images = _images(12, seed=9)
    seen = []
    launch = server.launch
    server.launch = lambda bucket: (seen.append(bucket.requests), launch(bucket))[-1]
    futures = []
    for k in range(0, 12, 4):
        futures += [server.submit(im) for im in images[k:k + 4]]
        assert server.pump(force=True) == 4
    # The third bucket took rows 8, 9, 0 and 1: the first bucket's rows 0 and 1.
    assert [r.row[1] for r in seen[2]] == [8, 9, 0, 1]
    requests = [r for bucket in seen for r in bucket]
    for r, im, f in zip(requests, images, futures):
        assert r.image is im
        np.testing.assert_array_equal(f.result(5.0), im * 2.0)
    np.testing.assert_array_equal(server.ring().views[0], images[10])


def test_a_launch_that_raises_before_its_rows_are_read_waits_for_their_copies(
        fake_card, monkeypatch):
    """A lookup that raises before the launch reads its rows, while their
    copies are still queued on the copier: the bucket's finish fails its
    futures and waits for each row's copy before the row goes back, so no
    queued copy later writes a row handed out again, or reads a source the
    ring has let go.  The copier here holds its jobs until a wait."""
    program = FakeProgram("cuda")
    server = _server(program, max_queue_depth=2)
    ring = server.ring()
    queued = []

    def enqueue(copier, dst, src, nbytes, flag):
        queued.append((dst, src, nbytes, flag))

    def wait(flag):           # the copier catches up, in order
        while queued:
            dst, src, nbytes, done = queued.pop(0)
            ctypes.memmove(dst, src, nbytes)
            ctypes.c_int32.from_address(done).value = 1

    monkeypatch.setattr(ring, "_enqueue", enqueue)
    monkeypatch.setattr(ring, "_wait", wait)
    images = _images(7, seed=10)
    first = [server.submit(im) for im in images[:3]]
    assert len(queued) == 3 and not ring._written[:3].any()
    lookup = server.cache.get_or_build

    def broken(*args, **kwargs):
        raise RuntimeError("lookup failed")
    monkeypatch.setattr(server.cache, "get_or_build", broken)
    assert server.pump(force=True) == 3
    for f in first:
        with pytest.raises(RuntimeError, match="lookup failed"):
            f.result(5.0)
    assert queued == [] and ring._written.all()
    assert ring._sources == [None] * len(ring.buffer) and ring.free == len(ring.buffer)
    monkeypatch.setattr(server.cache, "get_or_build", lookup)
    later = [server.submit(im) for im in images[3:]]
    assert server.pump(force=True) == 4
    for f, im in zip(later, images[3:]):
        np.testing.assert_array_equal(f.result(5.0), im * 2.0)


@pytest.mark.gpu
def test_on_the_card_rows_written_at_submit_answer_as_the_stacked_path():
    """Full-width AlexNet: buckets of 8, 3, 5, 1 and 8 through a server whose
    ring (4 + 2 * 8 = 20 rows) wraps in the last bucket, and the same images
    through a server without a ring, whose launches stack every image into
    the pinned staging buffer as before: the same answers, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned rows and the asynchronous copies")
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import ComputeMode, PlannerConfig, synthesize

    net = alexnet()
    program = synthesize(net, init_network_params(net, 0, "cuda"), device="h100",
                         planner_config=PlannerConfig(batch=8),
                         forced_mode=ComputeMode.RELAXED)
    sizes = (8, 3, 5, 1, 8)
    images = np.random.default_rng(0).standard_normal((sum(sizes), 3, 227, 227), np.float32)
    answers, stacks = [], []
    cache = None
    for depth in (4, 0):
        tracer = obs.Tracer()
        server = SynthesisServer(program, tracer=tracer, cache=cache,
                                 registry=None if cache is None else obs.MetricsRegistry(),
                                 config=ServingConfig(max_batch=8, max_delay_s=60.0,
                                                      max_queue_depth=depth))
        cache = server.cache
        futures, k = [], 0
        for n in sizes:
            futures += [server.submit(im) for im in images[k:k + n]]
            k += n
            assert server.pump(force=True) == n
        answers.append([f.result(60.0) for f in futures])
        stacks.append([(s.attrs["presubmitted"], s.attrs["runs"], s.attrs["pinned"])
                       for s in tracer.finished() if s.name == "serve.stack"])
    for a, b in zip(*answers):
        np.testing.assert_array_equal(a, b)
    assert stacks[0] == [(8, 1, 1), (3, 1, 1), (5, 1, 1), (1, 1, 1), (8, 2, 1)]
    assert stacks[1] == [(0, 1, 1)] * 5
