"""A bucket's way to the program.  On the card each image is written at
submit into a row of the server's pinned ring, and the launch copies the
bucket's rows, one asynchronous copy a run of consecutive rows, into a
device input kept per bucket size, whose padding rows it zeroes there; a
request without a row, and every request off the card, is written at the
launch into one of the server's two staging buffers, used in turn, zeros in
its padding rows off the card.  The answers are the bucket's
``BatchProgram`` on ``np.stack`` of the same images, bit for bit
(tests/test_torch_serving_presubmit.py holds the ring's own cases).

No JAX here: the ``gpu`` case runs on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serving_staging.py``.
The CPU cases that need a card fake one: a program that says it is on
``cuda``, ``Tensor.to`` that keeps the tensor on the CPU, a
``Tensor.pin_memory`` that does nothing, and CUDA events whose waits are
counted.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.serving import ReplicaSet, ServingConfig, SynthesisServer

SHAPE = (3, 67, 67)


@pytest.fixture(scope="module")
def tiny_program():
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import ComputeMode, synthesize
    net = alexnet(scale=0.1, input_hw=67, num_classes=10)
    return synthesize(net, init_network_params(net, 0, "cpu"),
                      forced_mode=ComputeMode.RELAXED)


class FakeProgram:
    """A duck-typed program on ``device`` whose bucket program doubles its
    input and keeps a copy of every input it was given."""

    def __init__(self, device="cpu"):
        self.net = SimpleNamespace(name="fakenet", input_shape=(3,))
        self.plan = SimpleNamespace(profile=SimpleNamespace(name="fake_dev"))
        self.input_dtype = torch.float32
        self.device = torch.device(device)
        self.inputs = []
        self.fail_next = False

    def fingerprint(self):
        return "fake-fp"

    def for_batch(self, batch):
        program = self

        class Doubler:
            compile_seconds = 0.0
            graph_bytes = 0

            def __call__(self, x):
                program.inputs.append(x.clone())
                if program.fail_next:
                    program.fail_next = False
                    raise RuntimeError("boom")
                return x * 2.0

        return Doubler()


class FakeEvent:
    """An untimed CUDA event whose waits go into ``waits``, as the event.
    ``stream`` is the stream it was last recorded on; ``query()`` reads
    ``landed``, False unless a test says the device has caught up."""
    landed = False

    def __init__(self, waits):
        self.waits = waits
        self.stream = None

    def record(self, stream=None):
        self.stream = stream

    def query(self):
        return FakeEvent.landed

    def synchronize(self):
        self.waits.append(self)


@pytest.fixture()
def fake_card(monkeypatch):
    """``cuda`` tensors stay on the CPU, pinning is a no-op; every wait on
    an event is counted in the returned list, each device (and the thread's
    current one, asked for as None) has a stream of its own, and no stream
    may be waited for."""
    to = torch.Tensor.to
    waits, streams = [], {}

    def to_cpu(self, *args, device=None, dtype=None, **kwargs):
        return to(self, dtype=dtype) if dtype is not None else self

    def stream_wait():
        raise AssertionError("the stream was waited for")

    monkeypatch.setattr(torch.Tensor, "to", to_cpu)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *args, **kwargs: self)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing=False: FakeEvent(waits))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: streams.setdefault(
        None if device is None else str(torch.device(device)),
        SimpleNamespace(synchronize=stream_wait)))
    return waits


def _record_buckets(monkeypatch):
    """Every dispatched bucket as ``(batch, images, futures)``, whichever
    server launched it."""
    seen, lock = [], threading.Lock()
    launch = SynthesisServer.launch

    def recording(self, bucket):
        with lock:
            seen.append((bucket.batch, [np.array(r.image) for r in bucket.requests],
                         [r.future for r in bucket.requests]))
        return launch(self, bucket)

    monkeypatch.setattr(SynthesisServer, "launch", recording)
    return seen


def _expected(program, cache, batch, images):
    """The bucket's ``BatchProgram`` on ``np.stack`` of the images, zero-padded."""
    x = np.stack(images)
    x = np.concatenate([x, np.zeros((batch - len(x), *x.shape[1:]), x.dtype)])
    out = cache.get_or_build(program, batch)(torch.from_numpy(x))
    return out.float().numpy() if out.dtype == torch.bfloat16 else out.numpy()


def _assert_bitwise(program, cache, buckets):
    assert buckets
    for batch, images, futures in buckets:
        want = _expected(program, cache, batch, images)
        for i, f in enumerate(futures):
            np.testing.assert_array_equal(f.result(30.0), want[i])


@pytest.mark.parametrize("sizes", [[8, 3, 1, 8], [2, 8, 5, 1, 3]])
def test_buckets_through_one_buffer_answer_as_np_stack_and_pad_with_zeros(
        tiny_program, monkeypatch, sizes):
    from repro_torch.core.synthesizer import BatchProgram
    buckets = _record_buckets(monkeypatch)
    server = SynthesisServer(tiny_program, config=ServingConfig(max_batch=8, max_delay_s=60.0))
    inputs, call = [], BatchProgram.__call__
    monkeypatch.setattr(BatchProgram, "__call__",
                        lambda self, x: inputs.append(x.clone()) or call(self, x))
    rng = np.random.default_rng(len(sizes))
    for n in sizes:
        for _ in range(n):
            server.submit(rng.standard_normal(SHAPE, np.float32))
        assert server.pump(force=True) == n
    assert [b for b, _, _ in buckets] == [1 << (n - 1).bit_length() for n in sizes]
    staging = [slot.staging for slot in server._slots]
    assert len({t.data_ptr() for t in staging}) == 2
    assert all(t.shape == (8, *SHAPE) and not t.is_pinned() for t in staging)
    assert len(inputs) == len(sizes)
    for x, (batch, images, _) in zip(inputs, buckets):
        # The program got the bucket's rows of its slot's buffer: the images,
        # then zeros, whatever an earlier, larger bucket left there.
        assert x.shape == (batch, *SHAPE)
        np.testing.assert_array_equal(x[:len(images)].numpy(), np.stack(images))
        assert not x[len(images):].any()
    _assert_bitwise(tiny_program, server.cache, buckets)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_bucket_that_raises_after_staging_fails_its_futures_and_the_next_is_served(
        request, device):
    waits = request.getfixturevalue("fake_card") if device == "cuda" else None
    program = FakeProgram(device)
    server = SynthesisServer(program, config=ServingConfig(max_batch=4, max_delay_s=60.0))
    program.fail_next = True
    failed = [server.submit(np.full(3, 1.0 + k, np.float32)) for k in range(4)]
    assert server.pump(force=True) == 4
    for f in failed:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(5.0)
    # The failed bucket was staged before it raised.
    np.testing.assert_array_equal(program.inputs[0].numpy()[:, 0], [1.0, 2.0, 3.0, 4.0])
    served = [server.submit(np.full(3, 10.0 + k, np.float32)) for k in range(3)]
    assert server.pump(force=True) == 3
    assert [f.result(5.0)[0] for f in served] == [20.0, 22.0, 24.0]
    assert not program.inputs[1][3].any()
    assert server.stats.failed == 4 and server.stats.completed == 3
    if waits is not None:
        # The failed bucket used slot 0, the next slot 1.  The failed
        # bucket's finish waited on the event its launch recorded after the
        # copy in, before its rows went back to the ring; each later bucket
        # waited on its own slot's event for its answers, and nothing else.
        failed_slot, served_slot = (slot.done for slot in server._slots)
        assert waits == [failed_slot, served_slot]
        more = server.submit(np.zeros(3, np.float32))
        server.pump(force=True)
        assert more.result(5.0).tolist() == [0.0, 0.0, 0.0]
        assert waits == [failed_slot, served_slot, failed_slot]
        assert server._ring.free == len(server._ring.buffer)


@pytest.mark.parametrize("threaded", [False, True])
def test_two_replicas_sharing_one_program_with_stealing_stay_bitwise(
        tiny_program, monkeypatch, threaded):
    buckets = _record_buckets(monkeypatch)
    tier = ReplicaSet(tiny_program, config=ServingConfig(
        replicas=2, dispatch="work_stealing", max_batch=4, max_delay_s=0.001 if threaded else 60.0,
        max_queue_depth=0))
    rng = np.random.default_rng(7)
    images = rng.standard_normal((24, *SHAPE)).astype(np.float32)
    if threaded:
        with tier:
            def client(k):
                for i in range(k, len(images), 4):
                    tier.submit(images[i]).result(30.0)
            clients = [threading.Thread(target=client, args=(k,)) for k in range(4)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(60.0)
        assert not any(c.is_alive() for c in clients)
    else:
        for image in images[:9]:
            tier.submit(image)
        # Replica 1 empties its own queue, then steals from replica 0's.
        served = sum(tier.pump(replica=1, force=True) for _ in range(3))
        assert tier.drain() == 9 - served
        assert sum(r.stolen_requests for r in tier.replicas) > 0
    assert sum(len(imgs) for _, imgs, _ in buckets) == (len(images) if threaded else 9)
    staged = [slot.staging for r in tier.replicas for slot in r.server._slots
              if slot.staging is not None]
    assert len({t.data_ptr() for t in staged}) == len(staged)
    _assert_bitwise(tiny_program, tier.cache, buckets)


@pytest.mark.parametrize("device, pinned", [("cpu", 0), ("cuda", 1)])
def test_the_stack_span_says_whether_the_rows_went_into_pinned_memory(
        request, device, pinned):
    if device == "cuda":
        request.getfixturevalue("fake_card")
    tracer = obs.Tracer()
    server = SynthesisServer(FakeProgram(device), tracer=tracer,
                             config=ServingConfig(max_batch=4, max_delay_s=60.0))
    if device == "cuda":
        # Only the stack and its attributes are read here, not the events.
        server._dev = None
    for k in range(5):
        server.submit(np.full(3, float(k), np.float32))
    assert server.drain() == 5
    stacks = [s for s in tracer.finished() if s.name == "serve.stack"]
    assert [(s.attrs["rows"], s.attrs["pinned"]) for s in stacks] == [(4, pinned), (1, pinned)]


@pytest.mark.gpu
def test_on_the_card_the_buffer_is_pinned_and_answers_match_the_pageable_path():
    """Full-width AlexNet: the ring's buffer is pinned, every image went
    through it, ``serve.stack`` says so, and the answers at buckets 1, 2, 4
    and 8 equal those of the same ``BatchProgram`` given
    ``torch.from_numpy(np.stack(...)).to(device)``, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned memory and the asynchronous copy")
    from repro_torch.cnn import alexnet, init_network_params
    from repro_torch.core import ComputeMode, PlannerConfig, synthesize

    net = alexnet()
    program = synthesize(net, init_network_params(net, 0, "cuda"), device="h100",
                         planner_config=PlannerConfig(batch=8),
                         forced_mode=ComputeMode.RELAXED)
    tracer = obs.Tracer()
    server = SynthesisServer(program, tracer=tracer,
                             config=ServingConfig(max_batch=8, max_delay_s=60.0))
    rng = np.random.default_rng(0)
    # Full buckets of each size, each copied by one run of ring rows into
    # the device input of its size.
    for batch in (8, 1, 2, 4, 8):
        chunk = rng.standard_normal((batch, 3, 227, 227), np.float32)
        futures = [server.submit(im) for im in chunk]
        assert server.pump(force=True) == batch
        compiled = server.cache.get_or_build(program, batch)
        want = compiled(torch.from_numpy(np.stack(chunk)).to(program.device)).cpu().float()
        for f, w in zip(futures, want.numpy()):
            np.testing.assert_array_equal(f.result(60.0), w)
    ring = server._ring
    assert ring.buffer.is_pinned() and ring.buffer.shape == (64 + 2 * 8, 3, 227, 227)
    assert ring.free == len(ring.buffer)
    assert all(slot.staging is None and slot.answers.is_pinned() for slot in server._slots)
    assert set(server._inputs) == {1, 2, 4, 8}
    assert all(x.device == program.device for x in server._inputs.values())
    stacks = [s for s in tracer.finished() if s.name == "serve.stack"]
    assert [(s.attrs["rows"], s.attrs["presubmitted"], s.attrs["runs"], s.attrs["pinned"])
            for s in stacks] == [(8, 8, 1, 1), (1, 1, 1, 1), (2, 2, 1, 1), (4, 4, 1, 1),
                                 (8, 8, 1, 1)]
