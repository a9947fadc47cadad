"""The traffic generator: seeded schedules, due-time latency, closed loops."""
import threading
import time
from collections import deque

import numpy as np
import pytest

from bench.generator import ANSWERED, SHED, Generator, Traffic, open_schedule
from repro_torch.serving import LoadShedError, ServingFuture


def test_open_schedule_is_seeded_and_every_seed_does_the_same_work():
    t = Traffic.from_dict({"kind": "open", "rate_per_s": 1000})
    a, b = open_schedule(t, 2.0, 11), open_schedule(t, 2.0, 11)
    c = open_schedule(t, 2.0, 2 ** 40 + 3)
    np.testing.assert_array_equal(a, b)
    assert len(a) == len(c) == 2000
    assert not np.array_equal(a, c)
    # The same gaps in another order (the last one runs to the window's end).
    gaps_of = lambda s: np.sort(np.append(np.diff(s), 2.0 - s[-1]))
    np.testing.assert_allclose(gaps_of(a), gaps_of(c), rtol=1e-9)
    assert a[0] == 0.0 and a[-1] < 2.0 and np.all(np.diff(a) > 0)
    # Exponential gaps: mean 1 / rate, about as many gaps below the mean as
    # an exponential puts there (1 - 1/e).
    gaps = np.diff(a)
    assert gaps.mean() == pytest.approx(1e-3, rel=0.01)
    assert np.mean(gaps < 1e-3) == pytest.approx(1 - np.exp(-1), abs=0.01)


def test_traffic_files_are_checked():
    assert Traffic.from_dict({"kind": "open", "rate_per_s": 1160}).rate_per_s == 1160.0
    assert Traffic.from_dict({"kind": "closed", "clients": 64}).clients == 64
    for bad in ({"kind": "open", "rate_per_s": 0}, {"kind": "closed", "clients": 0},
                {"kind": "bursty", "rate_per_s": 10}):
        with pytest.raises(ValueError):
            Traffic.from_dict(bad)


class FakeTier:
    """Answers in order, ``service_s`` after each request, from one thread;
    the first ``stall`` submits block for ``stall_s``; sheds past ``depth``."""

    def __init__(self, service_s=0.0005, stall=0, stall_s=0.0, depth=1000):
        self.queue, self.lock = deque(), threading.Condition()
        self.service_s, self.stall, self.stall_s, self.depth = service_s, stall, stall_s, depth
        self.inflight_at_submit, self.stop = [], False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def submit(self, image):
        if self.stall:
            self.stall -= 1
            time.sleep(self.stall_s)
        with self.lock:
            if len(self.queue) >= self.depth:
                raise LoadShedError([len(self.queue)], self.depth)
            f = ServingFuture()
            self.queue.append(f)
            self.inflight_at_submit.append(len(self.queue))
            self.lock.notify()
        return f

    def _serve(self):
        while True:
            with self.lock:
                while not self.queue and not self.stop:
                    self.lock.wait()
                if self.stop:
                    return
            time.sleep(self.service_s)
            with self.lock:
                f = self.queue.popleft()
            f.set_result(np.zeros(1))

    def close(self):
        with self.lock:
            self.stop = True
            self.lock.notify()
        self.thread.join(5)


def _drive(tier, traffic, seconds=0.3, seed=3):
    t0 = time.perf_counter() + 0.01
    g = Generator(tier.submit, LoadShedError, Traffic.from_dict(traffic),
                  np.zeros((4, 1)), np.arange(4), t0, seconds, seed).start()
    assert g.join(10)
    assert g.error is None
    g.finish(time.perf_counter() + 5)
    return g, t0


def test_open_latency_runs_from_the_due_time_and_lateness_is_kept():
    tier = FakeTier(stall=1, stall_s=0.05)
    traffic = {"kind": "open", "rate_per_s": 400}
    g, t0 = _drive(tier, traffic)
    tier.close()
    due = t0 + open_schedule(Traffic.from_dict(traffic), 0.3, 3)
    log = g.log
    assert len(log) == len(due) == 120
    np.testing.assert_allclose(log.t_ref, due)
    assert all(s >= r for s, r in zip(log.t_sent, log.t_ref))
    # The stall at the first submit makes the arrivals behind it late.
    assert max(g.lateness) >= 0.04
    assert g.lateness == pytest.approx([s - r for s, r in zip(log.t_sent, log.t_ref)])
    assert set(log.state) == {ANSWERED}
    assert all(d > r for d, r in zip(log.t_done, log.t_ref))


def test_shed_requests_are_kept_without_a_future():
    tier = FakeTier(service_s=0.01, depth=2)
    g, _ = _drive(tier, {"kind": "open", "rate_per_s": 1000}, seconds=0.1)
    tier.close()
    assert set(g.log.state) == {SHED, ANSWERED}
    assert all(a is None for s, a in zip(g.log.state, g.log.answer) if s == SHED)


def test_closed_loop_keeps_every_client_in_flight():
    tier = FakeTier(service_s=0.0005)
    g, t0 = _drive(tier, {"kind": "closed", "clients": 6})
    tier.close()
    log = g.log
    assert len(log) > 60
    assert max(tier.inflight_at_submit) == 6
    # Refills top the queue up again: most sends find the other five in it.
    assert np.mean(np.array(tier.inflight_at_submit[6:]) >= 5) > 0.8
    assert log.t_ref == log.t_sent and min(log.t_sent) >= t0
    assert set(log.state) == {ANSWERED}
