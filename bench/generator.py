"""The one traffic generator: it reads a traffic file and drives the tier.

A traffic file (``bench/traffic/<name>.json``) is data:

  {"kind": "closed", "clients": 64}
      N clients, each sending its next image when its last one returned;
      a latency runs from the send to the answer.
  {"kind": "open", "rate_per_s": 1750}
      arrivals on a schedule, whatever the tier does; a latency runs from
      the arrival's due time to the answer, so a late generator or a stall
      counts.

Open arrivals are Poisson-like but the same for every seed: a window of
``n = rate x seconds`` arrivals takes the exponential distribution's n
quantiles as its gaps, scaled to the window's length, in an order drawn from
the seed.  Seeds then differ in order, not in the amount of work.

The generator runs in one thread and does little per request: it takes an
image from the pool, notes the time and calls ``submit``.  With one replica
the tier answers in order, so a closed loop waits on its oldest request
and then refills every slot that has answered.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np


SHED, PENDING, ANSWERED, FAILED = range(4)


class Log:
    """Every request of the window, in flat lists of numbers and arrays.

    A future is dropped once it is answered, and nothing here is a container
    the garbage collector scans, so the benchmark's own records do not grow
    the heap that every full collection of the serving process walks."""

    def __init__(self):
        self.pool_index: List[int] = []
        self.t_ref: List[float] = []       # due time (open) or send time (closed)
        self.t_sent: List[float] = []
        self.t_done: List[float] = []      # the future's complete_time, or nan
        self.state: List[int] = []         # SHED, PENDING, ANSWERED or FAILED
        self.answer: List[Any] = []        # the answer's array, or None

    def __len__(self) -> int:
        return len(self.state)

    def add(self, pool_index: int, t_ref: float, t_sent: float, state: int) -> int:
        self.pool_index.append(pool_index)
        self.t_ref.append(t_ref)
        self.t_sent.append(t_sent)
        self.t_done.append(math.nan)
        self.state.append(state)
        self.answer.append(None)
        return len(self.state) - 1

    def settle(self, k: int, future) -> None:
        """Record an answered future: its result, or that it failed."""
        try:
            self.answer[k] = future.result(0)
            self.state[k] = ANSWERED
        except Exception:
            self.state[k] = FAILED
        self.t_done[k] = future.complete_time


@dataclass
class Traffic:
    kind: str
    clients: int = 0
    rate_per_s: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        kind = d["kind"]
        if kind == "closed":
            if int(d["clients"]) < 1:
                raise ValueError("a closed loop needs at least one client")
            return cls(kind, clients=int(d["clients"]))
        if kind == "open":
            if float(d["rate_per_s"]) <= 0:
                raise ValueError("an open loop needs a positive rate")
            return cls(kind, rate_per_s=float(d["rate_per_s"]))
        raise ValueError(f"unknown traffic kind {kind!r}")


def open_schedule(traffic: Traffic, seconds: float, seed: int) -> np.ndarray:
    """Due offsets (s from the window's start) of every arrival in it."""
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 2])
    n = int(round(traffic.rate_per_s * seconds))
    if not n:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    dues = np.concatenate(([0.0], np.cumsum(gaps)[:-1]))
    return dues[dues < seconds]


def answered(future, timeout: float) -> bool:
    """Wait up to ``timeout`` s for ``future``; whether it has an answer
    (a result or an error)."""
    try:
        future.result(max(0.0, timeout))
    except Exception:
        pass
    return future.done()


class Generator:
    """Drives ``submit`` from one thread between ``t0`` and ``t0 + seconds``.

    ``log`` records every request sent in the window; ``lateness`` the
    seconds each open arrival was sent after its due time, or each closed
    send after the answer it follows.  Answers still out when the window
    closes are collected by :meth:`finish`.
    """

    def __init__(self, submit, shed_error, traffic: Traffic, images, order,
                 t0: float, seconds: float, seed: int, drain_s: float = 60.0):
        self.submit, self.shed_error = submit, shed_error
        self.traffic, self.images, self.order = traffic, images, order
        self.t0, self.t_end = t0, t0 + seconds
        self.seconds, self.seed, self.drain_s = seconds, seed, drain_s
        self.log = Log()
        self.lateness: List[float] = []
        self.error: Optional[BaseException] = None
        self._pending = collections.deque()          # (index, future), oldest first
        self._thread = threading.Thread(target=self._run, name="bench-generator",
                                        daemon=True)

    def start(self) -> "Generator":
        self._thread.start()
        return self

    def join(self, timeout: float) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def finish(self, deadline: float) -> None:
        """Wait until ``deadline`` (host clock) for every answer still out."""
        while self._pending:
            k, future = self._pending.popleft()
            if answered(future, deadline - time.perf_counter()):
                self.log.settle(k, future)

    def _send(self, due: Optional[float] = None) -> float:
        k = len(self.log)
        idx = int(self.order[k % len(self.order)])
        t = time.perf_counter()
        try:
            future = self.submit(self.images[idx])
        except self.shed_error:
            self.log.add(idx, t if due is None else due, t, SHED)
            return t
        self._pending.append((self.log.add(idx, t if due is None else due, t, PENDING),
                              future))
        return t

    def _harvest(self) -> List[float]:
        """Settle the answered futures at the head; their answer times."""
        done = []
        while self._pending and self._pending[0][1].done():
            k, future = self._pending.popleft()
            self.log.settle(k, future)
            done.append(self.log.t_done[k])
        return done

    def _run(self) -> None:
        try:
            if self.traffic.kind == "closed":
                self._closed()
            else:
                self._open()
        except BaseException as e:       # reported by the harness
            self.error = e

    def _open(self) -> None:
        for due in self.t0 + open_schedule(self.traffic, self.seconds, self.seed):
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.lateness.append(self._send(due) - due)
            self._harvest()

    def _closed(self) -> None:
        wait = self.t0 - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        for _ in range(self.traffic.clients):
            self._send()
        while self._pending:
            if not answered(self._pending[0][1],
                            self.t_end + self.drain_s - time.perf_counter()):
                return                   # never answered: the harness counts it
            for t_done in self._harvest():
                if time.perf_counter() < self.t_end:
                    self.lateness.append(self._send() - t_done)
