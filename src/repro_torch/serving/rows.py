"""RowRing: the pinned rows a server's clients write their images into.

A server on the card with an admission bound keeps one ring of pinned
float32 images, made when its replicas are warmed or at the first submit:
``SLOTS * max_batch`` rows for the buckets in flight, and a row for each
request the queue may hold, up to ``RING_QUEUE_BUCKETS`` buckets' worth
(:mod:`repro_torch.serving.server`).

A row's life.  ``submit`` claims it (in a ``ReplicaSet`` under the admission
lock, so rows follow admission order) and, outside the batcher's and the
admission locks, asks for the image to be copied into it; the request keeps
the client's image and carries ``(ring, row)``.  The copy runs on the ring's
native worker thread (``kernels/csrc/row_copier.cpp``, built at the first
ring by :mod:`repro_torch.kernels._build` with the host's C++ compiler; a
failed build raises): the submitting thread only enqueues it, holding the
interpreter's lock for that call, so neither the client's thread nor the
tier's spends the interpreter on the copy or hands its lock over for it.
Each row has a flag the worker sets once the row holds the image; the
bucket's launch waits, with the lock released, for any flag of its rows that
is not set yet, then copies the rows to the card.  The row goes back to its
ring (the victim's, for a stolen request) at the bucket's finish, once the
slot's event has been waited for, also where the launch raised; giving it
back first waits for its copy, so a copy still queued never writes a row
handed out again or reads a source already let go.  The ring keeps the
source array until then.  As before, the image is read after ``submit``
returns: a client leaves it unchanged until its answer.  A request with no
row (the ring exhausted, no admission bound, off the card) keeps the staging
path.
"""
from __future__ import annotations

import collections
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import _build


def _stop(free, copier, keep) -> None:
    """Join a ring's worker; ``keep`` holds what it writes and reads until then."""
    free(copier)


class RowRing:
    """A server's pinned rows, one float32 image each, handed out in
    admission order.  A row is claimed at submit, written by :meth:`write`,
    read by its bucket's copy in once :meth:`ready`, and given back at that
    bucket's finish, once the slot's event has been waited for.  Rows given
    back in the order they were claimed keep a FIFO bucket's rows
    consecutive, but for a wrap-around of the ring."""

    def __init__(self, rows: int, shape: Tuple[int, ...]):
        self.buffer = torch.empty((rows, *shape), dtype=torch.float32).pin_memory()
        self.views = self.buffer.numpy()
        self._free = collections.deque(range(rows))
        self._row_bytes = self.views[0].nbytes
        self._base = self.views.ctypes.data
        self._written = np.ones(rows, np.int32)    # the copier's flags
        self._flags = self._written.ctypes.data
        self._sources = [None] * rows              # what a pending copy reads
        lib = _build.load("row_copier")
        self._copier = lib.row_copier_new()
        self._enqueue, self._wait = lib.row_copier_copy, lib.row_copier_wait
        # Freed with the ring: the worker finishes what is queued first, so
        # what it writes and reads is kept until then.  Not at exit, where a
        # daemon thread may still be submitting.
        weakref.finalize(self, _stop, lib.row_copier_free, self._copier,
                         (self.buffer, self._written, self._sources)).atexit = False

    def claim(self) -> Optional[int]:
        """A free row's index, or None where every row is out."""
        try:
            return self._free.popleft()
        except IndexError:
            return None

    def write(self, row: int, image) -> None:
        """Have ``image`` copied into ``row``: the copy is only enqueued here."""
        src = np.ascontiguousarray(image, np.float32)
        self._sources[row] = src
        self._written[row] = 0
        self._enqueue(self._copier, self._base + row * self._row_bytes, src.ctypes.data,
                      self._row_bytes, self._flags + 4 * row)

    def ready(self, row: int) -> None:
        """Return once ``row`` holds its image (the interpreter's lock
        released while the copier catches up)."""
        if not self._written[row]:
            self._wait(self._flags + 4 * row)

    def give_back(self, row: int) -> None:
        """Put ``row`` back among the free rows once its copy has finished."""
        self.ready(row)
        self._sources[row] = None
        self._free.append(row)

    @property
    def free(self) -> int:
        return len(self._free)
