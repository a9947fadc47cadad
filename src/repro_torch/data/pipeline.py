"""Host-side data pipeline: prefetch on a thread, then placement on the
device.

The port of ``repro.data.pipeline``: a background thread draws items (a
batch of numpy arrays, or a dict, list or tuple of them) from the iterator
while the training loop runs, so host data preparation overlaps the
device's work.  Each array is handed out as a tensor on ``device``: for a
CUDA device it is copied to pinned memory and then to the card with
``non_blocking=True``.

Unlike the reference, an exception raised by the iterator is raised again
from ``__next__`` (the reference's end marker, put in a ``finally``, ends
the iteration as if the data had run out).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..nn.model import tree_map


class DataPipeline:
    def __init__(self, it: Iterator, *, prefetch: int = 2,
                 device: "str | torch.device" = "cuda"):
        self._it = it
        self._device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as exc:     # handed to the consumer, raised there
            self._q.put(exc)
        else:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def _place(self, a: Any) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(item)        # every later call stops too
            raise StopIteration
        if isinstance(item, BaseException):
            self._q.put(item)
            raise item
        return tree_map(self._place, item)
