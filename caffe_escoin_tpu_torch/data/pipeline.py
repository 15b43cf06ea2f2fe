"""Prefetching data pipeline (port of ``caffe_escoin_tpu/data/pipeline.py``).

Reference: `BasePrefetchingDataLayer`, a background `InternalThread`
filling a bounded queue of batches
(`include/caffe/layers/base_data_layer.hpp:52-78`,
`src/caffe/util/blocking_queue.cpp`). Here a daemon thread runs the numpy
``source`` and ``transform`` into a bounded queue. With a ``device`` the
thread also wraps each array as a tensor, pinned in host memory when the
device is a GPU; the consumer's ``__next__`` then copies it with
``.to(device, non_blocking=True)`` on the consumer's current stream, so the
copy overlaps the work queued before it. The loader thread launches no
device work.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Deque, Dict, Iterator, Optional

import numpy as np
import torch


class PrefetchLoader:
    """Background-thread prefetching iterator over batches.

    ``source()`` -> dict of numpy arrays (one batch); ``transform`` runs on
    the loader thread. ``device`` None yields the numpy dicts; a device
    yields tensors on it. An exception of the thread is raised by the next
    ``__next__``; a finished source ends the iteration. With a
    ``timeout`` (seconds), a ``__next__`` that gets no batch in that time
    raises TimeoutError, so that a stalled source fails its caller instead
    of hanging it. ``waits`` holds the host seconds each of the last
    ``WAITS_KEPT`` ``__next__`` calls waited for its batch (the queue ran
    dry when one is long)."""

    WAITS_KEPT = 4096

    PREFETCH_COUNT = 4  # the reference's per data layer (base_data_layer.hpp)

    def __init__(self, source: Callable[[], Dict[str, np.ndarray]],
                 *, transform: Optional[Callable] = None,
                 prefetch: int = PREFETCH_COUNT,
                 device: Optional[torch.device] = None,
                 timeout: Optional[float] = None):
        self._source = source
        self._timeout = timeout
        self._transform = transform
        self._device = None if device is None else torch.device(device)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.waits: Deque[float] = collections.deque(
            maxlen=self.WAITS_KEPT)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._source()
                if self._transform is not None:
                    batch = self._transform(batch)
                if self._device is not None:
                    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in batch.items()}
                    if self._device.type == "cuda":
                        batch = {k: v.pin_memory() for k, v in batch.items()}
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # raised by the next __next__
            self._error = e

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        t0 = time.perf_counter()
        waited = 0.0
        while True:
            if self._error is not None:
                raise self._error
            try:
                batch = self._queue.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive() and self._error is None:
                    raise StopIteration
                waited += 1.0
                if self._timeout is not None and waited >= self._timeout:
                    raise TimeoutError(f"PrefetchLoader: no batch within "
                                       f"{self._timeout} s")
                continue
            self.waits.append(time.perf_counter() - t0)
            if self._device is None:
                return batch
            return {k: v.to(self._device, non_blocking=True)
                    for k, v in batch.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
