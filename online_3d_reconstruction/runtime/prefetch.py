"""Host-side frame prefetching — stage pipelining (P5, SURVEY.md §2.3).

The reference reads each frame synchronously inside its main loop; the
online loop must not stall on disk IO / rendering, so a background thread (or the
native C++ loader, io/native_loader.py) loads ``depth`` frames ahead while
the device crunches the current one. With the pipeline's sync-free steady
state, host ingest of frame i+1 overlaps device compute of frame i and map
merge of frame i-1.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class PrefetchIterator:
    """Wrap any frame iterable with an N-deep background prefetch queue."""

    def __init__(self, source: Iterable, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._error = None
        self._thread = threading.Thread(
            target=self._worker, args=(source,), daemon=True
        )
        self._thread.start()

    def _worker(self, source):
        try:
            for item in source:
                self._queue.put(item)
        except BaseException as e:  # surface loader errors on the consumer side
            self._error = e
        finally:
            self._queue.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item


def prefetch(source: Iterable, depth: int = 2) -> Iterable:
    """Convenience: ``for frame in prefetch(dataset, depth=2): ...``"""
    if depth <= 0:
        return source
    return PrefetchIterator(source, depth)


class DevicePrefetchIterator:
    """Prefetch that also PACKS and UPLOADS each frame in the worker thread.

    Raw-frame prefetching still left ``pack_frame`` and the host->device
    upload on the critical path inside ``process``. Here the worker calls ``engine.pack`` and
    ``jax.device_put`` ``depth`` frames ahead, so the steady-state loop
    consumes device-resident buffers and the streamed frame period converges
    to the device-resident one (SURVEY.md P5).

    Yields (frame, packed_device). Frame indices are assigned in iteration
    order starting at ``engine.frame_idx`` — feed every yielded frame to
    ``engine.process(frame, packed=packed)`` exactly once, in order.
    """

    def __init__(self, source: Iterable, engine, depth: int = 2):
        import jax

        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._error = None
        self._engine = engine
        self._start = int(engine.frame_idx)
        self._device_put = jax.device_put
        self._thread = threading.Thread(
            target=self._worker, args=(source,), daemon=True
        )
        self._thread.start()

    def _worker(self, source):
        try:
            for i, frame in enumerate(source):
                packed = self._engine.pack(frame,
                                           frame_index=self._start + i)
                self._queue.put((frame, self._device_put(packed)))
        except BaseException as e:
            self._error = e
        finally:
            self._queue.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item


def device_prefetch(source: Iterable, engine, depth: int = 2) -> Iterable:
    """``for frame, packed in device_prefetch(ds, engine): process(frame,
    packed=packed)`` — pack + upload off the critical path."""
    if depth <= 0:
        return ((f, None) for f in source)
    return DevicePrefetchIterator(source, engine, depth)
