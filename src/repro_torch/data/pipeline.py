"""Host-side double-buffered prefetcher (compute/IO overlap).

Port of `repro.data.pipeline`: `Prefetcher` keeps ``depth`` batches in
flight from a background thread, so the host makes the next batch while
the device runs the current step.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    def __init__(self, iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._src = iterator
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._src:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is StopIteration:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
