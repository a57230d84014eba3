"""Background-thread batch prefetching for host-side datasets (port of
dpdist_tpu/data/prefetch.py; numpy and threads only).

The numpy batch assembly of a training epoch (reads, augmentation, label
layout) would otherwise serialise with the device step. PrefetchingLoader
overlaps the two: a daemon thread drains the dataset iterator into a
bounded queue while the trainer consumes it, preserving batch order.
"""

from __future__ import annotations

import queue
import threading

_SENTINEL = object()


class PrefetchingLoader:
    """Wrap a next_batch/has_next_batch/reset dataset with a depth-bounded
    background producer.

    epoch() resets the dataset and yields each batch in order; exceptions
    in the producer are re-raised in the consumer. Abandoning the
    generator mid-epoch (consumer exception, break) stops the producer
    before it touches the dataset again, so a later epoch() cannot race
    two producers on one stateful dataset.
    """

    def __init__(self, dataset, *, augment: bool = False, depth: int = 2):
        self.dataset = dataset
        self.augment = augment
        self.depth = int(depth)
        self._thread = None
        self._stop = None

    def epoch(self):
        if self._thread is not None and self._thread.is_alive():
            # A previous epoch was abandoned: retire its producer before
            # reset() so two threads never share the stateful dataset.
            self._stop.set()
            self._thread.join()
        self.dataset.reset()
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put_polling(item):
            # Every put polls the stop flag, the terminal ones too: a
            # consumer that abandons epoch() at exhaustion leaves the
            # bounded queue full, and a blocking put there would deadlock
            # the next epoch()'s join.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                while not stop.is_set() and self.dataset.has_next_batch():
                    put_polling(self.dataset.next_batch(augment=self.augment))
                put_polling(_SENTINEL)
            except BaseException as e:  # surfaced in the consumer
                put_polling(e)

        t = threading.Thread(target=produce, daemon=True)
        self._thread, self._stop = t, stop
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            t.join()
        finally:
            stop.set()
