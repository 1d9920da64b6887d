"""Threaded batch prefetch: overlap host-side data assembly with device
compute (the torch-DataLoader-workers role, SURVEY §2.4, at the batch
level — composes with the C++ npy parser underneath, which releases the
GIL during file reads).

A copy of `deepfepe_tpu/data/prefetch.py` (it imports nothing of JAX).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


_SENTINEL = object()


def prefetch_batches(it: Iterable, depth: int = 2) -> Iterator:
    """Wrap a batch iterator with a background producer thread.

    The producer stays `depth` batches ahead; exceptions propagate to the
    consumer at the point of `next()`. The thread is a daemon, so an
    abandoned iterator cannot hang interpreter shutdown.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)

    def produce():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — reraised consumer-side
            q.put(("__prefetch_error__", e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=produce, daemon=True)
    t.start()

    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if (
            isinstance(item, tuple)
            and len(item) == 2
            and item[0] == "__prefetch_error__"
        ):
            raise item[1]
        yield item
