"""Double-buffered host->device sample feed.

The streaming ingest path replacing the reference's circular-buffer feed
from a source thread (SURVEY.md §2b "Circular stream buffers" feeding the
first block; §7 hard part 3 "host->device feed ... needs double-buffered
async transfer").  A background thread encodes + device_puts upcoming
blocks while the executor crunches the current one, hiding transfer
latency; the H2D cost on the GPU is not measured yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import jax
import numpy as np

from ofdm_jax.utils.device_io import maybe_encode

_END = object()


class DeviceFeed:
    """Iterate device-staged blocks from a host block source.

    Usage:
        for dev_block in DeviceFeed(source, depth=3):
            out = executor.push(dev_block)
    """

    def __init__(self, source: Iterable[np.ndarray], depth: int = 3):
        self._src = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        try:
            for block in self._src:
                # blocks may be plain sample arrays OR already-packed pytrees
                # (e.g. runtime.FileStreamer.packed() yields PackedComplex)
                if isinstance(block, (list, np.ndarray)):
                    block = np.asarray(block)
                staged = jax.device_put(maybe_encode(block))
                self._q.put(staged)
        except BaseException as e:  # surface in the consumer thread
            self._err = e
        finally:
            self._q.put(_END)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is _END:
                if self._err is not None:
                    raise self._err
                return
            yield item
