"""Fault injection + stall detection for streaming pipelines.

The reference has NO failure-detection story (SURVEY.md §5 "Failure
detection / elastic recovery: None"; its socket analyzer silently drops UDP
frames).  This build's story, testable on one host:

  * `inject_faults` perturbs a time-block stream (drop / duplicate /
    zero-out blocks) -- the §5 plan's "fault injection = dropping/
    duplicating time-blocks in tests";
  * `Watchdog` detects a stalled pipeline from lack of progress on a
    monotonic counter (the single-host analog of the multi-host heartbeat;
    over pods the same counter feeds shard.distributed.MeshHeartbeat, which
    all-gathers per-process counters so every host watches every other);
  * recovery is checkpoint/resume (stream.checkpoint): executor carries are
    pure pytrees, so a restarted process resumes at the last block boundary.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Iterator


def inject_faults(
    src: Iterable[Any],
    drop: Iterable[int] = (),
    duplicate: Iterable[int] = (),
    zero: Iterable[int] = (),
) -> Iterator[Any]:
    """Perturb a stream of time-blocks by 0-based block index.

    drop      -- block never reaches the consumer (lost transfer);
    duplicate -- block delivered twice (replayed transfer);
    zero      -- block arrives as silence (receiver squelch / DC'd feed).
    """
    drop, duplicate, zero = set(drop), set(duplicate), set(zero)

    def _zero_like(b):
        import jax
        import numpy as np

        return jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), b)

    for i, blk in enumerate(src):
        if i in drop:
            continue
        if i in zero:
            blk = _zero_like(blk)
        yield blk
        if i in duplicate:
            yield blk


class Watchdog:
    """Fires `on_stall` if `progress()` stops advancing for `timeout` s.

    progress() must be cheap, monotonic, and callable from another thread
    (e.g. `lambda: executor.samples_in`).  A fired watchdog keeps watching:
    if progress resumes, `stalled` clears and on_stall can fire again on the
    next stall (elastic-recovery semantics rather than one-shot abort).
    """

    def __init__(
        self,
        progress: Callable[[], float],
        timeout: float,
        on_stall: Callable[[], None] | None = None,
        poll: float | None = None,
    ):
        self.progress = progress
        self.timeout = timeout
        self.on_stall = on_stall
        self.poll = poll if poll is not None else min(0.05, timeout / 4)
        self.stalled = False
        self.stall_count = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self):
        last = self.progress()
        last_t = time.monotonic()
        fired = False
        while not self._stop.wait(self.poll):
            cur = self.progress()
            now = time.monotonic()
            if cur != last:
                last, last_t = cur, now
                self.stalled = False
                fired = False
            elif now - last_t >= self.timeout:
                self.stalled = True
                if not fired:
                    fired = True
                    self.stall_count += 1
                    if self.on_stall is not None:
                        self.on_stall()

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
