"""The jitted block-streaming executor.

JAX replacement for the reference's thread-per-block scheduler
(SURVEY.md §2b "Thread-per-block scheduler" + §3.1 call stack:
gnuradio-runtime/lib/tpb_thread_body.cc, block_executor.cc, buffer.cc,
unverified paths).  Where GNU Radio runs one OS thread per block with
mmap'd circular buffers and condition-variable back-pressure between every
pair of blocks, this executor:

  * splits the sample stream into fixed-size time-blocks (static shapes),
  * runs the whole flowgraph as ONE jitted function per time-block,
  * threads all cross-block state (history, sync, filter taps, counters)
    through an explicit carry pytree,
  * pipelines across time-blocks with lax.scan on-device (scan_blocks) or a
    Python loop with async dispatch for open-ended streams (StreamExecutor --
    JAX dispatch is async, so step k+1's host work overlaps step k's device
    work, giving the double-buffering of SURVEY.md §7 without threads).

Back-pressure, buffer arithmetic (forecast/consume/produce), and the
single-writer protocol all disappear: they are artifacts of the reference's
mutable shared-memory design.
"""

from __future__ import annotations

import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ofdm_jax.stream.block import Block
from ofdm_jax.utils.device_io import maybe_encode, packed_io


def pad_to_blocks(samples, block_size: int):
    """Pad with zeros to a whole number of blocks; returns (blocks, n_valid).

    Operates in numpy when given host data (the host feed path must not
    create device complex arrays outside a packed_io boundary -- see
    utils.device_io).
    """
    xp = np if isinstance(samples, np.ndarray) else jnp
    n = samples.shape[-1]
    n_blocks = max(1, -(-n // block_size))
    pad = n_blocks * block_size - n
    if pad:
        z = xp.zeros((*samples.shape[:-1], pad), dtype=samples.dtype)
        samples = xp.concatenate([samples, z], axis=-1)
    return xp.reshape(samples, (*samples.shape[:-1], n_blocks, block_size)), n


def scan_blocks(block: Block, state: Any, blocks: jnp.ndarray):
    """Run a Block over stacked time-blocks (n_blocks, block_size) with
    lax.scan.  Returns (final_state, stacked_outputs).  The scan body is the
    single XLA program that replaces the reference's per-block threads."""

    safe = packed_io(block.apply)

    def body(carry, x):
        carry, y = safe(carry, x)
        return carry, y

    xp = np if isinstance(blocks, np.ndarray) else jnp
    stacked = maybe_encode(xp.moveaxis(blocks, -2, 0))
    return jax.lax.scan(body, maybe_encode(state), stacked)


class StreamExecutor:
    """Open-ended streaming driver around a Block.

    Keeps the carry across run() calls (a live flowgraph, cf. top_block
    start/stop semantics), jits the per-time-block step once with donated
    carry (no state copies), and exposes throughput counters (the
    probe_rate / performance-counter equivalent, SURVEY.md §5 Tracing).
    """

    def __init__(self, block: Block, block_size: int, donate: bool = True):
        self.block = block
        self.block_size = block_size
        self.state = maybe_encode(block.init())
        self._step = jax.jit(
            packed_io(block.apply), donate_argnums=(0,) if donate else ()
        )
        self.samples_in = 0
        self.wall_time = 0.0

    def reset(self):
        self.state = maybe_encode(self.block.init())
        self.samples_in = 0
        self.wall_time = 0.0

    def push(self, block_samples) -> Any:
        """Process one time-block (must be exactly block_size samples).
        Outputs are encoded on non-cpu backends (see utils.device_io);
        use to_host/collect helpers to read them."""
        # multi-input flowgraphs take a tuple of streams; every array leaf
        # must carry block_size samples on its last axis (blocks with
        # non-stream inputs, e.g. the PDU-fed TX, opt out via stream_input)
        assert not self.block.stream_input or all(
            leaf.shape[-1] == self.block_size
            for leaf in jax.tree.leaves(block_samples)
        )
        t0 = time.perf_counter()
        self.state, out = self._step(self.state, maybe_encode(block_samples))
        self.samples_in += self.block_size
        self.wall_time += time.perf_counter() - t0
        return out

    def run(self, samples, drain: bool = False) -> list:
        """Feed an arbitrary-length sample array through as consecutive
        time-blocks (zero-padding the tail); returns the per-block outputs.

        Dispatch is async: the Python loop enqueues block k+1 while the
        device still computes block k (double-buffering without threads).

        drain=True flushes the block's pipeline latency with zero blocks
        (so e.g. a frame detected near end-of-stream, whose ownership
        window lags by the history length, still gets reported -- the
        end-of-stream drain the reference scheduler performs on stop) and
        synchronizes.
        """
        blocks, _ = pad_to_blocks(np.asarray(samples), self.block_size)
        outs = [self.push(blocks[..., i, :]) for i in range(blocks.shape[-2])]
        if drain:
            n_flush = -(-self.block.latency // self.block_size)
            z = np.zeros(
                (*blocks.shape[:-2], self.block_size), dtype=blocks.dtype
            )
            outs.extend(self.push(z) for _ in range(n_flush))
            jax.block_until_ready(self.state)
        return outs

    @property
    def samples_per_sec(self) -> float:
        return self.samples_in / self.wall_time if self.wall_time else 0.0
