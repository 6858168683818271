"""Headline-bench block-size sweep (JSON artifact).

Same protocol as bench.py (staged blocks, executor push, readback-forced
timing, every-frame-recovered assert) swept over block sizes, to document
how throughput moves with block size: a fixed per-step cost favours large
blocks until the staged-input footprint and step latency stop paying.  The
GPU's curve is not measured yet.

Usage: python -m bench.headline_sweep [logS ...]   (default 22 24 25)
"""

from __future__ import annotations

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from bench.util import Report
from ofdm_jax.config import OfdmConfig, StreamConfig
from ofdm_jax.modem.rx_stream import history_len, rx_stream_block
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import maybe_encode


def measure(logS: int) -> dict:
    from golden import golden_ofdm as G

    frames_per_block = 56 * (1 << max(0, logS - 22))
    K = max(64, 2 * frames_per_block - frames_per_block // 2)
    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")
    spec = cfg.spec
    sc = StreamConfig(block_size=1 << logS, max_frames_per_block=K)
    S = sc.block_size

    rng = np.random.RandomState(0)
    gp = G.GoldenOfdmParams(fft_len=spec.fft_len, cp_len=spec.cp_len,
                            modulation=spec.modulation)
    frame = G.tx_frame(gp, bytes(range(64)) * 2).astype(np.complex64)
    gap = (S - 2 * len(frame)) // frames_per_block
    blocks = (rng.randn(4, S) + 1j * rng.randn(4, S)).astype(
        np.complex64) * 0.02
    for b in range(4):
        for j in range(frames_per_block):
            pos = 100 + j * gap
            blocks[b, pos : pos + len(frame)] += frame
    enc = [jax.device_put(maybe_encode(b)) for b in blocks]
    jax.block_until_ready(enc)

    ex = StreamExecutor(rx_stream_block(spec, sc), S)
    n_timed = 24
    reduce_jit = jax.jit(
        lambda vs: jnp.sum(jnp.stack([v.sum() for v in vs])))

    def trial():
        t0 = time.perf_counter()
        outs = [ex.push(enc[i % len(enc)]).result.valid
                for i in range(n_timed)]
        n_frames = int(jax.device_get(reduce_jit(outs)))
        return time.perf_counter() - t0, n_frames

    trial()
    ex.reset()
    results = [trial() for _ in range(3)]
    dt = min(r[0] for r in results)
    n_frames = results[0][1]
    expect = frames_per_block * n_timed
    tail = -(-history_len(spec) * frames_per_block // S) + 1
    assert expect - tail <= n_frames <= expect, (n_frames, expect)
    return dict(
        kernel=f"headline_2p{logS}", block_size=S, K=K,
        frames=n_frames, expect=expect,
        msamp_s=n_timed * S / dt / 1e6,
    )


def main():
    report = Report("headline_sweep")
    for logS in [int(a) for a in sys.argv[1:]] or [22, 24, 25]:
        report.add(**measure(logS))
    report.save()


if __name__ == "__main__":
    main()
