"""Fault injection, stall detection, deterministic replay.

The reference has no failure-detection/recovery machinery (SURVEY.md §5);
these tests pin down this build's story: perturbed time-block streams
degrade gracefully (only frames touching the fault are lost), a stalled
pipeline is detected from its progress counter, and the jitted executor is
bit-deterministic under replay (the race-detection answer: there is nothing
to race).
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_jax.config import OfdmConfig, StreamConfig
from ofdm_jax.modem.rx_stream import collect_frames, history_len, rx_stream_block
from ofdm_jax.modem.tx import tx_frames
from ofdm_jax.stream.executor import StreamExecutor, pad_to_blocks
from ofdm_jax.utils.faults import Watchdog, inject_faults

BLOCK = 2048


def _frame_stream(n_frames=4, gap=900):
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    payloads = [f"fault test frame {i}".encode() for i in range(n_frames)]
    cap = cfg.max_payload_bytes - 4
    bufs = np.zeros((n_frames, cap), np.uint8)
    lens = np.zeros(n_frames, np.int32)
    for i, p in enumerate(payloads):
        bufs[i, : len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    frames = tx_frames(spec, jnp.asarray(bufs), jnp.asarray(lens),
                       jnp.arange(n_frames))
    parts = []
    for i in range(n_frames):
        parts.append(np.zeros(gap, np.complex64))
        n = int(frames.n_samples[i])
        parts.append(np.asarray(frames.samples[i][:n]))
    parts.append(np.zeros(BLOCK, np.complex64))
    return cfg, payloads, np.concatenate(parts)


def _rx(cfg, blocks_iter):
    spec = cfg.spec
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=4)
    ex = StreamExecutor(rx_stream_block(spec, sc), BLOCK)
    outs = [ex.push(b) for b in blocks_iter]
    # drain pipeline latency
    for _ in range(-(-ex.block.latency // BLOCK)):
        outs.append(ex.push(np.zeros(BLOCK, np.complex64)))
    jax.block_until_ready(ex.state)
    return collect_frames(outs, block_size=BLOCK, hist=history_len(spec))


def _blocks(stream):
    b, _ = pad_to_blocks(stream, BLOCK)
    return [b[i] for i in range(b.shape[0])]


def test_dropped_block_loses_only_touching_frames():
    cfg, payloads, stream = _frame_stream()
    blocks = _blocks(stream)
    # find which blocks each frame occupies by demodulating cleanly first
    clean = _rx(cfg, blocks)
    assert [f["payload"] for f in clean] == payloads
    victim = clean[1]["abs_start"] // BLOCK  # drop the block holding frame 1
    lo, hi = victim * BLOCK, (victim + 1) * BLOCK
    flen = cfg.spec.max_frame_len
    touching = {
        p for f, p in zip(clean, payloads)
        if f["abs_start"] < hi and f["abs_start"] + flen > lo
    }
    assert payloads[1] in touching and payloads[0] not in touching
    got = _rx(cfg, inject_faults(blocks, drop=[victim]))
    texts = {f["payload"] for f in got if f["crc_ok"]}
    # frames touching the dropped block are lost; every other frame is
    # recovered -- the stream re-synchronizes after the discontinuity
    assert texts == set(payloads) - touching


def test_zeroed_block_equivalent_to_squelch():
    cfg, payloads, stream = _frame_stream()
    blocks = _blocks(stream)
    clean = _rx(cfg, blocks)
    victim = clean[2]["abs_start"] // BLOCK
    lo, hi = victim * BLOCK, (victim + 1) * BLOCK
    flen = cfg.spec.max_frame_len
    touching = {
        p for f, p in zip(clean, payloads)
        if f["abs_start"] < hi and f["abs_start"] + flen > lo
    }
    assert payloads[2] in touching
    got = _rx(cfg, inject_faults(blocks, zero=[victim]))
    texts = {f["payload"] for f in got if f["crc_ok"]}
    assert texts == set(payloads) - touching


def test_duplicated_block_adds_no_corruption():
    """A replayed transfer must not corrupt neighboring frames; the frame
    contained in the duplicated block may legitimately appear twice."""
    cfg, payloads, stream = _frame_stream(gap=1800)
    blocks = _blocks(stream)
    clean = _rx(cfg, blocks)
    victim = clean[1]["abs_start"] // BLOCK
    got = _rx(cfg, inject_faults(blocks, duplicate=[victim]))
    ok = [f["payload"] for f in got if f["crc_ok"]]
    for p in payloads:
        assert p in ok  # every original frame still demodulates


def test_deterministic_replay():
    """Same capture twice through fresh executors => bit-identical raw
    outputs (SURVEY.md §5 race detection: deterministic-replay test mode)."""
    cfg, _, stream = _frame_stream()
    spec = cfg.spec
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=4)

    def run_once():
        ex = StreamExecutor(rx_stream_block(spec, sc), BLOCK, donate=False)
        outs = ex.run(stream, drain=True)
        return jax.tree.map(lambda a: np.asarray(a), outs)

    a, b = run_once(), run_once()
    flat_a, tree_a = jax.tree.flatten(a)
    flat_b, tree_b = jax.tree.flatten(b)
    assert tree_a == tree_b
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x, y)


def test_watchdog_detects_stall_and_recovery():
    counter = {"n": 0}
    stalls = []
    wd = Watchdog(lambda: counter["n"], timeout=0.15,
                  on_stall=lambda: stalls.append(time.monotonic()), poll=0.02)
    with wd:
        for _ in range(5):           # healthy progress
            counter["n"] += 1
            time.sleep(0.05)
        assert not wd.stalled
        time.sleep(0.4)              # stall
        assert wd.stalled and wd.stall_count == 1
        counter["n"] += 1            # recover
        time.sleep(0.1)
        assert not wd.stalled
        time.sleep(0.4)              # stall again -> fires again
    assert wd.stall_count == 2
    assert len(stalls) == 2


def test_watchdog_no_false_positive():
    counter = {"n": 0}
    wd = Watchdog(lambda: counter["n"], timeout=0.5, poll=0.02)
    with wd:
        for _ in range(10):
            counter["n"] += 1
            time.sleep(0.03)
    assert wd.stall_count == 0 and not wd.stalled
