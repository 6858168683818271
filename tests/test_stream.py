"""Streaming executor + utility block tests.

Covers the scheduler replacement (SURVEY.md §2b "Thread-per-block
scheduler"): block-size invariance (results identical regardless of how the
stream is chopped -- the property GNU Radio's scheduler guarantees via
general_work/forecast), frames straddling block boundaries recovered exactly
once, and the utility-block library against numpy references.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_jax.config import OfdmConfig, StreamConfig
from ofdm_jax.modem.rx_stream import collect_frames, history_len, rx_stream_block
from ofdm_jax.modem.tx import tx_frames
from ofdm_jax.ops.channel import channel_model
from ofdm_jax.stream import block as blk
from ofdm_jax.stream.executor import StreamExecutor, pad_to_blocks, scan_blocks


# ---------------------------------------------------------------------------
# Utility blocks vs numpy (per-block qa_* pattern, SURVEY.md §4)
# ---------------------------------------------------------------------------


def _run_chunked(block, x, chunk):
    """Run a Block over x in chunks; concatenate outputs."""
    st = block.init()
    outs = []
    for i in range(0, len(x), chunk):
        st, y = block.apply(st, jnp.asarray(x[i: i + chunk]))
        outs.append(np.asarray(y))
    return np.concatenate(outs)


def test_delay_block():
    x = np.arange(1, 101).astype(np.complex64)
    y = _run_chunked(blk.delay(7), x, 25)
    want = np.concatenate([np.zeros(7), x[:-7]])
    np.testing.assert_allclose(y, want)


def test_moving_average_block_chunk_invariance():
    rng = np.random.RandomState(0)
    x = rng.randn(256).astype(np.float32)
    y1 = _run_chunked(blk.moving_average(16), x, 256)
    y2 = _run_chunked(blk.moving_average(16), x, 32)
    np.testing.assert_allclose(y1, y2, atol=1e-4)
    # matches numpy causal moving sum
    want = np.convolve(x, np.ones(16))[: len(x)]
    np.testing.assert_allclose(y1, want, atol=1e-3)


def test_fir_filter_block_matches_numpy():
    rng = np.random.RandomState(1)
    x = (rng.randn(300) + 1j * rng.randn(300)).astype(np.complex64)
    taps = (rng.randn(33) + 1j * rng.randn(33)).astype(np.complex64)
    y = _run_chunked(blk.fir_filter(taps), x, 50)
    want = np.convolve(x, taps)[: len(x)]
    np.testing.assert_allclose(y, want, atol=1e-3)


def test_fir_decimating():
    rng = np.random.RandomState(2)
    x = (rng.randn(400) + 1j * rng.randn(400)).astype(np.complex64)
    taps = (rng.randn(16)).astype(np.complex64)
    y = _run_chunked(blk.fir_filter(taps, decim=4), x, 100)
    full = np.convolve(x, taps)[: len(x)]
    np.testing.assert_allclose(y, full[::4], atol=1e-3)


def test_single_pole_iir_matches_loop():
    rng = np.random.RandomState(3)
    x = rng.randn(200).astype(np.float32)
    alpha = 0.05
    y = _run_chunked(blk.single_pole_iir(alpha), x, 64)
    want = np.zeros_like(x)
    acc = 0.0
    for i, v in enumerate(x):
        acc = alpha * v + (1 - alpha) * acc
        want[i] = acc
    np.testing.assert_allclose(y, want, atol=1e-4)


def test_freq_xlating_fir_extracts_band():
    # tone at 0.25 fs, mix down to DC, lowpass -> output is ~constant mag
    n = 2048
    x = np.exp(2j * np.pi * 0.25 * np.arange(n)).astype(np.complex64)
    taps = np.asarray(np.hamming(31) / np.hamming(31).sum(), np.float32)
    y = _run_chunked(blk.freq_xlating_fir(taps, 0.25), x, 256)
    tail = y[100:]
    # after mixdown the tone sits at DC: phase ~ constant
    ph = np.angle(tail[1:] * np.conj(tail[:-1]))
    assert np.abs(ph).max() < 1e-2
    assert np.abs(np.abs(tail) - 1.0).max() < 0.05


def test_chain_and_stateless():
    x = np.linspace(0, 1, 64).astype(np.float32)
    c = blk.chain(blk.multiply_const(2.0), blk.add_const(1.0))
    _, y = c.apply(c.init(), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), x * 2 + 1, atol=1e-6)


def test_scan_blocks_equals_loop():
    rng = np.random.RandomState(4)
    x = rng.randn(512).astype(np.float32)
    b = blk.moving_average(8)
    blocks, _ = pad_to_blocks(x, 64)
    _, ys = scan_blocks(b, b.init(), blocks)
    got = np.asarray(ys).reshape(-1)
    want = _run_chunked(b, x, 64)
    np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# Streaming RX (SURVEY.md §7 hard part 1/2: boundary straddling, dedup)
# ---------------------------------------------------------------------------


def _make_stream(cfg, payloads, gaps, seed=0):
    """Concatenate frames with given zero gaps; returns (stream, expected)."""
    spec = cfg.spec
    b = len(payloads)
    cap = cfg.max_payload_bytes - 4
    bufs = np.zeros((b, cap), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, p in enumerate(payloads):
        bufs[i, : len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    frames = tx_frames(spec, jnp.asarray(bufs), jnp.asarray(lens), jnp.arange(b))
    parts = []
    pos = []
    cursor = 0
    for i in range(b):
        g = gaps[i]
        parts.append(np.zeros(g, np.complex64))
        cursor += g
        n = int(frames.n_samples[i])
        parts.append(np.asarray(frames.samples[i][:n]))
        pos.append(cursor)
        cursor += n
    parts.append(np.zeros(400, np.complex64))
    return np.concatenate(parts), pos


@pytest.mark.parametrize("block_size", [1024, 4096])
def test_stream_rx_multi_frame(block_size):
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    payloads = [f"frame number {i} payload data".encode() for i in range(5)]
    # gaps chosen so some frames straddle block boundaries
    gaps = [150, 333, 77, 512, 41]
    stream, pos = _make_stream(cfg, payloads, gaps)

    scfg = StreamConfig(block_size=block_size, max_frames_per_block=8)
    ex = StreamExecutor(rx_stream_block(spec, scfg), block_size)
    outs = ex.run(stream, drain=True)
    frames = collect_frames(outs, block_size=block_size, hist=history_len(spec))

    assert len(frames) == len(payloads)
    for i, f in enumerate(frames):
        assert f["crc_ok"], f
        assert f["payload"] == payloads[i]
        assert f["frame_num"] == i
        # detected start within the CP of sync1 at known position
        assert pos[i] <= f["abs_start"] <= pos[i] + spec.cp_len


def test_stream_rx_block_size_invariance():
    """Chopping the same capture differently must yield identical frames --
    the scheduler-invariance property of the reference runtime."""
    cfg = OfdmConfig(modulation="qam16", max_payload_bytes=64)
    spec = cfg.spec
    payloads = [b"invariance check payload %d" % i for i in range(3)]
    stream, _ = _make_stream(cfg, payloads, [200, 1000, 47])
    rx = channel_model(jax.random.PRNGKey(9), jnp.asarray(stream), snr_db=28,
                       cfo=0.1, fft_len=cfg.fft_len)
    rx = np.asarray(rx)

    results = []
    for bs in (1024, 2048, 8192):
        scfg = StreamConfig(block_size=bs, max_frames_per_block=8)
        ex = StreamExecutor(rx_stream_block(spec, scfg), bs)
        frames = collect_frames(ex.run(rx, drain=True), bs, history_len(spec))
        results.append(
            [(f["payload"], f["frame_num"], f["abs_start"], f["crc_ok"])
             for f in frames]
        )
    # payload/frame_num/crc are chop-invariant; abs_start may differ by a
    # sample or two (the per-block cumsum accumulates different prefixes, so
    # near-tied plateau samples can flip on float noise)
    for res in results[1:]:
        assert len(res) == len(results[0])
        for a, b in zip(results[0], res):
            assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
            assert abs(a[2] - b[2]) <= 2, (a, b)
    assert len(results[0]) == 3
    assert all(r[3] for r in results[0])


def test_stream_rx_frame_straddles_exact_boundary():
    """Place a frame start exactly at a block boundary and just before it."""
    cfg = OfdmConfig(modulation="bpsk", max_payload_bytes=64)
    spec = cfg.spec
    bs = 2048
    for lead in (bs - 1, bs, bs - spec.max_frame_len // 2):
        stream, pos = _make_stream(cfg, [b"boundary frame"], [lead])
        scfg = StreamConfig(block_size=bs, max_frames_per_block=4)
        ex = StreamExecutor(rx_stream_block(spec, scfg), bs)
        frames = collect_frames(ex.run(stream, drain=True))
        assert len(frames) == 1, f"lead={lead}: {frames}"
        assert frames[0]["payload"] == b"boundary frame"
        assert frames[0]["crc_ok"]


def test_history_len_covers_frame():
    cfg = OfdmConfig(max_payload_bytes=256)
    spec = cfg.spec
    assert history_len(spec) >= spec.max_frame_len + spec.fft_len
