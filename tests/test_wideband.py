"""Wideband channelizer -> parallel demods (BASELINE.json config 4)."""

import jax
import numpy as np

from ofdm_jax.config import OfdmConfig, StreamConfig
from ofdm_jax.modem.tx import tx_frames
from ofdm_jax.modem.wideband import collect_wideband_frames, wideband_rx_block
from ofdm_jax.spectrum.channelizer import lowpass_taps
from ofdm_jax.stream.executor import StreamExecutor


def _make_frame(cfg, payload, fnum):
    spec = cfg.spec
    cap = cfg.max_payload_bytes - 4
    buf = np.zeros((1, cap), np.uint8)
    buf[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    fr = jax.jit(lambda p, l, n: tx_frames(spec, p, l, n))(
        buf, np.array([len(payload)], np.int32), np.array([fnum], np.int32)
    )
    n = int(fr.n_samples[0])
    return np.asarray(fr.samples[0][:n], np.complex64)


def _synthesize_wideband(cfg, n_chan, targets, per_chan_len, noise=0.005):
    """Synthesis filterbank: upsample each baseband frame by n_chan with the
    prototype lowpass, shift to its channel center, sum."""
    taps = lowpass_taps(n_chan, taps_per_arm=8)
    wide_len = per_chan_len * n_chan
    wide = np.zeros(wide_len, np.complex64)
    for k, (msg, off) in targets.items():
        f = _make_frame(cfg, msg, k)
        bb = np.zeros(per_chan_len, np.complex64)
        bb[off : off + len(f)] = f
        up = np.zeros(wide_len, np.complex64)
        up[:: n_chan] = bb
        up = np.convolve(up, taps)[:wide_len]
        n = np.arange(wide_len)
        wide += (up * np.exp(2j * np.pi * k * n / n_chan)).astype(np.complex64)
    rng = np.random.RandomState(0)
    wide += (
        (rng.randn(wide_len) + 1j * rng.randn(wide_len)) * noise
    ).astype(np.complex64)
    return wide


def test_wideband_rx_recovers_per_channel_frames():
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    n_chan = 8
    targets = {1: (b"channel one message", 500), 5: (b"channel five message", 1200)}
    wide = _synthesize_wideband(cfg, n_chan, targets, per_chan_len=6000)

    sc = StreamConfig(block_size=n_chan * 1024, max_frames_per_block=4)
    ex = StreamExecutor(wideband_rx_block(spec, n_chan, sc), sc.block_size)
    outs = ex.run(wide, drain=True)
    frames = [
        f for f in collect_wideband_frames(outs, 1024, spec) if f["crc_ok"]
    ]
    got = {(f["channel"], f["payload"]) for f in frames}
    assert got == {(1, b"channel one message"), (5, b"channel five message")}
    by_chan = {f["channel"]: f for f in frames}
    # detected near the embedded offsets (group delay of the two filterbanks
    # adds ~taps_per_arm samples at channel rate)
    assert abs(by_chan[1]["abs_start"] - 500) < 40
    assert abs(by_chan[5]["abs_start"] - 1200) < 40
    assert all(f["evm"] < 0.05 for f in frames)


def test_wideband_block_size_chunking():
    """Same capture in different wideband block sizes -> same decoded set."""
    cfg = OfdmConfig(modulation="bpsk", max_payload_bytes=64)
    spec = cfg.spec
    n_chan = 4
    targets = {2: (b"chunk invariance", 700)}
    wide = _synthesize_wideband(cfg, n_chan, targets, per_chan_len=8000)

    results = []
    for bs in (n_chan * 512, n_chan * 2048):
        sc = StreamConfig(block_size=bs, max_frames_per_block=4)
        ex = StreamExecutor(wideband_rx_block(spec, n_chan, sc), bs)
        outs = ex.run(wide, drain=True)
        frames = [
            f for f in collect_wideband_frames(outs, bs // n_chan, spec)
            if f["crc_ok"]
        ]
        results.append({(f["channel"], f["payload"]) for f in frames})
    assert results[0] == results[1] == {(2, b"chunk invariance")}
