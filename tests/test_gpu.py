"""GPU lane: the compiled detect kernels, the plain paths the GPU runs, and
on-device loopbacks of BASELINE configs 1-4, each against its reference.

Skips unless JAX's backend is a GPU.  chip_smoke.py runs this lane inside
its own process (one JAX process per card); by hand:

    OFDM_JAX_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu -q

Everything else in tests/ runs on the virtual CPU mesh (conftest.py),
where the detect kernels run in the Pallas interpreter.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from golden import golden_ofdm as G
from golden.detect_ref import detect_rows_f64
from ofdm_jax.config import OfdmConfig, StreamConfig
from ofdm_jax.ops import sync

pytestmark = pytest.mark.gpu

BLOCK = 1 << 25                 # the headline block size


@pytest.fixture(scope="module", autouse=True)
def require_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (run chip_smoke.py on the card)")


def _noise(n, seed, amp=0.02):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n) + 1j * rng.randn(n)) * amp).astype(np.complex64)


def _golden(cfg):
    return G.GoldenOfdmParams(fft_len=cfg.fft_len, cp_len=cfg.cp_len,
                              modulation=cfg.modulation)


def _check_rows(got, ref, smf64):
    """smmax rtol 1e-5; argmax equal except near-ties (both picks within
    1e-6 in the float64 metric); P/R picks within 1e-4 of the window's
    energy where the argmaxes agree; rmax rtol 1e-5."""
    live = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), live)
    np.testing.assert_allclose(got[0][live], ref[0][live], rtol=1e-5)
    diff = np.nonzero(got[1] != ref[1])[0]
    a, b = (np.asarray(x[1][diff], np.int64) for x in (got, ref))
    assert (np.abs(smf64[a] - smf64[b]) <= 1e-6).all()
    same = got[1] == ref[1]
    scale = np.maximum(ref[4][same], 1e-30)
    for i in (2, 3, 4):
        assert (np.abs(got[i][same] - ref[i][same]) <= 1e-4 * scale).all(), i
    np.testing.assert_allclose(got[5], ref[5], rtol=1e-5)


@pytest.mark.parametrize("fft_len,cp", [(64, 16), (256, 64)])
def test_detect_kernel_matches_plain_and_float64(fft_len, cp):
    """Detect row summaries at the headline length n = 2^25 + history:
    compiled kernels vs the plain path, and the plain path vs float64
    window sums; then identical selections."""
    from ofdm_jax.kernels.detect import detect_rows
    from ofdm_jax.modem.rx_stream import history_len

    cfg = OfdmConfig(fft_len=fft_len, cp_len=cp, modulation="qpsk")
    spec = cfg.spec
    L = fft_len // 2
    n = BLOCK + history_len(spec)
    x = _noise(n, seed=fft_len)
    frame = G.tx_frame(_golden(cfg), bytes(range(64))).astype(np.complex64)
    cfo = 0.17
    frame = frame * np.exp(2j * np.pi * cfo * np.arange(len(frame))
                           / fft_len).astype(np.complex64)
    starts = np.arange(1000, n - 2 * len(frame),
                       max(n // 300, 3 * len(frame)))
    for p in starts:
        x[p:p + len(frame)] += frame
    re, im = jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy())
    kern = [np.asarray(v) for v in jax.jit(
        lambda a, b: detect_rows(a, b, L, cp))(re, im)]
    plain = [np.asarray(v) for v in jax.jit(
        lambda a, b: sync._detect_rows_jnp(
            spec, (a + 1j * b).astype(jnp.complex64)))(re, im)]
    smf64, f64 = detect_rows_f64(x, L, cp)
    _check_rows(kern, plain, smf64)
    _check_rows(plain, [np.asarray(v, np.float64) for v in f64], smf64)

    n_sm = n - 2 * L - cp + 1
    sel = [sync._select_from_rows(
        spec, *(jnp.asarray(v) for v in rows), n_sm=n_sm,
        max_frames=len(starts) + 16, threshold=cfg.sync_threshold)
        for rows in (kern, plain)]
    (vk, sk, ck), (vp, sp, cp_) = [
        (np.asarray(d.valid), np.asarray(d.start), np.asarray(d.fine_cfo))
        for d in sel]
    np.testing.assert_array_equal(vk, vp)
    assert vk.sum() == len(starts)
    np.testing.assert_array_equal(sk[vk], sp[vp])
    np.testing.assert_allclose(ck[vk], cp_[vp], atol=1e-4)
    np.testing.assert_allclose(ck[vk], cfo, atol=0.02)


def test_slot_gather_exact():
    """K = 480 slot windows of max_frame_len from a 2^25 + history buffer,
    clamped starts included: bit-exact against numpy slicing."""
    from ofdm_jax.modem.rx import gather_windows

    F = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec.max_frame_len
    n = BLOCK + 40960
    rng = np.random.RandomState(1)
    re = rng.randn(n).astype(np.float32)
    im = rng.randn(n).astype(np.float32)
    starts = np.sort(rng.randint(0, n - F, 480)).astype(np.int32)
    starts[:3] = (-5, 0, n - F)
    starts[-2:] = (n - F + 7, n + 1000)
    got = np.asarray(jax.jit(lambda a, b, s: gather_windows(a, b, s, F))(
        re, im, starts))
    want = np.stack([re[s:s + F] + 1j * im[s:s + F]
                     for s in np.clip(starts, 0, n - F)]).astype(np.complex64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_chan", [64, 512])
def test_channelizer_matches_float64(n_chan):
    """Plain channelizer (FIR + HIGHEST matmul DFT) on the card vs the
    float64 numpy polyphase: error <= 1e-4 of the output RMS."""
    from ofdm_jax.spectrum.channelizer import channelize, lowpass_taps

    taps = lowpass_taps(n_chan)
    x = _noise(n_chan * 2048, seed=n_chan, amp=1.0)
    got = np.asarray(jax.jit(lambda a: channelize(a, n_chan, taps))(x))
    want = G.pfb_channelize(x.astype(np.complex128), n_chan,
                            taps.astype(np.float64))
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.abs(got - want).max() <= 1e-4 * rms


def test_psd_1024_matches_golden():
    """log_pwr_fft at 1024 bins vs golden_ofdm.log_pwr_fft: within 1e-3 dB
    over every bin no more than 60 dB below the peak bin."""
    from ofdm_jax.spectrum.psd import log_pwr_fft

    fft_len = 1024
    n = fft_len * 512
    t = np.arange(n)
    x = (0.5 * np.exp(2j * np.pi * 200.25 * t / fft_len)
         + _noise(n, seed=9, amp=0.05)).astype(np.complex64)
    got = np.asarray(jax.jit(lambda a: log_pwr_fft(a, fft_len))(x))
    want = G.log_pwr_fft(x.astype(np.complex128), fft_len)
    keep = want >= want.max(axis=-1, keepdims=True) - 60.0
    assert np.abs(got - want)[keep].max() <= 1e-3
    assert (got.argmax(axis=-1) == 200).all()


# BASELINE.json configs 1-3 at their own shapes (bench/curves.py): name,
# config, CFO (subcarriers), multipath taps, output, SNR (dB)
CONFIGS = {
    "config1_bpsk64_awgn": (
        OfdmConfig(fft_len=64, cp_len=16, modulation="bpsk",
                   max_payload_bytes=64), 0.0, None, "hard", 20.0),
    "config2_qpsk256_cfo": (
        OfdmConfig(fft_len=256, cp_len=64, modulation="qpsk",
                   max_payload_bytes=256), 1.3, None, "hard", 20.0),
    "config3_qam16_multipath_soft": (
        OfdmConfig(fft_len=64, cp_len=16, modulation="qam16",
                   max_payload_bytes=64),
        0.0, (1.0, 0.0, 0.35 + 0.2j, 0.0, 0.1j), "soft", 30.0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_loopback(name):
    """TX on the card (modem.tx) -> channel -> streaming RX: every frame
    back with CRC, payload and position right, the integer CFO the float64
    one, and EVM within the golden model's bound on the same capture."""
    from ofdm_jax.modem.rx_stream import (collect_frames, history_len,
                                          rx_stream_block)
    from ofdm_jax.modem.tx import tx_frame
    from ofdm_jax.ops.channel import channel_model
    from ofdm_jax.stream.executor import StreamExecutor

    cfg, cfo, taps, output, snr = CONFIGS[name]
    spec = cfg.spec
    gp = _golden(cfg)
    cap = cfg.max_payload_bytes - 4
    tx = jax.jit(lambda p, l, k: tx_frame(spec, p, l, k))
    msgs = [bytes([17 * i + j & 0xFF for j in range(cap - 3 * i)])
            for i in range(8)]
    frames = []
    for i, m in enumerate(msgs):
        buf = np.zeros(cap, np.uint8)
        buf[:len(m)] = np.frombuffer(m, np.uint8)
        r = tx(buf, len(m), i)
        f = np.asarray(r.samples)[:int(r.n_samples)]
        np.testing.assert_allclose(f, G.tx_frame(gp, m, frame_num=i),
                                   atol=2e-5)
        frames.append(f)
    gap = spec.max_frame_len + 3000
    clean = np.zeros(len(frames) * gap + 4 * spec.max_frame_len, np.complex64)
    pos = [500 + i * gap for i in range(len(frames))]
    for p, f in zip(pos, frames):
        clean[p:p + len(f)] = f
    jtaps = None if taps is None else jnp.asarray(np.asarray(taps),
                                                  jnp.complex64)
    rx = np.asarray(channel_model(
        jax.random.PRNGKey(3), jnp.asarray(clean), snr_db=snr, cfo=cfo,
        taps=jtaps, fft_len=cfg.fft_len))
    # K = 16 slots: the multipath echo can take a slot of its own
    sc = StreamConfig(block_size=1 << 15, max_frames_per_block=16)
    ex = StreamExecutor(rx_stream_block(spec, sc, output=output),
                        sc.block_size)
    got = collect_frames(ex.run(rx, drain=True), sc.block_size,
                         history_len(spec))
    assert len(got) == len(msgs), [g["payload"][:8] for g in got]
    for i, g in enumerate(got):
        assert g["crc_ok"] and g["payload"] == msgs[i]
        assert g["frame_num"] == i
        assert abs(g["abs_start"] - (pos[i] + cfg.cp_len)) <= cfg.cp_len // 2
        # integer + fractional estimate: the integer part is chosen by
        # an argmax over matmul scores (HIGHEST precision, not TF32)
        assert abs(g["int_cfo"] + g["fine_cfo"] - cfo) < 0.02
        seg = rx[pos[i] - 300:pos[i] + len(frames[i]) + 300]
        want = G.rx_frame(gp, seg.astype(np.complex128))
        assert want is not None and g["evm"] <= 2.0 * want["evm"] + 0.02
        if output == "soft":
            bits = np.unpackbits(np.frombuffer(msgs[i], np.uint8))
            llr = g["llr"][:len(bits)]
            np.testing.assert_array_equal((llr < 0).astype(np.uint8), bits)


def test_config4_wideband_loopback():
    """BASELINE config 4: 64-channel polyphase channelizer feeding 64
    parallel demods, frames on three channels, every one recovered on its
    channel and nowhere else."""
    from ofdm_jax.modem.wideband import (collect_wideband_frames,
                                         wideband_rx_block)
    from ofdm_jax.spectrum.channelizer import synthesize_bursts
    from ofdm_jax.stream.executor import StreamExecutor

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                     max_payload_bytes=64)
    spec = cfg.spec
    n_chan = 64
    sc = StreamConfig(block_size=n_chan * (1 << 14), max_frames_per_block=4)
    per = sc.block_size // n_chan
    msgs = {3: b"channel three", 17: b"channel seventeen", 40: b"forty"}
    bursts = [(k, 200 + 37 * k, G.tx_frame(_golden(cfg), m, frame_num=k))
              for k, m in msgs.items()]
    wide = synthesize_bursts(3 * sc.block_size, n_chan, bursts)
    wide = wide + _noise(len(wide), seed=4, amp=0.004)
    ex = StreamExecutor(wideband_rx_block(spec, n_chan, sc), sc.block_size)
    got = [f for f in collect_wideband_frames(ex.run(wide), per, spec)]
    assert sorted(f["channel"] for f in got) == sorted(msgs)
    for f in got:
        assert f["crc_ok"] and f["payload"] == msgs[f["channel"]]
        start = 200 + 37 * f["channel"]
        assert abs(f["abs_start"] - start) < 40, (f["abs_start"], start)


def test_tx_stream_loopback_on_device():
    """Streaming TX (tx_stream_block) on the card -> channel -> streaming
    RX: every queued PDU comes back once, in order."""
    from ofdm_jax.modem.rx_stream import (collect_frames, history_len,
                                          rx_stream_block)
    from ofdm_jax.modem.tx_stream import (empty_tx_in, queue_tx_in,
                                          tx_stream_block)
    from ofdm_jax.ops.channel import channel_model
    from ofdm_jax.stream.executor import StreamExecutor

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                     max_payload_bytes=64)
    spec = cfg.spec
    sc = StreamConfig(block_size=1 << 14, max_frames_per_block=8)
    msgs = [b"streamed pdu %02d on the card" % i for i in range(20)]
    tex = StreamExecutor(tx_stream_block(spec, sc), sc.block_size)
    pending, sent, chunks = list(msgs), 0, []
    for _ in range(12):
        ti, rest = queue_tx_in(spec, 8, pending, frame_num0=sent)
        out = tex.push(ti if pending else empty_tx_in(spec, 8))
        n_ok = int(np.asarray(out.accepted)[:len(pending[:8])].sum())
        pending, sent = pending[n_ok:], sent + n_ok
        chunks.append(np.asarray(out.samples))
    assert not pending
    rx = channel_model(jax.random.PRNGKey(5), jnp.asarray(
        np.concatenate(chunks)), snr_db=25, cfo=0.05, fft_len=cfg.fft_len)
    rex = StreamExecutor(rx_stream_block(spec, sc), sc.block_size)
    got = collect_frames(rex.run(np.asarray(rx), drain=True), sc.block_size,
                         history_len(spec))
    assert [g["payload"] for g in got] == msgs
    assert all(g["crc_ok"] for g in got)
