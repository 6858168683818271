"""Frame-level modem loopback tests vs the golden oracle.

The JAX equivalent of the reference's qa_ofdm_txrx.py integration tests
(SURVEY.md §4): full TX -> channel_model -> RX, assert recovered bytes ==
sent bytes under AWGN/CFO/multipath, and TX output bit-matches the golden
model (BASELINE.json correctness bound).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from golden import golden_ofdm as G
from ofdm_jax.config import OfdmConfig
from ofdm_jax.modem.rx import demod_frame, rx_block
from ofdm_jax.modem.tx import tx_frame, tx_frames
from ofdm_jax.ops.channel import channel_model

PAYLOAD = b"The quick brown fox jumps over the lazy dog! 0123456789"


def _tx(cfg, payload=PAYLOAD, frame_num=3):
    spec = cfg.spec
    buf = np.zeros(cfg.max_payload_bytes - 4, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    return jax.jit(lambda p, l: tx_frame(spec, p, l, frame_num))(
        jnp.asarray(buf), len(payload)
    )


@pytest.mark.parametrize("m", ["bpsk", "qpsk", "qam16", "qam64"])
def test_tx_matches_golden(m):
    cfg = OfdmConfig(modulation=m, max_payload_bytes=64)
    txr = _tx(cfg)
    gp = G.GoldenOfdmParams(modulation=m)
    want = G.tx_frame(gp, PAYLOAD, frame_num=3)
    n = int(txr.n_samples)
    assert n == len(want)
    np.testing.assert_allclose(
        np.asarray(txr.samples[:n]), want.astype(np.complex64), atol=2e-5
    )
    # padding region (if any) is silent
    tail = np.asarray(txr.samples[n:])
    assert tail.size == 0 or float(np.max(np.abs(tail))) == 0.0


@pytest.mark.parametrize("m", ["bpsk", "qpsk", "qam16", "qam64"])
def test_loopback_clean(m):
    cfg = OfdmConfig(modulation=m, max_payload_bytes=64)
    spec = cfg.spec
    txr = _tx(cfg)
    stream = jnp.concatenate(
        [jnp.zeros(300, jnp.complex64), txr.samples, jnp.zeros(300, jnp.complex64)]
    )
    res = jax.jit(lambda s: rx_block(spec, s, max_frames=4))(stream)
    v = np.asarray(res.valid)
    assert v.sum() == 1
    i = int(np.argmax(v))
    f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
    assert f.crc_ok and f.hdr_ok
    assert int(f.payload_len) == len(PAYLOAD)
    assert bytes(f.payload[: len(PAYLOAD)]) == PAYLOAD
    assert int(f.frame_num) == 3
    assert float(f.evm) < 1e-5


@pytest.mark.parametrize(
    "m,snr", [("bpsk", 15), ("qpsk", 20), ("qam16", 25), ("qam64", 32)]
)
def test_loopback_awgn(m, snr):
    cfg = OfdmConfig(modulation=m, max_payload_bytes=64)
    spec = cfg.spec
    txr = _tx(cfg)
    stream = jnp.concatenate(
        [jnp.zeros(256, jnp.complex64), txr.samples, jnp.zeros(256, jnp.complex64)]
    )
    rx = channel_model(jax.random.PRNGKey(7), stream, snr_db=snr,
                       fft_len=cfg.fft_len)
    res = jax.jit(lambda s: rx_block(spec, s, max_frames=4))(rx)
    v = np.asarray(res.valid)
    assert v.sum() >= 1
    i = int(np.argmax(v))
    f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
    assert f.crc_ok
    assert bytes(f.payload[: len(PAYLOAD)]) == PAYLOAD


def test_loopback_cfo_fractional_and_integer():
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    txr = _tx(cfg)
    stream = jnp.concatenate(
        [jnp.zeros(256, jnp.complex64), txr.samples, jnp.zeros(256, jnp.complex64)]
    )
    rx = channel_model(jax.random.PRNGKey(3), stream, snr_db=28, cfo=2.2,
                       fft_len=cfg.fft_len, phase=0.7)
    res = jax.jit(lambda s: rx_block(spec, s, max_frames=4))(rx)
    v = np.asarray(res.valid)
    assert v.sum() >= 1
    i = int(np.argmax(v))
    f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
    assert f.crc_ok
    assert bytes(f.payload[: len(PAYLOAD)]) == PAYLOAD
    assert int(f.int_cfo) == 2
    assert abs(float(np.asarray(res.fine_cfo)[i]) - 0.2) < 0.03


@pytest.mark.parametrize("equalizer", ["pilot_phase", "simpledfe"])
def test_loopback_multipath(equalizer):
    cfg = OfdmConfig(modulation="qam16", max_payload_bytes=64)
    spec = cfg.spec
    txr = _tx(cfg)
    stream = jnp.concatenate(
        [jnp.zeros(256, jnp.complex64), txr.samples, jnp.zeros(256, jnp.complex64)]
    )
    taps = jnp.asarray([1.0, 0.0, 0.35 + 0.2j, 0.0, 0.1j], jnp.complex64)
    rx = channel_model(jax.random.PRNGKey(5), stream, snr_db=30, taps=taps,
                       fft_len=cfg.fft_len)
    res = jax.jit(
        lambda s: rx_block(spec, s, max_frames=4, equalizer=equalizer)
    )(rx)
    v = np.asarray(res.valid)
    assert v.sum() >= 1
    i = int(np.argmax(v))
    f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
    assert f.crc_ok
    assert bytes(f.payload[: len(PAYLOAD)]) == PAYLOAD


def test_demod_matches_golden_rx():
    """Feed the SAME impaired capture to both RX implementations; the
    recovered constellation points must agree closely (EVM-level parity,
    BASELINE.json 'within the reference's EVM/SNR bound')."""
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    gp = G.GoldenOfdmParams(modulation="qpsk")
    gtx = G.tx_frame(gp, PAYLOAD, frame_num=3)
    sig = np.concatenate([np.zeros(128), gtx, np.zeros(128)])
    cap = G.channel(sig, snr_db=25, cfo=0.15, fft_len=64, seed=11)

    gres = G.rx_frame(gp, cap)
    assert gres is not None and gres["crc_ok"]

    res = jax.jit(lambda s: rx_block(spec, s, max_frames=4))(
        jnp.asarray(cap, jnp.complex64)
    )
    v = np.asarray(res.valid)
    assert v.sum() == 1
    i = int(np.argmax(v))
    f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
    assert f.crc_ok
    assert bytes(f.payload[: len(PAYLOAD)]) == PAYLOAD
    # EVM parity within 2x of golden (different timing backoff is allowed)
    assert float(f.evm) < max(2.0 * gres["evm"], 0.05)


def test_batched_tx():
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    b = 4
    rng = np.random.RandomState(0)
    bufs = rng.randint(0, 256, size=(b, cfg.max_payload_bytes - 4)).astype(np.uint8)
    lens = np.array([10, 20, 30, 60], np.int32)
    frames = jax.jit(lambda p, l, n: tx_frames(spec, p, l, n))(
        jnp.asarray(bufs), jnp.asarray(lens), jnp.arange(b)
    )
    assert frames.samples.shape == (b, spec.max_frame_len)
    # each frame individually decodable
    for i in range(b):
        stream = jnp.concatenate(
            [jnp.zeros(100, jnp.complex64), frames.samples[i],
             jnp.zeros(100, jnp.complex64)]
        )
        res = rx_block(spec, stream, max_frames=2)
        v = np.asarray(res.valid)
        assert v.sum() == 1
        f = jax.tree.map(lambda x: np.asarray(x)[int(np.argmax(v))], res.frames)
        assert f.crc_ok
        assert int(f.payload_len) == lens[i]
        assert np.array_equal(f.payload[: lens[i]], bufs[i, : lens[i]])


def test_loopback_with_rolloff():
    """TX pulse shaping (rolloff_len>0) must not break the RX chain."""
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64, rolloff_len=6)
    spec = cfg.spec
    txr = _tx(cfg)
    stream = jnp.concatenate(
        [jnp.zeros(300, jnp.complex64), txr.samples, jnp.zeros(300, jnp.complex64)]
    )
    res = jax.jit(lambda s: rx_block(spec, s, max_frames=4))(stream)
    v = np.asarray(res.valid)
    assert v.sum() == 1
    i = int(np.argmax(v))
    f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
    assert f.crc_ok and bytes(f.payload[: len(PAYLOAD)]) == PAYLOAD


def test_loopback_soft_config3():
    """BASELINE config 3: 16-QAM over multipath, pilot-based LS equalization,
    SOFT demap -- the RX emits per-bit max-log LLRs whose signs reproduce the
    transmitted wire bits."""
    cfg = OfdmConfig(modulation="qam16", max_payload_bytes=64)
    spec = cfg.spec
    txr = _tx(cfg)
    stream = jnp.concatenate(
        [jnp.zeros(256, jnp.complex64), txr.samples, jnp.zeros(256, jnp.complex64)]
    )
    taps = jnp.asarray([1.0, 0.0, 0.35 + 0.2j, 0.0, 0.1j], jnp.complex64)
    rx = channel_model(jax.random.PRNGKey(5), stream, snr_db=30, taps=taps,
                       fft_len=cfg.fft_len)
    res = jax.jit(
        lambda s: rx_block(spec, s, max_frames=4, output="soft")
    )(rx)
    v = np.asarray(res.valid)
    assert v.sum() >= 1
    i = int(np.argmax(v))
    f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
    assert f.crc_ok
    assert bytes(f.payload[: len(PAYLOAD)]) == PAYLOAD
    # LLR signs == hard wire bits (positive LLR => bit 0)
    wire_len = int(f.payload_len) + 4
    wire_bits = np.unpackbits(f.payload[:wire_len])
    llr = f.llr[: wire_len * 8]
    assert np.array_equal((llr < 0).astype(np.uint8), wire_bits)
    # LLRs are zeroed (masked) beyond the wire length
    assert np.all(f.llr[wire_len * 8:] == 0.0)


def test_soft_demap_beats_hard_at_low_snr():
    """Rate-1/3 repetition decode: summing LLRs (soft combining) must beat
    majority vote over hard bits -- the property that justifies the soft
    output surface (VERDICT r1 item 4)."""
    cfg = OfdmConfig(modulation="qam16", max_payload_bytes=64)
    spec = cfg.spec
    rng = np.random.RandomState(42)
    n_payload = 60                       # bytes; 480 bits = 160 info bits x 3
    n_info = n_payload * 8 // 3
    info = rng.randint(0, 2, n_info).astype(np.uint8)
    coded = np.repeat(info, 3)           # b0 b0 b0 b1 b1 b1 ...
    payload = np.packbits(coded).tobytes()

    txr = _tx(cfg, payload=payload)
    stream = jnp.concatenate(
        [jnp.zeros(256, jnp.complex64), txr.samples, jnp.zeros(256, jnp.complex64)]
    )
    hard_err = soft_err = 0
    n_ok = 0
    for seed in range(10):
        rx = channel_model(jax.random.PRNGKey(seed), stream, snr_db=8,
                           fft_len=cfg.fft_len)
        res = jax.jit(
            lambda s: rx_block(spec, s, max_frames=4, output="soft")
        )(rx)
        v = np.asarray(res.valid)
        if v.sum() < 1:
            continue  # detection failed at this noise draw; skip trial
        n_ok += 1
        i = int(np.argmax(v))
        f = jax.tree.map(lambda x: np.asarray(x)[i], res.frames)
        bits = np.unpackbits(f.payload[:n_payload])[: n_info * 3].reshape(-1, 3)
        llr = f.llr[: n_info * 3].reshape(-1, 3)
        hard_dec = (bits.sum(1) >= 2).astype(np.uint8)     # majority vote
        soft_dec = (llr.sum(1) < 0).astype(np.uint8)       # LLR combining
        hard_err += int((hard_dec != info).sum())
        soft_err += int((soft_dec != info).sum())
    assert n_ok >= 5, f"only {n_ok} trials detected a frame"
    assert hard_err > 0, "SNR too high to exercise the comparison"
    assert soft_err < hard_err, (hard_err, soft_err)
