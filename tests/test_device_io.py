"""Boundary-packing machinery (utils.device_io) under forced packing.

Packing is off by default; these tests force it ON under CPU to validate
the wrappers end-to-end, including the streaming executor path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_jax.utils import device_io as dio


@pytest.fixture(autouse=True)
def force_packing():
    dio.set_packing(True)
    yield
    dio.set_packing(None)


def test_encode_decode_roundtrip():
    x = (np.arange(6) + 1j * np.ones(6)).astype(np.complex64)
    enc = dio.encode(x)
    assert isinstance(enc, dio.PackedComplex)
    back = dio.decode(enc)
    np.testing.assert_allclose(back, x)


def test_jit_safe_complex_fn():
    def fn(z, gain):
        return z * gain, jnp.abs(z) > 1.0

    call = dio.jit_safe(fn)
    z = (np.asarray([0.5, 2.0, 1.5]) + 0j).astype(np.complex64)
    out, mask = call(z, 2.0)
    np.testing.assert_allclose(out, z * 2.0)
    # bool came back as int32 (packed boundary) -- truthiness preserved
    assert np.array_equal(np.asarray(mask).astype(bool), [False, True, True])


def test_executor_packed_stream():
    from ofdm_jax.stream.block import fir_filter
    from ofdm_jax.stream.executor import StreamExecutor

    taps = (np.arange(5) + 1.0).astype(np.complex64)
    ex = StreamExecutor(fir_filter(taps), block_size=32)
    rng = np.random.RandomState(0)
    x = (rng.randn(128) + 1j * rng.randn(128)).astype(np.complex64)
    outs = ex.run(x, drain=True)
    y = np.concatenate([np.asarray(dio.to_host(o)) for o in outs])
    want = np.convolve(x, taps)[:128]
    np.testing.assert_allclose(y, want, atol=1e-3)


def test_rx_stream_packed():
    """Full streaming RX with packed boundaries == unpacked results."""
    from ofdm_jax.config import OfdmConfig, StreamConfig
    from ofdm_jax.modem.rx_stream import collect_frames, history_len, rx_stream_block
    from ofdm_jax.modem.tx import tx_frames
    from ofdm_jax.stream.executor import StreamExecutor

    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    payload = b"packed boundary frame"
    buf = np.zeros((1, 60), np.uint8)
    buf[0, : len(payload)] = np.frombuffer(payload, np.uint8)

    dio.set_packing(False)
    frames = tx_frames(spec, jnp.asarray(buf), jnp.asarray([len(payload)]),
                       jnp.asarray([5]))
    n = int(frames.n_samples[0])
    stream = np.concatenate(
        [np.zeros(700, np.complex64), np.asarray(frames.samples[0][:n]),
         np.zeros(1500, np.complex64)]
    )
    dio.set_packing(True)

    bs = 1024
    ex = StreamExecutor(rx_stream_block(spec, StreamConfig(block_size=bs)), bs)
    outs = ex.run(stream, drain=True)
    got = collect_frames(outs, bs, history_len(spec))
    assert len(got) == 1
    assert got[0]["payload"] == payload
    assert got[0]["crc_ok"] and got[0]["frame_num"] == 5
