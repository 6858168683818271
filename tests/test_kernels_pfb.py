"""Polyphase channelizer (spectrum.channelizer) vs the float64 numpy
polyphase reference (golden_ofdm.pfb_channelize), one-shot and streaming
with the raw-sample tail carry, 8 to 512 channels (BASELINE config 4 runs
64, config 5 runs 512).  The compiled run on the card is in
tests/test_gpu.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from golden import golden_ofdm as G
from ofdm_jax.spectrum.channelizer import (
    channelize,
    channelize_stream,
    channelizer_block,
    lowpass_taps,
    polyphase_decompose,
    stream_tail_len,
    tail_len,
)
from ofdm_jax.stream.executor import StreamExecutor


def _rand(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _assert_close(got, want):
    """Error at most 1e-4 of the output RMS (f32 FIR + matmul DFT)."""
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.abs(got - want).max() <= 1e-4 * rms, (
        np.abs(got - want).max() / rms)


def _stream(x, n_chan, taps, cuts):
    """channelize_stream over x split at `cuts`, tail threaded through."""
    poly = jnp.asarray(polyphase_decompose(taps, n_chan))
    tail = jnp.zeros(stream_tail_len(n_chan, taps), jnp.complex64)
    outs, lo = [], 0
    for hi in list(cuts) + [len(x)]:
        out, tail = channelize_stream(jnp.asarray(x[lo:hi]), tail, n_chan,
                                      taps, poly)
        outs.append(np.asarray(out))
        lo = hi
    return np.concatenate(outs, axis=0)


@pytest.mark.parametrize("n_chan", [8, 32, 64, 128, 256, 512])
def test_channelize_matches_numpy_polyphase(n_chan):
    taps = lowpass_taps(n_chan)
    n_out = 300 if n_chan <= 128 else 40
    x = _rand(n_chan * n_out, seed=n_chan)
    got = np.asarray(channelize(jnp.asarray(x), n_chan, taps))
    want = G.pfb_channelize(x.astype(np.complex128), n_chan,
                            taps.astype(np.float64))
    assert got.shape == want.shape == (n_out, n_chan)
    _assert_close(got, want)


@pytest.mark.parametrize("n_chan", [64, 512])
def test_stream_tail_matches_oneshot(n_chan):
    """Tail-carried steps == one pass, FIR lookback intact across the
    block boundary."""
    taps = lowpass_taps(n_chan, taps_per_arm=8)
    n0, n1 = n_chan * 24, n_chan * 16
    x = _rand(n0 + n1, seed=5)
    want = G.pfb_channelize(x.astype(np.complex128), n_chan,
                            taps.astype(np.float64))
    _assert_close(_stream(x, n_chan, taps, [n0]), want)


def test_stream_many_short_steps():
    """Steps shorter than the FIR lookback (fewer commutator loads than
    taps per arm) still carry the full history."""
    n_chan = 256
    taps = lowpass_taps(n_chan, taps_per_arm=8)
    x = _rand(n_chan * 50, seed=11)
    want = G.pfb_channelize(x.astype(np.complex128), n_chan,
                            taps.astype(np.float64))
    cuts = [n_chan * k for k in (3, 5, 6, 13, 20, 21, 33)]
    _assert_close(_stream(x, n_chan, taps, cuts), want)


def test_explicit_zero_tail_equals_oneshot():
    n_chan = 32
    taps = lowpass_taps(n_chan)
    x = _rand(n_chan * 50, seed=9)
    a = np.asarray(channelize(jnp.asarray(x), n_chan, taps))
    b = _stream(x, n_chan, taps, [])
    np.testing.assert_array_equal(a, b)


def test_tail_len_covers_lookback():
    # exactly the (J-1)*N raw samples of FIR lookback are carried
    for n_chan in (8, 64, 128, 256, 512):
        for j in (1, 4, 8, 16):
            assert tail_len(n_chan, j) == (j - 1) * n_chan
        taps = lowpass_taps(n_chan, taps_per_arm=8)
        assert stream_tail_len(n_chan, taps) == 7 * n_chan


def test_channelizer_block_streams_like_oneshot():
    """The executor Block (raw-sample tail as its carry) over three steps
    equals the one-shot channelizer."""
    n_chan = 64
    taps = lowpass_taps(n_chan)
    x = _rand(n_chan * 96, seed=13)
    ex = StreamExecutor(channelizer_block(n_chan, taps), n_chan * 32)
    got = np.concatenate(
        [np.asarray(ex.push(x[k * n_chan * 32:(k + 1) * n_chan * 32]))
         for k in range(3)], axis=0)
    want = np.asarray(channelize(jnp.asarray(x), n_chan, taps))
    _assert_close(got, want)
