"""PSD frames (spectrum.psd) vs the float64 numpy logpwrfft chain
(golden_ofdm.log_pwr_fft), 128 to 1024 bins, window options, and the
streaming Block's IIR averaging.  The compiled run on the card is in
tests/test_gpu.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from golden import golden_ofdm as G
from ofdm_jax.spectrum import window as win
from ofdm_jax.spectrum.psd import log_pwr_fft, log_pwr_fft_block, psd_frames
from ofdm_jax.stream.executor import StreamExecutor


def _rand(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _psd64(x, fft_len, window="hann"):
    n = len(x) // fft_len
    frames = x[: n * fft_len].reshape(n, fft_len).astype(np.complex128)
    w = win.get(window, fft_len).astype(np.float64)
    wf = np.fft.fft(frames * w, axis=1)
    return np.abs(wf) ** 2 / (np.sum(w ** 2) * fft_len)


@pytest.mark.parametrize("fft_len", [128, 256, 512, 1024])
def test_psd_frames_match_golden(fft_len):
    x = _rand(fft_len * 24, seed=fft_len)
    got = np.asarray(psd_frames(jnp.asarray(x), fft_len))
    assert got.shape == (24, fft_len)
    np.testing.assert_allclose(got, _psd64(x, fft_len), rtol=0,
                               atol=1e-4 * got.max())
    # and in dB against the golden chain itself
    db = np.asarray(log_pwr_fft(jnp.asarray(x), fft_len))
    np.testing.assert_allclose(db, G.log_pwr_fft(x.astype(np.complex128),
                                                 fft_len), atol=1e-3)


def test_psd_tone_bin():
    """A pure tone at bin 37 must put (virtually) all power in bin 37."""
    fft_len = 256
    n = fft_len * 16
    t = np.arange(n)
    x = np.exp(2j * np.pi * 37 * t / fft_len).astype(np.complex64)
    got = np.asarray(psd_frames(jnp.asarray(x), fft_len))
    np.testing.assert_array_equal(got.argmax(axis=-1), 37)
    # windowed leakage: the tone bin dominates everything outside the
    # window's main lobe by orders of magnitude
    far = np.delete(got, [36, 37, 38], axis=-1)
    assert (got[:, 37] > 1e5 * far.max(axis=-1)).all()


def test_psd_window_options_and_padding():
    fft_len = 128
    x = _rand(fft_len * 11 + 37, seed=2)          # ragged tail dropped
    for window in ("blackman_harris", "hamming", "rectangular"):
        got = np.asarray(psd_frames(jnp.asarray(x), fft_len, window=window))
        want = _psd64(x, fft_len, window)
        assert got.shape == want.shape == (11, fft_len)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * want.max())


def test_psd_block_iir_matches_golden():
    """The streaming logpwrfft Block carries the IIR state across steps:
    three steps equal the golden chain over the whole capture."""
    fft_len, alpha = 256, 0.3
    x = _rand(fft_len * 30, seed=4)
    ex = StreamExecutor(log_pwr_fft_block(fft_len, avg_alpha=alpha),
                        fft_len * 10)
    got = np.concatenate([np.asarray(ex.push(x[k * fft_len * 10:
                                               (k + 1) * fft_len * 10]))
                          for k in range(3)], axis=0)
    want = G.log_pwr_fft(x.astype(np.complex128), fft_len, avg_alpha=alpha)
    np.testing.assert_allclose(got, want, atol=1e-3)
