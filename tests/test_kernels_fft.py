"""Matmul-DFT / four-step FFT kernel vs numpy.fft (SURVEY.md §7 dec. 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_jax.kernels import fft as kfft


@pytest.mark.parametrize("n", [8, 64, 128, 256, 512, 1024, 4096])
def test_fft_matches_numpy(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(5, n) + 1j * rng.randn(5, n)).astype(np.complex64)
    got = np.asarray(jax.jit(kfft.fft)(jnp.asarray(x)))
    want = np.fft.fft(x, axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("n", [64, 192, 1000, 2048])
def test_ifft_roundtrip(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(3, n) + 1j * rng.randn(3, n)).astype(np.complex64)
    back = np.asarray(kfft.ifft(kfft.fft(jnp.asarray(x))))
    np.testing.assert_allclose(back, x, atol=2e-4 * np.abs(x).max())


def test_ifft_matches_numpy():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 64) + 1j * rng.randn(4, 64)).astype(np.complex64)
    got = np.asarray(kfft.ifft(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.fft.ifft(x, axis=-1), atol=1e-5)


def test_fft_axis_argument():
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 4) + 1j * rng.randn(64, 4)).astype(np.complex64)
    got = np.asarray(kfft.fft(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(got, np.fft.fft(x, axis=0), atol=1e-3)


def test_prime_large_raises():
    with pytest.raises(ValueError):
        kfft.fft(jnp.zeros(257 * 2, jnp.complex64))  # 514 = 2*257, 257 prime
