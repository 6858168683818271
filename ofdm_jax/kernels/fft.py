"""Matmul FFT: batched matmul DFT + four-step Cooley-Tukey.

JAX replacement for the reference's FFTW wrapper (SURVEY.md §2b "FFT
kernel", gr-fft/lib/fft.cc, unverified path).

Design (SURVEY.md §7 decision 4 / hard part 5): OFDM symbol FFTs are small
(64-4096 points) but come in huge batches -- thousands of symbols per
streaming block -- so an N-point DFT is done as a matmul against the DFT
matrix, (batch, N) @ (N, N), for N <= 256.  For larger N the four-step
(Bailey) decomposition N = N1*N2 turns the transform into two batched
matmul DFT stages + one twiddle multiply:

    X[k2*N1 + k1] = DFT_N2_{j2->k2}[ W_N^{j2*k1} * DFT_N1_{j1->k1}[ A[j1,j2] ] ]

The products run in HIGHEST precision, so on the GPU they do not drop to
TF32.  The form was chosen for the accelerator the system was first built
for and is kept as it runs; whether jnp.fft (cuFFT) is faster on the GPU
at 64-4096 points is not measured yet.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Largest DFT done as a single matmul (256x256 complex = 4 real matmuls).
_MATMUL_MAX = 256


@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, sign: int) -> np.ndarray:
    """W[k, j] = exp(sign * 2j*pi*k*j/n), complex64."""
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> np.ndarray:
    """T[k1, j2] = exp(sign * 2j*pi*k1*j2/(n1*n2)), complex64."""
    k1 = np.arange(n1)
    j2 = np.arange(n2)
    return np.exp(sign * 2j * np.pi * np.outer(k1, j2) / (n1 * n2)).astype(
        np.complex64
    )


def _split(n: int) -> tuple[int, int]:
    """Balanced factorization n = n1*n2 with n1 as close to sqrt(n) as
    possible (prefers power-of-two splits)."""
    if n % 2 == 0:
        n1 = 1
        while n1 * n1 < n and n % (n1 * 2) == 0:
            n1 *= 2
    else:
        n1 = int(np.sqrt(n))
        while n1 > 1 and n % n1:
            n1 -= 1
    if n1 <= 1:
        raise ValueError(
            f"FFT length {n} > {_MATMUL_MAX} must be factorable; got prime"
        )
    return n1, n // n1


def _dft_last(x: jnp.ndarray, sign: int) -> jnp.ndarray:
    """DFT along the last axis (any batch shape), unnormalized."""
    n = x.shape[-1]
    if n <= _MATMUL_MAX:
        w = jnp.asarray(_dft_matrix_np(n, sign))
        # (..., j) @ (j, k): one complex matmul = 4 real matmuls
        return jnp.einsum(
            "...j,jk->...k", x, w, precision=jax.lax.Precision.HIGHEST
        ).astype(jnp.complex64)
    n1, n2 = _split(n)
    a = x.reshape(*x.shape[:-1], n1, n2)          # A[j1, j2]
    b = _dft_last(jnp.swapaxes(a, -1, -2), sign)   # (..., j2, k1): DFT over j1
    b = jnp.swapaxes(b, -1, -2)                    # (..., k1, j2)
    b = b * jnp.asarray(_twiddle_np(n1, n2, sign))
    c = _dft_last(b, sign)                         # (..., k1, k2): DFT over j2
    # X[k2*n1 + k1] = C[k1, k2] -> flatten transposed
    return jnp.swapaxes(c, -1, -2).reshape(*x.shape[:-1], n)


def fft(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Forward FFT (numpy convention, unnormalized), complex64."""
    x = jnp.asarray(x, dtype=jnp.complex64)
    if axis not in (-1, x.ndim - 1):
        x = jnp.moveaxis(x, axis, -1)
        return jnp.moveaxis(_dft_last(x, -1), -1, axis)
    return _dft_last(x, -1)


def ifft(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Inverse FFT (numpy convention: includes 1/n), complex64."""
    x = jnp.asarray(x, dtype=jnp.complex64)
    n = x.shape[axis]
    if axis not in (-1, x.ndim - 1):
        x = jnp.moveaxis(x, axis, -1)
        return jnp.moveaxis(_dft_last(x, +1) / n, -1, axis)
    return _dft_last(x, +1) / n


def fftshift(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    n = x.shape[axis]
    return jnp.roll(x, n // 2, axis=axis)
