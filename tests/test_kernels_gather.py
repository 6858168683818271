"""Slot-window gather (modem.rx.gather_windows) vs plain numpy slicing.

The receiver gathers one max_frame_len window per detection slot, K = 480
of them per step at the headline shape; XLA turns the vmapped
dynamic_slice into one gather.  The compiled run on the card is in
tests/test_gpu.py.
"""

import numpy as np

import jax
import jax.numpy as jnp

from ofdm_jax.modem.rx import gather_windows


def _planes(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32),
            rng.randn(n).astype(np.float32))


def test_gather_windows_matches_numpy():
    n, K, F = 1 << 18, 37, 1360
    re, im = _planes(n, 0)
    rng = np.random.RandomState(1)
    starts = np.sort(rng.randint(0, n - F, K)).astype(np.int32)
    got = np.asarray(jax.jit(
        lambda a, b, s: gather_windows(a, b, s, F))(re, im, starts))
    want = np.stack([re[s:s + F] + 1j * im[s:s + F] for s in starts])
    np.testing.assert_array_equal(got, want.astype(np.complex64))


def test_gather_windows_clamps_starts():
    """Starts past either end read the first or last full window, as the
    receiver's invalid slots rely on (rx_block clamps them the same way)."""
    n, F = 5000, 1360
    re, im = _planes(n, 2)
    starts = np.array([-7, 0, 1, n - F - 1, n - F, n - F + 3, n + 100],
                      np.int32)
    got = np.asarray(gather_windows(jnp.asarray(re), jnp.asarray(im),
                                    jnp.asarray(starts), F))
    want = np.stack([re[c:c + F] + 1j * im[c:c + F]
                     for c in np.clip(starts, 0, n - F)])
    np.testing.assert_array_equal(got, want.astype(np.complex64))


def test_gather_windows_under_vmap():
    """Per-channel gathers as the wideband RX runs them (rx_block vmapped
    over channel rows)."""
    n, K, F = 9000, 5, 700
    rng = np.random.RandomState(3)
    re = rng.randn(3, n).astype(np.float32)
    im = rng.randn(3, n).astype(np.float32)
    starts = rng.randint(0, n - F, (3, K)).astype(np.int32)
    got = np.asarray(jax.vmap(lambda a, b, s: gather_windows(a, b, s, F))(
        re, im, starts))
    assert got.shape == (3, K, F)
    for c in range(3):
        want = np.stack([re[c, s:s + F] + 1j * im[c, s:s + F]
                         for s in starts[c]])
        np.testing.assert_array_equal(got[c], want.astype(np.complex64))
