"""Window sums (ops.sync.moving_sums / moving_sum) against float64 numpy,
and the Schmidl-Cox metric built on them against the golden model.

The window sums are summed directly (lax.reduce_window), so they stay
exact to f32 at any block length -- including 2^22 and beyond, where
differences of one block-length f32 prefix sum lose the small windows
behind a large signal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from golden import golden_ofdm as G
from ofdm_jax.config import OfdmConfig
from ofdm_jax.ops import sync as ksync


def _convolve64(x, w):
    return np.convolve(np.asarray(x, np.float64), np.ones(w), "valid")


def test_moving_sums_matches_convolve():
    rng = np.random.RandomState(2)
    n, w = 5000, 33
    a = rng.randn(n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    ga, gb = ksync.moving_sums([jnp.asarray(a), jnp.asarray(b)], w)
    np.testing.assert_allclose(np.asarray(ga), _convolve64(a, w),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gb), _convolve64(b, w),
                               rtol=2e-4, atol=2e-5)


def test_moving_sums_exact_at_block_length():
    """n >= 2^22 with a loud burst ahead of a quiet stretch: every window
    within 1e-5 of its own magnitude, where a single f32 prefix sum
    differenced at lag w is off by far more (asserted, so the test keeps
    guarding the property the repair is for)."""
    n, w = (1 << 22) + 77, 32
    rng = np.random.RandomState(3)
    x = (rng.rand(n).astype(np.float32) * 1e-3)
    x[: n // 2] += rng.rand(n // 2).astype(np.float32)
    (got,) = ksync.moving_sums([jnp.asarray(x)], w)
    want = np.convolve(x.astype(np.float64), np.ones(w), "valid")
    rel = np.abs(np.asarray(got) - want) / want
    assert rel.max() < 1e-5, rel.max()
    c = np.cumsum(x, dtype=np.float32)
    naive = c[w - 1:] - np.concatenate([[0.0], c[:-w]]).astype(np.float32)
    assert (np.abs(naive - want) / want).max() > 1e-2


def test_moving_sum_complex():
    rng = np.random.RandomState(4)
    x = (rng.randn(3000) + 1j * rng.randn(3000)).astype(np.complex64)
    got = np.asarray(ksync.moving_sum(jnp.asarray(x), 17))
    want = (_convolve64(x.real, 17) + 1j * _convolve64(x.imag, 17))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_moving_sums_batched_rows():
    """Leading axes are batch: windows run along the last axis only."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 2, 1000).astype(np.float32)
    (got,) = ksync.moving_sums([jnp.asarray(x)], 9)
    assert got.shape == (3, 2, 992)
    for i in range(3):
        for j in range(2):
            np.testing.assert_allclose(np.asarray(got[i, j]),
                                       _convolve64(x[i, j], 9),
                                       rtol=2e-4, atol=2e-5)


def _spec_for(L):
    return OfdmConfig(fft_len=2 * L, cp_len=L // 2, modulation="qpsk").spec


@pytest.mark.parametrize("L", [32, 128, 192])
def test_schmidl_cox_matches_golden_metric(L):
    """SyncMetric's P, R and M against golden_ofdm.schmidl_cox_metric on a
    frame over noise (M compared where the energy gate keeps it)."""
    spec = _spec_for(L)
    gp = G.GoldenOfdmParams(fft_len=2 * L, cp_len=L // 2, modulation="qpsk")
    rng = np.random.RandomState(3)
    frame = G.tx_frame(gp, b"metric check" * 3)
    noise = 0.05 * (rng.randn(len(frame) + 600) + 1j * rng.randn(len(frame) + 600))
    r = noise.astype(np.complex64)
    r[300:300 + len(frame)] += frame.astype(np.complex64)
    m = jax.jit(lambda x: ksync.schmidl_cox(spec, x))(jnp.asarray(r))
    gm, gP = G.schmidl_cox_metric(gp, r.astype(np.complex128))
    n = len(gm)
    np.testing.assert_allclose(np.asarray(m.corr)[:n], gP, rtol=1e-4,
                               atol=1e-4)
    R = _convolve64(np.abs(r[L:].astype(np.complex128)) ** 2, L)[:n]
    np.testing.assert_allclose(np.asarray(m.energy)[:n], R, rtol=1e-4,
                               atol=1e-5)
    keep = np.asarray(m.metric)[:n] > 0
    assert keep.sum() > len(frame) // 2
    np.testing.assert_allclose(np.asarray(m.metric)[:n][keep], gm[keep],
                               rtol=1e-3, atol=1e-4)


def test_schmidl_cox_batched():
    """Batched rows under vmap equal the golden metric row by row."""
    L = 32
    spec = _spec_for(L)
    gp = G.GoldenOfdmParams(fft_len=2 * L, cp_len=L // 2, modulation="qpsk")
    rng = np.random.RandomState(4)
    r = (rng.randn(3, 2048) + 1j * rng.randn(3, 2048)).astype(np.complex64)
    m = jax.jit(jax.vmap(lambda x: ksync.schmidl_cox(spec, x)))(
        jnp.asarray(r))
    assert m.corr.shape == (3, 2048 - 2 * L + 1)
    for i in range(3):
        _, gP = G.schmidl_cox_metric(gp, r[i].astype(np.complex128))
        np.testing.assert_allclose(np.asarray(m.corr[i])[:len(gP)], gP,
                                   rtol=1e-4, atol=1e-4)


def test_coarse_sliding_max_dominates_exact():
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(10000).astype(np.float32))
    w = 161
    exact = ksync.sliding_max_same(x, w, pad_left=w // 2)
    coarse = ksync.coarse_sliding_max_same(x, w)
    # the coarse window CONTAINS the exact one -> coarse >= exact everywhere
    assert bool(jnp.all(coarse >= exact - 1e-6))
    # and it is tight at block granularity: every coarse value is an actual
    # sample value from within w + 3*128 samples
    assert bool(jnp.all(coarse <= jnp.max(x)))
