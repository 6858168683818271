"""GPU detect kernels (kernels/detect.py) vs the plain jnp row summaries,
in the Pallas interpreter on the CPU.

The compiled run lives in tests/test_gpu.py; this lane checks the kernels'
arithmetic -- difference-sequence window scans with the exact hi/lo split,
program halos, head and tail masks, the direct plateau-center picks -- in
plain CI where no card is present.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmConfig
from ofdm_jax.kernels import detect
from ofdm_jax.ops import sync
from golden.detect_ref import detect_rows_f64


def _rows_both(spec, x):
    L = spec.fft_len // 2
    got = detect.detect_rows(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()), L,
        spec.cp_len, interpret=True)
    ref = sync._detect_rows_jnp(spec, jnp.asarray(x))
    return ([np.asarray(g) for g in got], [np.asarray(r) for r in ref])


def _with_frames(spec, n, starts, seed, noise=0.02):
    from golden import golden_ofdm as G

    rng = np.random.RandomState(seed)
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64) * noise
    gp = G.GoldenOfdmParams(fft_len=spec.fft_len, cp_len=spec.cp_len,
                            modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(40))).astype(np.complex64)
    for p in starts:
        x[p:p + len(frame)] += frame
    return x


def _assert_rows_match(got, ref, rtol=1e-5):
    """smmax to `rtol` relative, same argmax, P/R picks to 1e-4 of the
    window's energy, rmax to `rtol` relative."""
    live = np.isfinite(ref[0])
    assert live.sum() >= live.size - 3     # only the head rows are empty
    np.testing.assert_array_equal(np.isfinite(got[0]), live)
    np.testing.assert_allclose(got[0][live], ref[0][live], rtol=rtol)
    np.testing.assert_array_equal(got[1], ref[1])
    scale = np.maximum(ref[4], 1e-30)
    for i in (2, 3, 4):
        assert (np.abs(got[i] - ref[i]) <= 1e-4 * scale).all(), i
    np.testing.assert_allclose(got[5], ref[5], rtol=rtol)


@pytest.mark.parametrize("fft_len,cp", [(64, 16), (256, 64)])
def test_sc_detect_rows_interpret_matches_jnp(fft_len, cp):
    spec = OfdmConfig(fft_len=fft_len, cp_len=cp, modulation="qpsk").spec
    # several programs of both kernels plus a ragged tail; frames at the
    # stream head, mid-block and near the end
    n = 3 * detect._BLOCK + 1000
    x = _with_frames(spec, n, [40, 5000, n - 2000], seed=5)
    got, ref = _rows_both(spec, x)
    _assert_rows_match(got, ref)
    # and both against float64 window sums
    _, f64 = detect_rows_f64(x, fft_len // 2, cp)
    _assert_rows_match(got, [np.asarray(v, np.float64) for v in f64])


def test_sc_detect_rows_interpret_selection_identical():
    """The selections induced by kernel rows and plain rows must agree
    exactly on injected frames (the property the RX chain relies on)."""
    spec = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    n = 3 * detect._BLOCK + 1000
    starts = [1000, 5500, 9000]
    x = _with_frames(spec, n, starts, seed=6)
    got, ref = _rows_both(spec, x)

    n_sm = n - spec.fft_len - spec.cp_len + 1
    sel_g = sync._select_from_rows(
        spec, *(jnp.asarray(z) for z in got), n_sm=n_sm, max_frames=8,
        threshold=spec.cfg.sync_threshold,
    )
    sel_r = sync._select_from_rows(
        spec, *(jnp.asarray(z) for z in ref), n_sm=n_sm, max_frames=8,
        threshold=spec.cfg.sync_threshold,
    )
    np.testing.assert_array_equal(np.asarray(sel_g.valid),
                                  np.asarray(sel_r.valid))
    v = np.asarray(sel_g.valid)
    assert v.sum() == len(starts)
    np.testing.assert_array_equal(np.asarray(sel_g.start)[v],
                                  np.asarray(sel_r.start)[v])
    np.testing.assert_allclose(np.asarray(sel_g.fine_cfo)[v],
                               np.asarray(sel_r.fine_cfo)[v], atol=1e-4)


def test_detect_rows_interpret_chunk_seams():
    """Frames whose windows straddle the kernels' program seams,
    and a tail 60 dB below them: the scans restart at every seam, and the
    exact split keeps the weak windows behind a strong frame right."""
    spec = OfdmConfig(fft_len=256, cp_len=64, modulation="qpsk").spec
    seam = detect._BLOCK - detect.halo_len(spec.fft_len // 2, spec.cp_len)
    n = 4 * detect._BLOCK
    x = _with_frames(spec, n, [seam - 150, 2 * seam - 300], seed=7)
    x[3 * seam - 500:] *= 1e-3              # quiet tail behind the frames
    got, _ = _rows_both(spec, x)
    _, f64 = detect_rows_f64(x, spec.fft_len // 2, spec.cp_len)
    # 1e-4: the f32 products themselves (conj(r[t-L]) r[t] across the
    # 60 dB step) limit any f32 path to ~1e-5 in the rows at the step
    _assert_rows_match(got, [np.asarray(v, np.float64) for v in f64],
                       rtol=1e-4)


def test_detect_rows_under_vmap():
    """The wideband RX vmaps rx_block over channels: the batched kernels
    must equal the per-row ones."""
    spec = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    n = detect._BLOCK + 700
    xs = np.stack([_with_frames(spec, n, [300], seed=s) for s in (8, 9)])
    L = spec.fft_len // 2
    got = jax.vmap(lambda a, b: detect.detect_rows(
        a, b, L, spec.cp_len, interpret=True))(
        jnp.asarray(xs.real.copy()), jnp.asarray(xs.imag.copy()))
    for b in range(2):
        ref = sync._detect_rows_jnp(spec, jnp.asarray(xs[b]))
        _assert_rows_match([np.asarray(g[b]) for g in got],
                           [np.asarray(r) for r in ref])
