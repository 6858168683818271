"""FIR design (firdes) + polyphase interpolation/resampling tests.

Oracles are closed-form: designed filters are checked against their own
frequency-response spec (passband gain, stopband attenuation, cutoff
rolloff), and the streaming polyphase blocks against the zero-stuff +
full-rate-convolve identity computed in numpy.
"""

import numpy as np
import pytest

from ofdm_jax.ops import firdes
from ofdm_jax.stream.block import (
    fir_filter,
    interpolating_fir,
    rational_resampler,
)
from ofdm_jax.stream.executor import StreamExecutor


def _mag_db(taps, fs, freqs):
    n = np.arange(len(taps))
    h = np.array(
        [np.sum(taps * np.exp(-2j * np.pi * f * n / fs)) for f in freqs]
    )
    return 20 * np.log10(np.maximum(np.abs(h), 1e-12))


def test_low_pass_response():
    fs, fc, tw = 1000.0, 100.0, 20.0
    taps = firdes.low_pass(2.0, fs, fc, tw, window="hamming")
    assert len(taps) % 2 == 1
    # DC gain exactly `gain`
    np.testing.assert_allclose(taps.sum(), 2.0, rtol=1e-6)
    # passband flat within 0.5 dB, stopband below -40 dB (hamming ~53 dB)
    pb = _mag_db(taps, fs, np.linspace(0, fc - tw, 20)) - 20 * np.log10(2.0)
    sb = _mag_db(taps, fs, np.linspace(fc + tw, fs / 2, 20)) - 20 * np.log10(2.0)
    assert np.all(np.abs(pb) < 0.5)
    assert np.all(sb < -40.0)


def test_high_pass_response():
    fs, fc, tw = 1000.0, 200.0, 25.0
    taps = firdes.high_pass(1.0, fs, fc, tw)
    # gain 1 at Nyquist, deep rejection at DC
    nyq = _mag_db(taps, fs, [fs / 2])[0]
    dc = _mag_db(taps, fs, [0.0])[0]
    assert abs(nyq) < 0.01
    assert dc < -40.0


def test_band_pass_response():
    fs = 1000.0
    taps = firdes.band_pass(1.0, fs, 150.0, 250.0, 20.0)
    center = _mag_db(taps, fs, [200.0])[0]
    stop = _mag_db(taps, fs, [50.0, 350.0])
    assert abs(center) < 0.05
    assert np.all(stop < -40.0)


def test_complex_band_pass_one_sided():
    fs = 1000.0
    taps = firdes.complex_band_pass(1.0, fs, -250.0, -150.0, 20.0)
    assert taps.dtype == np.complex64
    n = np.arange(len(taps))
    for f, lim in [(-200.0, None), (200.0, -40.0)]:
        h = abs(np.sum(taps * np.exp(-2j * np.pi * f * n / fs)))
        db = 20 * np.log10(max(h, 1e-12))
        if lim is None:
            assert abs(db) < 0.1  # passband at negative freqs
        else:
            assert db < lim      # mirror band rejected


def test_band_reject_response():
    fs = 1000.0
    taps = firdes.band_reject(1.0, fs, 150.0, 250.0, 20.0)
    notch = _mag_db(taps, fs, [200.0])[0]
    dc = _mag_db(taps, fs, [0.0])[0]
    assert notch < -35.0
    assert abs(dc) < 0.05


def test_rrc_is_nyquist_pulse():
    """rrc * rrc = raised cosine: zero ISI at symbol spacings."""
    sps = 4
    taps = firdes.root_raised_cosine(1.0, fs=4.0, symbol_rate=1.0,
                                     alpha=0.35, ntaps=81)
    rc = np.convolve(taps, taps)
    m = (len(rc) - 1) // 2
    peak = rc[m]
    isi = [rc[m + k * sps] for k in range(1, 8)]
    assert np.all(np.abs(isi) < 2e-3 * peak)


def test_gaussian_unit_dc():
    taps = firdes.gaussian(1.0, fs=8.0, symbol_rate=1.0, bt=0.35, ntaps=33)
    np.testing.assert_allclose(taps.sum(), 1.0, rtol=1e-6)


def test_compute_ntaps_scales_with_transition():
    n1 = firdes.compute_ntaps(1000.0, 50.0)
    n2 = firdes.compute_ntaps(1000.0, 25.0)
    assert n2 > n1 and n1 % 2 == 1 and n2 % 2 == 1


def _stream(block, x, block_size):
    ex = StreamExecutor(block, block_size, donate=False)
    outs = [np.asarray(o) for o in ex.run(x)]
    return np.concatenate(outs, axis=-1)


def test_interpolating_fir_matches_zero_stuff():
    rng = np.random.RandomState(0)
    L = 3
    taps = firdes.low_pass(float(L), L * 8.0, 3.0, 1.5, ntaps=25)
    x = (rng.randn(600) + 1j * rng.randn(600)).astype(np.complex64)
    y = _stream(interpolating_fir(taps, L), x, block_size=200)
    # oracle: zero-stuff then full-rate causal FIR
    xz = np.zeros(len(x) * L, dtype=np.complex64)
    xz[::L] = x
    want = np.convolve(xz, taps)[: len(xz)]
    assert y.shape == (len(x) * L,)
    np.testing.assert_allclose(y, want, atol=1e-4)


def test_rational_resampler_rate():
    rng = np.random.RandomState(1)
    taps = firdes.low_pass(2.0, 16.0, 3.0, 1.0, ntaps=31)
    x = (rng.randn(400) + 1j * rng.randn(400)).astype(np.complex64)
    y = _stream(rational_resampler(taps, interp=2, decim=4), x, block_size=100)
    assert y.shape == (len(x) * 2 // 4,)
    xz = np.zeros(len(x) * 2, dtype=np.complex64)
    xz[::2] = x
    want = np.convolve(xz, taps)[: len(xz)][::4]
    np.testing.assert_allclose(y, want, atol=1e-4)


def test_decimating_fir_matches_numpy():
    rng = np.random.RandomState(2)
    taps = firdes.low_pass(1.0, 8.0, 1.5, 0.75, ntaps=21)
    x = (rng.randn(512) + 1j * rng.randn(512)).astype(np.complex64)
    y = _stream(fir_filter(taps, decim=4), x, block_size=128)
    want = np.convolve(x, taps)[: len(x)][::4]
    np.testing.assert_allclose(y, want, atol=1e-4)


def test_long_fir_matmul_path():
    """K >= 33 takes the overlap-save frame-matmul core; must agree
    with numpy convolution and with the shifted-add core."""
    from ofdm_jax.stream.block import fir_ext
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    K = 97
    taps = firdes.low_pass(1.0, 8.0, 1.0, 0.5, ntaps=K)
    x = (rng.randn(1000) + 1j * rng.randn(1000)).astype(np.complex64)
    y = _stream(fir_filter(taps), x, block_size=250)
    want = np.convolve(x, taps)[: len(x)]
    np.testing.assert_allclose(y, want, atol=2e-4)
    # one-shot core, odd n_out (exercises frame padding)
    ext = np.concatenate([np.zeros(K - 1, np.complex64), x[:777]])
    got = np.asarray(fir_ext(jnp.asarray(ext), taps, 777))
    np.testing.assert_allclose(got, np.convolve(x[:777], taps)[:777], atol=2e-4)


def test_complex_taps_fir():
    rng = np.random.RandomState(4)
    taps = firdes.complex_band_pass(1.0, 8.0, 1.0, 3.0, 0.5, ntaps=41)
    x = (rng.randn(600) + 1j * rng.randn(600)).astype(np.complex64)
    y = _stream(fir_filter(taps), x, block_size=200)
    np.testing.assert_allclose(y, np.convolve(x, taps)[: len(x)], atol=2e-4)
