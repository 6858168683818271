"""Spectrum path vs the frozen golden model (SURVEY.md §3.4 logpwrfft chain,
§2b pfb_channelizer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.golden import golden_ofdm as G
from ofdm_jax.spectrum import (
    channelize,
    channelizer_block,
    log_pwr_fft,
    log_pwr_fft_block,
    lowpass_taps,
    render_ascii,
    spectrum_probe_block,
    waterfall_block,
)
from ofdm_jax.stream.executor import StreamExecutor


def _sig(n, seed=0, tones=((0.1, 1.0), (0.27, 0.3))):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = sum(a * np.exp(2j * np.pi * f * t) for f, a in tones)
    x = x + (rng.randn(n) + 1j * rng.randn(n)) * 0.01
    return x.astype(np.complex64)


class TestLogPwrFft:
    def test_matches_golden_no_avg(self):
        x = _sig(4096)
        got = np.asarray(jax.jit(lambda v: log_pwr_fft(v, 256))(x))
        want = G.log_pwr_fft(x.astype(np.complex128), 256)
        np.testing.assert_allclose(got, want, atol=0.1)

    def test_matches_golden_iir(self):
        x = _sig(8192, seed=1)
        got = np.asarray(jax.jit(lambda v: log_pwr_fft(v, 128, avg_alpha=0.2))(x))
        want = G.log_pwr_fft(x.astype(np.complex128), 128, avg_alpha=0.2)
        np.testing.assert_allclose(got, want, atol=0.1)

    def test_streaming_matches_oneshot(self):
        """IIR state carried across blocks == one-shot over the whole buffer."""
        x = _sig(16384, seed=2)
        blk = log_pwr_fft_block(256, avg_alpha=0.3)
        ex = StreamExecutor(blk, 4096, donate=False)
        outs = [np.asarray(o) for o in ex.run(x, drain=True)]
        got = np.concatenate(outs, axis=0)
        want = np.asarray(jax.jit(lambda v: log_pwr_fft(v, 256, avg_alpha=0.3))(x))
        np.testing.assert_allclose(got, want, atol=0.1)

    def test_tone_bin(self):
        x = _sig(4096, tones=((32 / 256, 1.0),))
        psd = np.asarray(jax.jit(lambda v: log_pwr_fft(v, 256))(x))
        assert np.argmax(psd.mean(axis=0)) == 32


class TestProbe:
    def test_avg_max_min(self):
        x = _sig(8192, seed=3)
        blk = spectrum_probe_block(256)
        ex = StreamExecutor(blk, 2048, donate=False)
        outs = ex.run(x, drain=True)
        last = jax.tree.map(np.asarray, outs[-1])
        assert int(last.n_frames) == 8192 // 256
        # max >= avg >= min everywhere
        assert np.all(last.max_db >= last.avg_db - 1e-4)
        assert np.all(last.avg_db >= last.min_db - 1e-4)
        # the tone bin dominates
        assert np.argmax(last.avg_db) == round(0.1 * 256)


class TestWaterfall:
    def test_ring_and_render(self):
        x = _sig(65536, seed=4)
        blk = waterfall_block(128, depth=32)
        ex = StreamExecutor(blk, 8192, donate=False)
        outs = ex.run(x, drain=True)
        ring = np.asarray(outs[-1])
        assert ring.shape == (32, 128)
        assert np.all(np.isfinite(ring))
        art = render_ascii(ring, width=64)
        lines = art.split("\n")
        assert len(lines) == 32 and all(len(l) == 64 for l in lines)
        # tone at +0.1 fs -> right of center after fftshift; bright column
        col = np.argmax(ring.mean(axis=0))
        assert col == 128 // 2 + round(0.1 * 128)


class TestChannelizer:
    @pytest.mark.parametrize("n_chan", [4, 16, 64])
    def test_matches_golden(self, n_chan):
        x = _sig(n_chan * 128, seed=5)
        taps = lowpass_taps(n_chan, taps_per_arm=8)
        got = np.asarray(jax.jit(lambda v: channelize(v, n_chan, taps))(x))
        want = G.pfb_channelize(x.astype(np.complex128), n_chan, taps.astype(np.float64))
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())

    def test_streaming_matches_oneshot(self):
        n_chan = 8
        x = _sig(8 * 512, seed=6)
        taps = lowpass_taps(n_chan)
        blk = channelizer_block(n_chan, taps)
        ex = StreamExecutor(blk, 8 * 128, donate=False)
        outs = [np.asarray(o) for o in ex.run(x, drain=True)]
        got = np.concatenate(outs, axis=0)
        want = np.asarray(jax.jit(lambda v: channelize(v, n_chan, taps))(x))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_tone_lands_in_right_channel(self):
        """A tone at k*fs/N appears (near-flat) in channel k."""
        n_chan = 16
        k = 5
        t = np.arange(n_chan * 256)
        x = np.exp(2j * np.pi * k / n_chan * t).astype(np.complex64)
        y = np.asarray(
            jax.jit(lambda v: channelize(v, n_chan, lowpass_taps(n_chan)))(x)
        )
        pwr = np.mean(np.abs(y) ** 2, axis=0)
        assert np.argmax(pwr) == k
        # dominant channel carries ~all the power
        assert pwr[k] > 50 * (np.sum(pwr) - pwr[k]) / (n_chan - 1)
