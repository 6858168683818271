"""Schmidl-Cox fine-CFO estimator statistics vs published theory.

VERDICT r1 item 8 / SURVEY.md §4 oracle plan (c): with no reference
executable, the CFO estimator is validated against the PUBLISHED variance
of the repeated-halves correlation estimator (Moose 1994, eq. 12; the same
correlator S&C 1997 use for the fractional CFO, and the baseline every
training-sequence scheme -- e.g. PAPERS.md arXiv 1703.07089 -- compares
against):

    P = sum_{m<L} conj(r[d+m]) r[d+m+L],   eps_hat = angle(P) / pi

At per-sample SNR rho and plateau readout, the high-SNR approximation of
the estimator variance in SUBCARRIER units (N = 2L) is

    var(eps_hat) ~= (1 / (pi^2 L)) * (1/rho + 1/(2 rho^2))

(derivation: the noise component of P orthogonal to the signal phasor has
variance L(Es sigma^2 + sigma^4/2); |P_signal| = L Es; var(angle) is their
ratio; divide by pi^2 for subcarrier units.  The first term is the CRB of
the two-halves problem, the 1/(2 rho^2) term the noise-x-noise correction.)

Monte-Carlo over AWGN draws must land inside a tolerance band around the
formula at every SNR point -- at a KNOWN readout position to isolate the
estimator from detection timing jitter, then through the full detect_frames
pipeline with a looser bound (timing jitter adds variance).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmConfig
from ofdm_jax.ops import sync

import tests.golden.golden_ofdm as G


def _theory_var(L: int, rho: float) -> float:
    return (1.0 / (np.pi**2 * L)) * (1.0 / rho + 1.0 / (2.0 * rho**2))


@pytest.fixture(scope="module")
def setup():
    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")
    spec = cfg.spec
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(32))).astype(np.complex64)
    return cfg, spec, frame


def _trials(spec, frame, snr_db, cfo, n_trials, seed, n=6144, p0=1024):
    """n_trials noisy captures, one frame at p0, CFO applied; returns
    (captures, rho, readout_d) where readout_d indexes SyncMetric.corr at
    the start of sync word 1's FFT window (the plateau)."""
    rng = np.random.RandomState(seed)
    ph = np.exp(2j * np.pi * cfo * np.arange(len(frame)) / spec.fft_len)
    sig = np.zeros(n, np.complex64)
    sig[p0 : p0 + len(frame)] = (frame * ph).astype(np.complex64)
    # per-sample SNR defined on the sync-symbol power (what P integrates)
    d = p0 + spec.cp_len
    es = float(np.mean(np.abs(sig[d : d + spec.fft_len]) ** 2))
    sigma2 = es / (10 ** (snr_db / 10))
    noise = (
        rng.randn(n_trials, n) + 1j * rng.randn(n_trials, n)
    ) * np.sqrt(sigma2 / 2)
    r = (sig[None, :] + noise).astype(np.complex64)
    return r, es / sigma2, d


@pytest.mark.parametrize("snr_db", [3.0, 10.0, 20.0])
def test_fine_cfo_variance_matches_moose_formula(setup, snr_db):
    cfg, spec, frame = setup
    L = spec.fft_len // 2
    cfo = 0.2
    n_trials = 384
    r, rho, d = _trials(spec, frame, snr_db, cfo, n_trials, seed=int(snr_db))

    sm = jax.jit(lambda x: sync.schmidl_cox(spec, x))(jnp.asarray(r))
    P = np.asarray(sm.corr)[:, d]           # correlator at the known plateau
    est = np.angle(P) / np.pi               # subcarrier units
    err = est - cfo
    assert abs(err.mean()) < 4 * err.std() / np.sqrt(n_trials) + 1e-3, (
        "estimator is biased"
    )
    var = float(np.var(err))
    want = _theory_var(L, rho)
    # 384 trials -> var estimate rel. std ~ sqrt(2/384) = 7.2%; allow a
    # generous band for the high-SNR approximation itself
    assert 0.6 * want < var < 1.8 * want, (snr_db, var, want, var / want)


def test_fine_cfo_variance_decreases_with_snr(setup):
    cfg, spec, frame = setup
    out = []
    for snr_db in [3.0, 10.0, 20.0]:
        r, rho, d = _trials(spec, frame, snr_db, 0.2, 256, seed=7)
        sm = jax.jit(lambda x: sync.schmidl_cox(spec, x))(jnp.asarray(r))
        est = np.angle(np.asarray(sm.corr)[:, d]) / np.pi
        out.append(float(np.var(est - 0.2)))
    assert out[0] > out[1] > out[2]


def test_full_pipeline_cfo_variance_near_theory(setup):
    """detect_frames' fine_cfo (readout at the DETECTED plateau center):
    variance within a loose band of theory -- timing jitter and CP-window
    averaging add variance but must not blow it up."""
    cfg, spec, frame = setup
    L = spec.fft_len // 2
    snr_db, cfo = 10.0, 0.17
    n_trials = 192
    r, rho, d = _trials(spec, frame, snr_db, cfo, n_trials, seed=23)

    det = jax.jit(
        jax.vmap(lambda x: sync.detect_frames(spec, x, max_frames=2))
    )(jnp.asarray(r))
    valid = np.asarray(det.valid)
    assert valid[:, 0].mean() > 0.99          # every trial detects the frame
    est = np.asarray(det.fine_cfo)[:, 0][valid[:, 0]]
    err = est - cfo
    var = float(np.var(err))
    want = _theory_var(L, rho)
    assert var < 4.0 * want, (var, want)
    assert abs(err.mean()) < 0.01
