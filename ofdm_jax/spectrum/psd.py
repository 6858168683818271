"""PSD probe: the logpwrfft chain as one fused jitted op + streaming Block.

JAX equivalent of the reference's spectrum-probe path (SURVEY.md
§2b "logpwrfft PSD chain" / §3.4: gr-fft/python/fft/logpwrfft.py, unverified
path): stream_to_vector -> window+FFT -> |.|^2/norm -> nlog10 -> single-pole
IIR averaging.  The reference runs this as five thread-coupled blocks; here
it is a handful of fused XLA ops over a whole time-block of frames at once,
with the FFT as batched matmuls (kernels.fft).

Normalization matches the golden model (tests/golden/golden_ofdm.log_pwr_fft):
power divided by sum(w^2) * fft_len.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ofdm_jax.kernels.fft import fft
from ofdm_jax.spectrum import window as win
from ofdm_jax.stream.block import Block


def psd_frames(
    x: jnp.ndarray, fft_len: int, window: str = "hann"
) -> jnp.ndarray:
    """(..., n) samples -> (..., n//fft_len, fft_len) linear-power PSD frames."""
    n = x.shape[-1] // fft_len
    frames = x[..., : n * fft_len].reshape(*x.shape[:-1], n, fft_len)
    w = jnp.asarray(win.get(window, fft_len))
    wf = fft(frames * w)
    norm = float(np.sum(win.get(window, fft_len).astype(np.float64) ** 2) * fft_len)
    return (jnp.abs(wf) ** 2) / norm


def iir_average(pwr: jnp.ndarray, alpha: float, y0: jnp.ndarray | None = None):
    """Single-pole IIR across the frame axis (axis -2):
    y[i] = alpha*p[i] + (1-alpha)*y[i-1], y[-1] = y0 (default p[0], matching
    the golden model's warm start).  Associative-scan form, O(log n) depth.
    Returns (averaged_frames, last_frame)."""
    if alpha >= 1.0:
        return pwr, pwr[..., -1, :]
    if y0 is None:
        y0 = pwr[..., 0, :]
    r = jnp.float32(1.0 - alpha)
    m = jnp.full(pwr.shape[:-1], r)[..., None]          # (..., n, 1)
    b = alpha * pwr

    def combine(l, rr):
        ml, bl = l
        mr, br = rr
        return ml * mr, bl * mr + br

    mm, bb = jax.lax.associative_scan(combine, (m, b), axis=-2)
    y = mm * y0[..., None, :] + bb
    return y, y[..., -1, :]


def log_pwr_fft(
    x: jnp.ndarray,
    fft_len: int,
    avg_alpha: float = 1.0,
    window: str = "hann",
    floor: float = 1e-20,
) -> jnp.ndarray:
    """One-shot PSD in dB over a sample buffer; golden-model compatible."""
    pwr = psd_frames(x, fft_len, window)
    avg, _ = iir_average(pwr, avg_alpha)
    return 10.0 * jnp.log10(jnp.maximum(avg, floor))


def log_pwr_fft_block(
    fft_len: int,
    avg_alpha: float = 1.0,
    window: str = "hann",
    floor: float = 1e-20,
) -> Block:
    """Streaming logpwrfft: carries the IIR state across time-blocks (the
    reference's single_pole_iir_filter_ff state).  Block size must be a
    multiple of fft_len.  Emits (n_frames, fft_len) dB frames per step."""

    def init():
        # IIR state: (warmed_up_flag as float, last averaged frame)
        return (
            np.zeros((), dtype=np.float32),
            np.zeros(fft_len, dtype=np.float32),
        )

    def apply(state, x):
        warm, y_last = state
        pwr = psd_frames(x, fft_len, window)
        # warm start: first ever frame seeds the IIR (golden semantics)
        y0 = jnp.where(warm > 0, y_last, pwr[..., 0, :])
        avg, y_new = iir_average(pwr, avg_alpha, y0=y0)
        out = 10.0 * jnp.log10(jnp.maximum(avg, floor))
        return (jnp.ones((), jnp.float32), y_new), out

    return Block(init, apply, f"logpwrfft({fft_len})")
