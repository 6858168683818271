"""FFT/IFFT + cyclic prefix ops.

JAX equivalent of fft_vcc (gr-fft/lib/fft_vcc_fftw.cc: FFTW wrapper
applied per fft_len vector) and ofdm_cyclic_prefixer
(gr-digital/lib/ofdm_cyclic_prefixer_impl.cc) -- SURVEY.md §2b (unverified
paths).

Design notes (SURVEY.md §7 decision 4): these ops always operate on
(batch..., n_syms, fft_len) stacks, never one symbol at a time like the
reference's per-vector work() calls, and use the matmul-DFT kernel
(kernels.fft) rather than jnp.fft (cuFFT on the GPU; which is faster at
these sizes is not measured yet).
Normalization is unitary-style: ifft * sqrt(N) on TX, fft / sqrt(N) on RX
(matching the golden model).
"""

from __future__ import annotations

import jax.numpy as jnp

from ofdm_jax.config import OfdmSpec
from ofdm_jax.kernels import fft as kfft


def ofdm_ifft(grids: jnp.ndarray) -> jnp.ndarray:
    """Freq grids (..., fft_len) -> time-domain symbols, scaled by sqrt(N)."""
    n = grids.shape[-1]
    return (kfft.ifft(grids) * jnp.sqrt(float(n))).astype(jnp.complex64)


def ofdm_fft(symbols: jnp.ndarray) -> jnp.ndarray:
    """Time-domain symbols (..., fft_len) -> freq grids, scaled by 1/sqrt(N)."""
    n = symbols.shape[-1]
    return (kfft.fft(symbols) / jnp.sqrt(float(n))).astype(jnp.complex64)


def add_cyclic_prefix(spec: OfdmSpec, td_syms: jnp.ndarray) -> jnp.ndarray:
    """(..., n_syms, fft_len) -> (..., n_syms*(fft_len+cp_len)) serialized
    samples with CP prepended per symbol.

    With spec.rolloff_len = r > 0, adjacent symbols are pulse-shaped with a
    raised-cosine flank (cf. ofdm_cyclic_prefixer's rolloff,
    gr-digital/lib/ofdm_cyclic_prefixer_impl.cc, unverified path): the first
    r samples of each symbol's CP ramp up while the previous symbol's
    cyclic tail (the first r samples of its FFT body, which cyclically
    continue its end) ramps down into them, smoothing the spectral skirts.
    The flanks sum to 1, live entirely inside the CP (r <= cp_len), and the
    serialized frame length is unchanged, so the RX CP-drop path is
    untouched.  The first symbol ramps up from zero; the final tail is
    truncated (static shapes)."""
    cp = td_syms[..., -spec.cp_len:]
    with_cp = jnp.concatenate([cp, td_syms], axis=-1)
    r = spec.rolloff_len
    if r > 0:
        import numpy as np

        i = np.arange(1, r + 1, dtype=np.float32)
        up = jnp.asarray(0.5 * (1.0 - np.cos(np.pi * i / (r + 1))))
        # cyclic tail of each symbol = first r samples of its FFT body
        tails = td_syms[..., :r] * (1.0 - up)
        prev_tails = jnp.concatenate(
            [jnp.zeros_like(tails[..., :1, :]), tails[..., :-1, :]], axis=-2
        )
        flank = with_cp[..., :r] * up + prev_tails
        with_cp = jnp.concatenate([flank, with_cp[..., r:]], axis=-1)
    return with_cp.reshape(*td_syms.shape[:-2], -1)


def remove_cyclic_prefix(spec: OfdmSpec, samples: jnp.ndarray, n_syms: int) -> jnp.ndarray:
    """Serialized samples (..., n_syms*sym_len) -> (..., n_syms, fft_len),
    dropping each symbol's CP."""
    s = samples[..., : n_syms * spec.sym_len].reshape(
        *samples.shape[:-1], n_syms, spec.sym_len
    )
    return s[..., spec.cp_len:]


def window_taps(kind: str, n: int) -> jnp.ndarray:
    """Window functions (cf. gr-fft/lib/window.cc: Hann/Hamming/Blackman-
    Harris/Kaiser used by fft_vcc + logpwrfft)."""
    import numpy as np

    t = np.arange(n)
    if kind in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * t / n)
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * t / n)
    elif kind == "blackman_harris":
        a = [0.35875, 0.48829, 0.14128, 0.01168]
        x = 2 * np.pi * t / (n - 1)
        w = a[0] - a[1] * np.cos(x) + a[2] * np.cos(2 * x) - a[3] * np.cos(3 * x)
    elif kind == "rect":
        w = np.ones(n)
    elif kind.startswith("kaiser"):
        beta = float(kind.split(":")[1]) if ":" in kind else 8.6
        w = np.kaiser(n, beta)
    else:
        raise ValueError(f"unknown window {kind!r}")
    return jnp.asarray(w, dtype=jnp.float32)
