"""Frame equalizers: LS zero-forcing + pilot phase tracking, and a
decision-feedback variant.

JAX equivalent of ofdm_frame_equalizer_vcvc with its
ofdm_equalizer_static / ofdm_equalizer_simpledfe policies (SURVEY.md §2b,
gr-digital/lib/ofdm_frame_equalizer_vcvc_impl.cc / ofdm_equalizer_simpledfe.cc,
unverified paths).

`equalize_pilot_phase` is fully parallel over OFDM symbols (one fused pass);
`equalize_simpledfe` is the sequential decision-directed tracker expressed as
a lax.scan over symbols (the per-symbol dependency is inherent to DFE).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmSpec
from ofdm_jax.ops.constellation import hard_decisions, points_np


def equalize_pilot_phase(
    spec: OfdmSpec, grids: jnp.ndarray, H: jnp.ndarray
) -> jnp.ndarray:
    """Zero-forcing by H, then per-symbol common-phase correction from pilots.

    grids: (..., n_syms, fft_len); H: (..., fft_len).
    Matches the golden model's equalize_frame.
    """
    Hs = jnp.where(jnp.abs(H) > 1e-9, H, 1.0 + 0j)
    eq = grids / Hs[..., None, :]
    pb = jnp.asarray(spec.pilot_bins)
    pil = jnp.asarray(spec.pilot_symbols)
    rot = jnp.sum(jnp.conj(pil) * eq[..., pb], axis=-1)  # (..., n_syms)
    mag = jnp.abs(rot)
    ph = jnp.where(mag > 1e-12, rot / jnp.maximum(mag, 1e-12), 1.0 + 0j)
    return (eq * jnp.conj(ph)[..., None]).astype(jnp.complex64)


def equalize_simpledfe(
    spec: OfdmSpec,
    grids: jnp.ndarray,
    H: jnp.ndarray,
    modulation: str | None = None,
    alpha: float = 0.1,
) -> jnp.ndarray:
    """Decision-feedback equalizer (cf. ofdm_equalizer_simpledfe): per OFDM
    symbol, equalize with the current channel estimate, slice to the nearest
    constellation point on data carriers (pilots use known symbols), and
    update H per carrier: H <- (1-alpha) H + alpha * (rx / decision).

    grids: (n_syms, fft_len); H: (fft_len,).  Sequential over symbols.
    """
    if modulation is None:
        modulation = spec.modulation
    pts = jnp.asarray(points_np(modulation))
    db = jnp.asarray(spec.data_bins)
    pb = jnp.asarray(spec.pilot_bins)
    pil = jnp.asarray(spec.pilot_symbols)

    def step(Hc, sym):
        Hs = jnp.where(jnp.abs(Hc) > 1e-9, Hc, 1.0 + 0j)
        eq = sym / Hs
        # common phase from pilots first
        rot = jnp.sum(jnp.conj(pil) * eq[pb])
        mag = jnp.abs(rot)
        ph = jnp.where(mag > 1e-12, rot / jnp.maximum(mag, 1e-12), 1.0 + 0j)
        eq = eq * jnp.conj(ph)
        # decisions: data bins -> nearest point; pilot bins -> known pilots
        dec_data = pts[hard_decisions(eq[db], modulation)]
        decisions = jnp.zeros_like(sym).at[db].set(dec_data).at[pb].set(pil)
        active = jnp.zeros(sym.shape, dtype=bool).at[db].set(True).at[pb].set(True)
        ratio = sym * ph.conj() / jnp.where(jnp.abs(decisions) > 1e-9, decisions, 1.0)
        Hn = jnp.where(active, (1 - alpha) * Hc + alpha * ratio, Hc)
        return Hn.astype(jnp.complex64), eq.astype(jnp.complex64)

    _, out = jax.lax.scan(step, H.astype(jnp.complex64), grids)
    return out
