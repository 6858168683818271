"""Constellation objects: Gray maps, hard and soft (max-log LLR) demapping.

JAX equivalent of the reference's digital::constellation_* objects +
chunks_to_symbols (map) + constellation_decoder_cb (hard demap)
(SURVEY.md §2b "Constellations & (de)mapping",
gr-digital/lib/constellation.cc, unverified path).  The VOLK-vectorized
min-distance search becomes a dense (n_syms, n_points) distance computation
that XLA fuses and vectorizes; soft demapping is max-log LLR,
which the reference chain lacks but BASELINE.json config 3 requires.

Bit conventions match tests/golden/golden_ofdm.py exactly: symbol value =
stream-order bits, MSB first; unit average power.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ofdm_jax.config import BITS_PER_SYMBOL
from ofdm_jax.utils.bits import group_bits, ungroup_bits

_GRAY_2 = np.array([-1.0, 1.0])
_GRAY_4 = np.array([-3.0, -1.0, 3.0, 1.0])
_GRAY_8 = np.array([-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0])


@functools.lru_cache(maxsize=None)
def points_np(modulation: str) -> np.ndarray:
    """2**k constellation points indexed by MSB-first symbol value."""
    if modulation == "bpsk":
        return _GRAY_2.astype(np.complex64)
    if modulation == "qpsk":
        i = _GRAY_2[np.arange(4) >> 1]
        q = _GRAY_2[np.arange(4) & 1]
        return ((i + 1j * q) / np.sqrt(2.0)).astype(np.complex64)
    if modulation == "qam16":
        idx = np.arange(16)
        i = _GRAY_4[(idx >> 2) & 0x3]
        q = _GRAY_4[idx & 0x3]
        return ((i + 1j * q) / np.sqrt(10.0)).astype(np.complex64)
    if modulation == "qam64":
        idx = np.arange(64)
        i = _GRAY_8[(idx >> 3) & 0x7]
        q = _GRAY_8[idx & 0x7]
        return ((i + 1j * q) / np.sqrt(42.0)).astype(np.complex64)
    raise ValueError(f"unknown modulation {modulation!r}")


@functools.lru_cache(maxsize=None)
def bit_masks_np(modulation: str) -> np.ndarray:
    """(k, n_points) boolean: bit b of point index is 1."""
    k = BITS_PER_SYMBOL[modulation]
    idx = np.arange(2**k)
    return np.stack([((idx >> (k - 1 - b)) & 1).astype(bool) for b in range(k)])


def map_bits(bits: jnp.ndarray, modulation: str) -> jnp.ndarray:
    """Bit array (..., n*k) -> complex symbols (..., n).  Length must be a
    multiple of k (pad upstream)."""
    k = BITS_PER_SYMBOL[modulation]
    vals = group_bits(bits, k)
    return jnp.asarray(points_np(modulation))[vals]


def hard_decisions(symbols: jnp.ndarray, modulation: str) -> jnp.ndarray:
    """Min-distance point indices (..., n) -> uint32 symbol values."""
    pts = jnp.asarray(points_np(modulation))
    d2 = jnp.abs(symbols[..., None] - pts) ** 2
    return jnp.argmin(d2, axis=-1).astype(jnp.uint32)


def demap_hard(symbols: jnp.ndarray, modulation: str) -> jnp.ndarray:
    """Symbols (..., n) -> bits (..., n*k), stream order."""
    k = BITS_PER_SYMBOL[modulation]
    return ungroup_bits(hard_decisions(symbols, modulation), k)


def demap_soft(
    symbols: jnp.ndarray, modulation: str, noise_var: jnp.ndarray | float = 1.0
) -> jnp.ndarray:
    """Max-log LLRs (..., n*k).  Positive LLR => bit 0 more likely
    (LLR = log P(b=0) - log P(b=1)), the conventional sign for decoders."""
    k = BITS_PER_SYMBOL[modulation]
    pts = jnp.asarray(points_np(modulation))
    masks = jnp.asarray(bit_masks_np(modulation))  # (k, P) bool
    d2 = jnp.abs(symbols[..., None] - pts) ** 2  # (..., n, P)
    big = jnp.inf
    # (..., n, k): min over points with bit=0 / bit=1
    d0 = jnp.min(jnp.where(masks[None, :, :], big, d2[..., None, :]), axis=-1)
    d1 = jnp.min(jnp.where(masks[None, :, :], d2[..., None, :], big), axis=-1)
    llr = (d1 - d0) / jnp.maximum(noise_var, 1e-12)
    return llr.reshape(*symbols.shape[:-1], symbols.shape[-1] * k)


def evm(symbols: jnp.ndarray, modulation: str, mask=None) -> jnp.ndarray:
    """RMS error-vector magnitude vs hard decisions."""
    pts = jnp.asarray(points_np(modulation))
    hard = pts[hard_decisions(symbols, modulation)]
    err = jnp.abs(symbols - hard) ** 2
    if mask is not None:
        err = jnp.where(mask, err, 0.0)
        denom = jnp.maximum(mask.sum(), 1)
    else:
        denom = symbols.size
    return jnp.sqrt(err.sum() / denom)
