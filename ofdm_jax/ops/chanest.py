"""Coarse integer-CFO estimation + LS channel estimation.

JAX equivalent of ofdm_chanest_vcvc (SURVEY.md §2b,
gr-digital/lib/ofdm_chanest_vcvc_impl.cc, unverified path): uses the two
Schmidl-Cox sync words to (a) resolve the integer part of the carrier
frequency offset by correlating the received sync word 1 magnitude pattern
against bin-shifted copies of the known pattern, and (b) least-squares
estimate the per-carrier channel from sync word 2.

The shift search is a tiny (2K+1, fft_len) x (fft_len,) matmul over
trace-time-constant rolled references instead of the reference's per-shift
C++ loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ofdm_jax.config import OfdmSpec


@functools.lru_cache(maxsize=64)
def _rolled_refs_np(spec: OfdmSpec, max_shift: int) -> np.ndarray:
    ref = np.abs(spec.sync_word1_freq)
    return np.stack(
        [np.roll(ref, s) for s in range(-max_shift, max_shift + 1)]
    ).astype(np.float32)


def coarse_int_cfo(
    spec: OfdmSpec, sync1_fd: jnp.ndarray, max_shift: int | None = None
) -> jnp.ndarray:
    """Integer CFO in bins from the received sync word 1 spectrum (..., N).

    Positive result means the RX spectrum is shifted UP by that many bins;
    compensate with roll(rx, -ic).
    """
    if max_shift is None:
        max_shift = spec.cfg.max_int_cfo
    refs = jnp.asarray(_rolled_refs_np(spec, max_shift))  # (2K+1, N)
    # HIGHEST: a TF32 product could reorder near-equal scores on the GPU
    scores = jnp.einsum("...n,kn->...k", jnp.abs(sync1_fd), refs,
                        precision=jax.lax.Precision.HIGHEST)
    best = jnp.argmax(scores, axis=-1).astype(jnp.int32)
    return best - max_shift


def roll_bins(grid: jnp.ndarray, shift: jnp.ndarray) -> jnp.ndarray:
    """Dynamic circular roll along the last (fft bin) axis by a traced
    per-example shift (compensates integer CFO)."""
    n = grid.shape[-1]
    idx = (jnp.arange(n) + shift) % n
    return jnp.take(grid, idx, axis=-1)


def ls_estimate(spec: OfdmSpec, sync2_fd: jnp.ndarray) -> jnp.ndarray:
    """LS channel estimate from sync word 2 (..., fft_len) -> (..., fft_len).

    Occupied bins: H = Y/X.  Unoccupied bins: 1.0 (neutral under division;
    they carry no data and are never serialized out).
    """
    bins = jnp.asarray(spec.occupied_bins)
    x = jnp.asarray(spec.sync_word2_freq)[bins]
    h_occ = sync2_fd[..., bins] / x
    H = jnp.ones(sync2_fd.shape, dtype=jnp.complex64)
    return H.at[..., bins].set(h_occ.astype(jnp.complex64))
