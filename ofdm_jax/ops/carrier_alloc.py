"""Subcarrier allocation / serialization.

JAX equivalent of ofdm_carrier_allocator_cvc (TX side: data symbols +
pilots + sync words -> fft_len frequency grids) and ofdm_serializer_vcvc
(RX side: grids -> flat data-carrier symbol stream) -- SURVEY.md §2b,
gr-digital/lib/ofdm_carrier_allocator_cvc_impl.cc /
ofdm_serializer_vcvc_impl.cc (unverified paths).

The reference walks carriers with per-item C++ loops driven by tagged-stream
lengths; here allocation is a static scatter into a (n_syms, fft_len) grid
and serialization a static gather -- both fuse into the surrounding FFT under
XLA.  Variable packet lengths are handled by fixed-capacity grids + masks
(SURVEY.md §7 design decision 2: tags -> static metadata).
"""

from __future__ import annotations

import jax.numpy as jnp

from ofdm_jax.config import OfdmSpec


def allocate(spec: OfdmSpec, data_syms: jnp.ndarray) -> jnp.ndarray:
    """Data symbols (..., n_syms*n_data) -> freq grids (..., n_syms, fft_len).

    Input length must be a multiple of n_data (pad upstream with zeros).
    Pilots inserted at pilot bins; all other non-data bins stay zero.
    """
    nd = spec.n_data
    n_syms = data_syms.shape[-1] // nd
    lead = data_syms.shape[:-1]
    d = data_syms.reshape(*lead, n_syms, nd)
    grid = jnp.zeros((*lead, n_syms, spec.fft_len), dtype=jnp.complex64)
    grid = grid.at[..., jnp.asarray(spec.data_bins)].set(d)
    pil = jnp.broadcast_to(
        jnp.asarray(spec.pilot_symbols), (*lead, n_syms, len(spec.pilot_bins))
    )
    grid = grid.at[..., jnp.asarray(spec.pilot_bins)].set(pil)
    return grid


def serialize(spec: OfdmSpec, grids: jnp.ndarray) -> jnp.ndarray:
    """Freq grids (..., n_syms, fft_len) -> data symbols (..., n_syms*n_data),
    dropping pilots and unoccupied carriers (cf. ofdm_serializer_vcvc)."""
    d = grids[..., jnp.asarray(spec.data_bins)]
    return d.reshape(*grids.shape[:-2], grids.shape[-2] * spec.n_data)


def sync_grids(spec: OfdmSpec, batch_shape=()) -> jnp.ndarray:
    """The two sync-word grids (..., 2, fft_len), broadcast to batch_shape."""
    sw = jnp.stack(
        [jnp.asarray(spec.sync_word1_freq), jnp.asarray(spec.sync_word2_freq)]
    )
    return jnp.broadcast_to(sw, (*batch_shape, 2, spec.fft_len))
