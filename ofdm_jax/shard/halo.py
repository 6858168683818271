"""Overlap-save halo exchange across time shards (ring ppermute).

JAX equivalent of the reference's `set_history()` overlap-save --
which GNU Radio provides only WITHIN one host's circular buffers
(gnuradio-runtime/lib/block.cc set_history, SURVEY.md §2b/§5 "Long-context
/ sequence scaling") -- extended across shard boundaries: each time shard
fetches the trailing `halo` samples of its LEFT neighbor with a single
`lax.ppermute` ring step (the ring-attention communication shape, minus
attention; SURVEY.md §2c SP/CP row).

Shard 0 receives zeros (ppermute's semantics for destinations no source
maps to), which matches stream start: the capture is preceded by silence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ofdm_jax.shard.mesh import TIME_AXIS


def halo_from_left(x: jnp.ndarray, halo: int, axis_name: str = TIME_AXIS):
    """Inside shard_map: return the trailing `halo` samples (last axis) of the
    left time-neighbor's local block; zeros on the first shard."""
    n = jax.lax.axis_size(axis_name)
    tail = x[..., -halo:]
    if n == 1:
        return jnp.zeros_like(tail)
    perm = [(i, i + 1) for i in range(n - 1)]  # i sends to i+1; shard 0 gets 0s
    return jax.lax.ppermute(tail, axis_name, perm)


def halo_from_right(x: jnp.ndarray, halo: int, axis_name: str = TIME_AXIS):
    """Inside shard_map: leading `halo` samples of the right time-neighbor's
    block; zeros on the last shard (lookahead halo)."""
    n = jax.lax.axis_size(axis_name)
    head = x[..., :halo]
    if n == 1:
        return jnp.zeros_like(head)
    perm = [(i + 1, i) for i in range(n - 1)]
    return jax.lax.ppermute(head, axis_name, perm)


def extend_with_left_halo(x: jnp.ndarray, halo: int, axis_name: str = TIME_AXIS):
    """[left-neighbor tail | local block] along the last axis."""
    return jnp.concatenate([halo_from_left(x, halo, axis_name), x], axis=-1)
