"""Device-mesh construction for channel x time sharding.

JAX replacement for the reference's process/host topology (SURVEY.md
§2c): where gr-ofdm_tools scales by running N independent flowgraphs and
shipping PSD vectors over UDP sockets (python/local_worker.py ->
remote_client.py, unverified paths), this framework lays a
`jax.sharding.Mesh` over the chips of a pod slice with two axes:

  * ``channel`` -- data parallelism over channelizer outputs / independent
    streams (the reference's "N demod chains after pfb_channelizer_ccf").
  * ``time``    -- sequence parallelism over a long capture, with
    overlap-save halos exchanged via ppermute (shard.halo).

Collectives ride ICI within a slice and DCN across hosts; XLA inserts them
from the shardings (scaling-book recipe: pick a mesh, annotate, let XLA
place collectives).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def make_mesh(
    n_channel: int | None = None,
    n_time: int = 1,
    devices=None,
) -> Mesh:
    """Build a (channel, time) mesh over `devices` (default: all).

    If n_channel is None it absorbs all devices not used by the time axis.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if n_channel is None:
        if n % n_time:
            raise ValueError(f"{n} devices not divisible by n_time={n_time}")
        n_channel = n // n_time
    if n_channel * n_time > n:
        raise ValueError(
            f"mesh {n_channel}x{n_time} needs {n_channel * n_time} devices, "
            f"have {n}"
        )
    grid = np.array(devices[: n_channel * n_time]).reshape(n_channel, n_time)
    return Mesh(grid, (CHANNEL_AXIS, TIME_AXIS))


def single_device_mesh() -> Mesh:
    """1x1 mesh on the default device (lets sharded code paths run anywhere)."""
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), (CHANNEL_AXIS, TIME_AXIS))


def balanced_factors(n: int) -> tuple[int, int]:
    """n -> (a, b) with a*b == n and a >= b as balanced as possible."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b
