"""Spectrum probe accumulators: max-hold / min-hold / average PSD.

JAX equivalent of gr-ofdm_tools' local spectrum worker statistics
(SURVEY.md §2a "Local spectrum worker", python/local_worker.py, unverified
path): the worker packs max-hold and average PSD vectors per update interval
and ships them to the remote client.  Here the accumulation runs on-device
as a streaming Block; the host drains a small (3, fft_len) summary per
time-block (io.transport ships it, replacing the UDP socket).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ofdm_jax.spectrum.psd import psd_frames
from ofdm_jax.stream.block import Block


class SpectrumSummary(NamedTuple):
    avg_db: jnp.ndarray      # (fft_len,) running average PSD, dB
    max_db: jnp.ndarray      # (fft_len,) max-hold, dB
    min_db: jnp.ndarray      # (fft_len,) min-hold, dB
    n_frames: jnp.ndarray    # () int32 frames accumulated


def spectrum_probe_block(
    fft_len: int,
    window: str = "hann",
    floor: float = 1e-20,
) -> Block:
    """Accumulate avg/max/min PSD across all frames seen since reset.

    Averaging is done in linear power (then converted to dB on output),
    matching how the reference's worker averages psd vectors; max/min hold
    are per-bin extrema over frames.
    """

    def init():
        return (
            np.zeros(fft_len, dtype=np.float32),              # sum power
            np.full(fft_len, -np.inf, dtype=np.float32),      # max power
            np.full(fft_len, np.inf, dtype=np.float32),       # min power
            np.zeros((), dtype=np.int32),                     # frame count
        )

    def apply(state, x):
        s, mx, mn, cnt = state
        pwr = psd_frames(x, fft_len, window)                  # (n, fft_len)
        s = s + jnp.sum(pwr, axis=-2)
        mx = jnp.maximum(mx, jnp.max(pwr, axis=-2))
        mn = jnp.minimum(mn, jnp.min(pwr, axis=-2))
        cnt = cnt + pwr.shape[-2]
        db = lambda p: 10.0 * jnp.log10(jnp.maximum(p, floor))
        out = SpectrumSummary(
            avg_db=db(s / jnp.maximum(cnt, 1).astype(jnp.float32)),
            max_db=db(mx),
            min_db=db(jnp.where(jnp.isinf(mn), 0.0, mn)),
            n_frames=cnt,
        )
        return (s, mx, mn, cnt), out

    return Block(init, apply, f"spectrum_probe({fft_len})")
