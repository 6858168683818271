"""Waterfall buffers (device) and terminal/ASCII rendering (host).

JAX equivalent of gr-ofdm_tools' terminal waterfall and the remote
client's rendering loop (SURVEY.md §2a "Terminal/ASCII waterfall" /
"Remote spectrum client", python/ascii_plot*.py + remote_client.py,
unverified paths).  The device keeps a rolling (depth, fft_len) ring of PSD
rows; the host renders ASCII frames from drained rows.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ofdm_jax.spectrum.psd import psd_frames
from ofdm_jax.stream.block import Block

# dark -> bright ramp, same idea as the reference's ASCII art sink
_RAMP = " .:-=+*#%@"


def waterfall_block(
    fft_len: int,
    depth: int = 64,
    window: str = "hann",
    decim: int = 1,
    floor: float = 1e-20,
) -> Block:
    """Rolling waterfall: keep the newest `depth` PSD rows (dB, fftshifted so
    DC is centered).  `decim` keeps every decim-th frame (cf. the reference
    worker's frame-rate throttling)."""

    def init():
        return np.full((depth, fft_len), -200.0, dtype=np.float32)

    def apply(ring, x):
        pwr = psd_frames(x, fft_len, window)[..., ::decim, :]
        rows = 10.0 * jnp.log10(jnp.maximum(pwr, floor))
        rows = jnp.roll(rows, fft_len // 2, axis=-1)      # center DC
        k = min(rows.shape[-2], depth)
        ring = jnp.concatenate([ring[k:], rows[-k:]], axis=0)
        return ring, ring

    return Block(init, apply, f"waterfall({fft_len}x{depth})")


def render_ascii(
    rows: np.ndarray,
    db_min: float | None = None,
    db_max: float | None = None,
    width: int | None = None,
) -> str:
    """Render (n_rows, fft_len) dB rows as ASCII art (host-side).

    Auto-scales to the data range unless db_min/db_max given; optionally
    column-decimates to `width` characters.
    """
    rows = np.asarray(rows, dtype=np.float32)
    if rows.ndim == 1:
        rows = rows[None, :]
    finite = rows[np.isfinite(rows)]
    lo = db_min if db_min is not None else (finite.min() if finite.size else -120)
    hi = db_max if db_max is not None else (finite.max() if finite.size else 0)
    hi = max(hi, lo + 1e-6)
    if width and width < rows.shape[1]:
        step = rows.shape[1] // width
        rows = rows[:, : width * step].reshape(rows.shape[0], width, step).max(-1)
    t = np.clip((rows - lo) / (hi - lo), 0.0, 1.0)
    idx = (t * (len(_RAMP) - 1)).astype(np.int64)
    lut = np.frombuffer(_RAMP.encode(), dtype=np.uint8)
    return "\n".join(bytes(lut[r]).decode() for r in idx)


def render_spectrum_line(
    psd_db: np.ndarray, width: int = 80, db_min: float = -100, db_max: float = 0
) -> str:
    """One-line spectrum bar view of a single PSD row."""
    return render_ascii(psd_db[None, :], db_min, db_max, width)
