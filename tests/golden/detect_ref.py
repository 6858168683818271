"""Float64 numpy reference for the per-row frame-detect summaries.

Same contract as ofdm_jax.ops.sync._detect_rows_jnp (trailing t-indexed
rows of ROW = 128 samples, same masks, fills and tie-break ramp), computed
in float64 with window sums as differences of one float64 prefix sum
(relative error ~1e-16 * n / w, negligible at any block length the system
runs).  Both device paths -- the plain jnp rows and the GPU kernels -- are
checked against it.
"""

from __future__ import annotations

import numpy as np

ROW = 128


def window_sums(x: np.ndarray, w: int) -> np.ndarray:
    """Valid-mode sums out[d] = sum x[d:d+w] in float64."""
    c = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    return c[w:] - c[:-w]


def detect_rows_f64(r: np.ndarray, L: int, cp: int):
    """Returns (smf, rows6): the t-indexed smoothed metric incl. tie-break
    ramp (-inf where undefined; length rows*ROW) and the six row summaries
    (smmax, smarg, pre, pim, r_at, rmax)."""
    r = np.asarray(r).astype(np.complex128)
    n = len(r)
    W = cp + 1
    c = cp - cp // 2
    prod = np.conj(r[:-L]) * r[L:]
    p_re = window_sums(prod.real, L)
    p_im = window_sums(prod.imag, L)
    R = window_sums(np.abs(r[L:]) ** 2, L)
    R1 = window_sums(np.abs(r[:-L]) ** 2, L)
    den = R1 * R
    M = np.where(
        den > 0,
        np.minimum((p_re**2 + p_im**2) / np.maximum(den, 1e-12), 2.0),
        0.0,
    )
    sm = window_sums(M, W) / W
    rows = -(-n // ROW)
    npad = rows * ROW
    t = np.arange(npad)

    def at(x, off, fill):
        out = np.full(npad, fill, np.float64)
        keep = max(0, min(len(x), npad - off))
        out[off:off + keep] = x[:keep]
        return out

    smf = at(sm, 2 * L + W - 2, -np.inf) + (t & 0xFFFF) * 1e-7
    smr = smf.reshape(rows, ROW)
    arg = np.argmax(smr, axis=1)
    lag = 2 * L - 1 + c

    def pick(x):
        return np.take_along_axis(
            at(x, lag, 0.0).reshape(rows, ROW), arg[:, None], axis=1)[:, 0]

    rows6 = (
        smr.max(axis=1),
        np.arange(rows) * ROW + arg,
        pick(p_re),
        pick(p_im),
        pick(R),
        at(R, 2 * L - 1, 0.0).reshape(rows, ROW).max(axis=1),
    )
    return smf, rows6
