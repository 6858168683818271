"""Schmidl-Cox timing/CFO synchronization as fused array ops.

JAX equivalent of ofdm_sync_sc_cfb + plateau_detector_fb
(SURVEY.md §2b/§3.3, gr-digital/lib/ofdm_sync_sc_cfb_impl.cc and
plateau_detector_fb_impl.cc, unverified paths).

The reference builds this from ~8 streaming blocks (delay, multiply-conjugate,
two moving averages, divide, plateau detector), each a thread+ring-buffer hop.
Here the whole stack is a handful of windowed-sum/elementwise ops over the
entire sample block at once, and the "plateau detector" becomes boxcar
smoothing + windowed argmax (non-maximum suppression), yielding up to
`max_frames` detections per block with a validity mask (static shapes;
SURVEY.md §7 decision 2).  On a GPU the per-row detect summaries come from
the fused kernels in kernels/detect.py; this module's formulation is the
reference they are checked against and the path every other backend runs.

Math: P(d) = sum_{m<L} conj(r[d+m]) r[d+m+L], L = fft_len/2;
R(d) = sum_{m<L} |r[d+m+L]|^2;  M(d) = |P|^2 / R^2.
Fine CFO (subcarrier units) = angle(P) / pi.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmSpec


def sliding_max(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Valid-mode sliding max along the last axis: out[i] = max x[i:i+w],
    output length n - w + 1.  Uses the log-doubling trick (O(log w) shifted
    maxes); it is only ever applied to the n/ROW-long row arrays, and
    whether lax.reduce_window is faster on the GPU is not measured."""
    n = x.shape[-1]
    if w <= 1:
        return x
    y = x
    p = 1
    while p * 2 <= w:
        y = jnp.maximum(y[..., :-p], y[..., p:])
        p *= 2
    # y[i] = max x[i:i+p]; combine two p-windows covering [i, i+w)
    if p < w:
        y = jnp.maximum(y[..., : n - w + 1], y[..., w - p: w - p + n - w + 1])
    return y


def sliding_max_same(x: jnp.ndarray, w: int, pad_left: int) -> jnp.ndarray:
    """Same-length sliding max: out[i] = max x[i-pad_left : i-pad_left+w]
    (out-of-range treated as -inf)."""
    padded = jnp.pad(
        x, [(0, 0)] * (x.ndim - 1) + [(pad_left, w - 1 - pad_left)],
        constant_values=-jnp.inf,
    )
    return sliding_max(padded, w)


def coarse_sliding_max_same(x: jnp.ndarray, w: int, g: int = 128) -> jnp.ndarray:
    """Block-granular same-length sliding max: out[i] = max over a window
    that CONTAINS the centered w-window and at most w + 3g samples.

    Exact sliding max costs ~log2(w) full HBM passes (the log-doubling
    ladder); this computes per-block maxima (one reduce pass), runs the
    tiny ladder on the n/g block array, and broadcasts back -- ~1 pass
    total.  Both uses in this module (energy gate, peak non-max
    suppression) tolerate the enlarged window: the gate is a heuristic,
    and for NMS it only merges peaks closer than ~(w/2 + 2g) samples,
    well under one frame length."""
    n = x.shape[-1]
    nb = -(-n // g)
    pad = nb * g - n
    xb = jnp.pad(
        x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], constant_values=-jnp.inf
    ).reshape(*x.shape[:-1], nb, g)
    rowmax = xb.max(-1)
    k = -(-(w // 2 + g) // g)
    wm = sliding_max_same(rowmax, 2 * k + 1, pad_left=k)
    full = jnp.broadcast_to(wm[..., None], (*wm.shape, g))
    return full.reshape(*x.shape[:-1], nb * g)[..., :n]


def moving_sums(arrs: list[jnp.ndarray], w: int) -> list[jnp.ndarray]:
    """Valid-mode moving sums over the last axis of several real arrays:
    out[d] = sum x[d:d+w], length n - w + 1, in float32.

    Each window is summed directly (lax.reduce_window, stride 1), so its
    error is that of a w-term f32 sum whatever the block length.  Window
    sums taken as differences of one block-length prefix sum carry an
    error of about eps * n / w of the window, several per cent at n = 2^25
    and w = 32, which is enough to lose frames."""
    out = []
    for a in arrs:
        a = a.astype(jnp.float32)
        nd = a.ndim
        out.append(jax.lax.reduce_window(
            a, jnp.float32(0), jax.lax.add, (1,) * (nd - 1) + (w,),
            (1,) * nd, "VALID"))
    return out


def moving_sum(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Valid-mode moving sum along the last axis: out[d] = sum x[d:d+w].
    Output length = n - w + 1 (see moving_sums), rather than the
    reference's stateful moving_average block."""
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        re, im = moving_sums([jnp.real(x), jnp.imag(x)], w)
        return (re + 1j * im).astype(jnp.complex64)
    return moving_sums([x], w)[0]


class SyncMetric(NamedTuple):
    metric: jnp.ndarray   # M(d), float32, length n - fft_len
    corr: jnp.ndarray     # P(d), complex64, same length
    energy: jnp.ndarray   # R(d), float32, same length


def _sc_raw(spec: OfdmSpec, r: jnp.ndarray):
    """Ungated valid-mode P_re, P_im, R, M float32 arrays (length n - 2L + 1),
    for the SyncMetric API."""
    L = spec.fft_len // 2
    prod = jnp.conj(r[..., :-L]) * r[..., L:]
    energy = jnp.abs(r[..., L:]) ** 2
    p_re, p_im, R = moving_sums(
        [jnp.real(prod), jnp.imag(prod), energy], L
    )
    # capped + zeroed-at-silence ratio: genuine M <= ~1; near silence R is
    # tiny and the raw ratio of two rounding-level quantities is arbitrary,
    # so it must not reach the smoothed metric uncapped
    M = jnp.where(
        R > 0.0,
        jnp.minimum((p_re**2 + p_im**2) / jnp.maximum(R, 1e-12) ** 2, 2.0),
        0.0,
    )
    return p_re, p_im, R, M


def _metric2(p2: jnp.ndarray, r1: jnp.ndarray, r2: jnp.ndarray) -> jnp.ndarray:
    """Two-sided normalized timing metric M = |P|^2 / (R1 * R2).

    Cauchy-Schwarz bounds it by 1 STRUCTURALLY: |P|^2 <= R1*R2 for any input,
    so signal-edge windows where the classic one-sided |P|^2/R2^2 explodes
    (tiny second-half energy against cross-boundary correlation; measured
    2026-08-19 producing spurious sm maxima that captured a row's candidate
    away from a genuine peak 100 samples away) stay at noise level ~1/L.
    At a true Schmidl-Cox plateau R1 == R2 and the value matches the
    one-sided metric, so thresholds carry over.  The golden oracle and the
    SyncMetric API keep the one-sided form (golden_ofdm.schmidl_cox_metric);
    only frame detection uses this."""
    return jnp.where(
        r1 * r2 > 0.0,
        jnp.minimum(p2 / jnp.maximum(r1 * r2, 1e-12), 2.0),
        0.0,
    )


def schmidl_cox(spec: OfdmSpec, r: jnp.ndarray) -> SyncMetric:
    """Compute the Schmidl-Cox metric over a sample block (last axis)."""
    p_re, p_im, R, M = _sc_raw(spec, r)
    P = (p_re + 1j * p_im).astype(jnp.complex64)
    # Suppress low-energy regions where the ratio is unreliable.  The energy
    # scale is LOCAL (sliding max over ~2 symbols) rather than the block
    # max: a block-global gate would silently drop a weak frame whenever a
    # strong one shares the block (dynamic-range bug), and would make
    # detection depend on how the stream is chopped into blocks.
    w = 2 * spec.sym_len + 1
    local = coarse_sliding_max_same(R, w)
    M = jnp.where(R > 0.05 * local, M, 0.0)
    return SyncMetric(M.astype(jnp.float32), P.astype(jnp.complex64), R)


class Detections(NamedTuple):
    start: jnp.ndarray     # (K,) int32: index of first FFT-window sample
    fine_cfo: jnp.ndarray  # (K,) float32: fractional CFO, subcarrier units
    valid: jnp.ndarray     # (K,) bool
    peak: jnp.ndarray      # (K,) float32: smoothed metric at the peak


ROW = 128  # candidate granularity: one detection slot per ROW samples

# Minimum supported inter-frame spacing: two genuine sync peaks are both
# reported iff their row indices differ by more than the NMS radius kn =
# max(1, ceil(sym_len/2 / ROW)); peaks (kn + 1) rows apart are ALWAYS
# separable, i.e. frame starts >= min_frame_gap() samples apart.  Frames
# closer than ROW samples always merge (one candidate per row).  Since a
# frame is at least 4 OFDM symbols (2 sync + header + 1 payload) long,
# back-to-back frames at zero gap satisfy this for every fft_len
# (4*sym_len >= 2*ROW requires sym_len >= 64 -- true for fft_len >= 64).


def min_frame_gap(spec: OfdmSpec) -> int:
    """Smallest start-to-start spacing at which two frames are guaranteed
    to be separately detected (see note above; asserted by tests)."""
    kn = max(1, -(-(spec.sym_len // 2) // ROW))
    return (kn + 1) * ROW


def _select_from_rows(
    spec: OfdmSpec,
    smmax, smarg, pre, pim, r_at, rmax,
    n_sm: int,
    max_frames: int,
    threshold: float,
) -> Detections:
    """Shared candidate selection over per-row summaries (one candidate per
    ROW samples): NMS + threshold + energy gate + top-k, all on arrays that
    are n/ROW long -- the jnp rows and the GPU kernels (kernels/detect.py)
    feed the identical selection so both paths detect the same frames.

    Row summaries (trailing t-indexed, t = position of the last sample of
    the combined 2L+W window):
      smmax[r]  max of smoothed metric over row r (tie-break ramp included)
      smarg[r]  global t of that max (int32)
      pre/pim[r]  P (autocorrelation) at t* - (cp - cp//2) = plateau center
      r_at[r]   R (energy) at the same lagged position
      rmax[r]   max of R over row r (for the local energy gate)
    """
    cp = spec.cp_len
    # local energy scale (sliding max over ~2 symbols of row maxima): the
    # gate is LOCAL, not block-global, for the reasons in schmidl_cox.
    # STRICT >: a candidate with exactly-zero energy (digital silence, where
    # the capped metric can still hold cancellation residue, see _metric)
    # never passes, whatever the neighborhood looks like.
    kg = max(1, -(-spec.sym_len // ROW))
    local = sliding_max_same(rmax, 2 * kg + 1, pad_left=kg)
    gate = r_at > 0.05 * local
    # windowed non-max suppression at row granularity; gated-out rows are
    # excluded BEFORE the max so a residue row cannot suppress a real peak
    kn = max(1, -(-(spec.sym_len // 2) // ROW))
    smg = jnp.where(gate, smmax, -jnp.inf)
    win = sliding_max_same(smg, 2 * kn + 1, pad_left=kn)
    t0 = spec.sym_len - 1          # trailing t of sm index 0 (= 2L + W - 2)
    ps = smarg - t0
    ok = gate & (smmax >= win) & (smmax > threshold)
    ok &= (ps >= 0) & (ps < n_sm)
    big = jnp.int32(1 << 30)
    pos = jnp.where(ok, ps, big)
    neg, idx = jax.lax.top_k(-pos, max_frames)
    order = -neg                   # ascending sm positions
    valid = order < big
    backoff = min(4, cp // 4)
    # sm window [ps, ps+cp] has its apex at the plateau center ps + cp/2;
    # frame start = center + cp - cp//2 - backoff = ps + cp - backoff
    start = order + cp - backoff
    fine_cfo = jnp.arctan2(pim[idx], pre[idx]) / jnp.pi
    return Detections(
        start.astype(jnp.int32),
        fine_cfo.astype(jnp.float32),
        valid,
        smmax[idx],
    )


def _tiebreak(t: jnp.ndarray) -> jnp.ndarray:
    """Deterministic tie-break ramp for perfectly flat (noiseless) plateaus:
    strictly increasing within any window shorter than 2^16 samples, bounded
    by 6.6e-3 so it cannot promote noise over the detection threshold (the
    r1 full-length ramp reached 0.4 at 2^22 -- a latent false-peak bias).

    Wrap caveat: the ramp restarts every 2^16 samples, so a PERFECTLY flat
    noiseless plateau straddling a wrap boundary resolves its argmax to the
    post-wrap restart rather than the earliest position -- deterministic and
    bounded to < cp samples of start shift (the plateau length), and any
    real-world noise (>= 1e-7 metric variation) dominates the ramp.  2^16 is
    comfortably larger than one smoothing window (cp + 1 <= fft_len), which
    is all NMS ever compares within."""
    return (t & 0xFFFF).astype(jnp.float32) * 1e-7


def _detect_rows_jnp(spec: OfdmSpec, r: jnp.ndarray):
    """Row summaries from full-length arrays: the path every backend but
    the GPU runs, and the reference kernels/detect.py is checked against."""
    L = spec.fft_len // 2
    cp = spec.cp_len
    W = cp + 1
    c = cp - cp // 2
    n = r.shape[-1]
    prod = jnp.conj(r[..., :-L]) * r[..., L:]
    e2 = jnp.abs(r[..., L:]) ** 2
    e1 = jnp.abs(r[..., :-L]) ** 2
    p_re, p_im, R, R1 = moving_sums(
        [jnp.real(prod), jnp.imag(prod), e2, e1], L
    )                                          # valid-mode, length n - 2L + 1
    M = _metric2(p_re**2 + p_im**2, R1, R)
    sm = moving_sum(M, W) / W                 # length n_sm
    t0 = spec.sym_len - 1
    rows = -(-n // ROW)
    npad = rows * ROW

    def at(x, off, fill):
        # t-indexed full array: out[t] = x[t - off], padded/clipped to npad
        keep = max(0, min(x.shape[-1], npad - off))
        return jnp.pad(x[..., :keep], (off, npad - off - keep),
                       constant_values=fill)

    smf = at(sm, t0, -jnp.inf) + _tiebreak(jnp.arange(npad, dtype=jnp.int32))
    pref = at(p_re, 2 * L - 1 + c, 0.0)
    pimf = at(p_im, 2 * L - 1 + c, 0.0)
    rcf = at(R, 2 * L - 1 + c, 0.0)
    rf = at(R, 2 * L - 1, 0.0)

    smr = smf.reshape(rows, ROW)
    arg = jnp.argmax(smr, axis=-1)
    smarg = (jnp.arange(rows, dtype=jnp.int32) * ROW + arg).astype(jnp.int32)
    pick = lambda x: jnp.take_along_axis(
        x.reshape(rows, ROW), arg[:, None], axis=-1
    )[:, 0]
    return (
        smr.max(-1),
        smarg,
        pick(pref),
        pick(pimf),
        pick(rcf),
        rf.reshape(rows, ROW).max(-1),
    )


def detect_rows(spec: OfdmSpec, r):
    """Per-row detect summaries of `r` (1-D complex64 or a
    device_io.PackedComplex of f32 planes): the fused kernels of
    kernels/detect.py on a GPU, _detect_rows_jnp everywhere else."""
    from ofdm_jax.utils.device_io import PackedComplex, decode

    if jax.default_backend() == "gpu":
        from ofdm_jax.kernels.detect import detect_rows as kernel_rows

        if isinstance(r, PackedComplex):
            re, im = r.re, r.im
        else:
            re = jnp.real(r).astype(jnp.float32)
            im = jnp.imag(r).astype(jnp.float32)
        return kernel_rows(re, im, spec.fft_len // 2, spec.cp_len)
    return _detect_rows_jnp(spec, decode(r))


def detect_frames(
    spec: OfdmSpec,
    r,
    max_frames: int,
    threshold: float | None = None,
) -> Detections:
    """Find up to `max_frames` frame starts in sample block `r` (1-D).

    Returns detections sorted by position with a validity mask.  `start`
    points a few samples inside the CP before sync word 1's FFT window
    (deliberate ISI backoff, same rule as the golden model's detect_frame).

    `r` may be complex64 or a device_io.PackedComplex of (re, im) f32
    planes; the plane form feeds the GPU kernels directly with no
    whole-buffer complex round trip (see modem.rx.rx_block).

    Structure: per-row (ROW=128 samples) candidate summaries -- max of the
    CP-boxcar-smoothed metric, its position, and P/R at the plateau center
    (detect_rows) -- then a shared selection (_select_from_rows) on the
    ROW-times-smaller arrays.  Replaces the reference's ofdm_sync_sc_cfb +
    plateau_detector stack (SURVEY.md §3.3).
    """
    from ofdm_jax.utils.device_io import PackedComplex

    if threshold is None:
        threshold = spec.cfg.sync_threshold
    L = spec.fft_len // 2
    n = (r.re if isinstance(r, PackedComplex) else r).shape[-1]
    n_sm = n - 2 * L - spec.cp_len + 1
    return _select_from_rows(
        spec, *detect_rows(spec, r), n_sm=n_sm, max_frames=max_frames,
        threshold=threshold,
    )


def derotate(r: jnp.ndarray, cfo_subcarriers: jnp.ndarray, fft_len: int,
             n0: jnp.ndarray | int = 0) -> jnp.ndarray:
    """Remove a carrier frequency offset: r[n] * exp(-j 2 pi cfo (n+n0) / N).

    Equivalent of the reference's frequency_modulator_fc + multiply_cc
    derotator stage (SURVEY.md §2b "CFO derotator")."""
    n = jnp.arange(r.shape[-1], dtype=jnp.float32) + n0
    ph = -2.0 * jnp.pi * cfo_subcarriers * n / fft_len
    return (r * jnp.exp(1j * ph.astype(jnp.float32))).astype(jnp.complex64)
