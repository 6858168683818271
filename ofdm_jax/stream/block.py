"""Streaming block abstraction: pure (state, x) -> (state, y) processors.

This is the JAX replacement for the reference's gr::block /
gr::sync_block contract (SURVEY.md §2b "Block base classes",
gnuradio-runtime/lib/block.cc, unverified path).  Where a GNU Radio block is
an object with general_work() called by a scheduler thread against circular
buffers, a Block here is a pair of pure functions:

    init()            -> state pytree      (replaces block members +
                                            set_history() lookback buffers)
    apply(state, x)   -> (state, y)        (replaces general_work())

Blocks compose with `chain` (replaces top_block.connect for linear graphs)
and execute under lax.scan in stream.executor -- ONE XLA program instead of
one OS thread per block (SURVEY.md §7 design decision 1).

The library below provides the reference's utility blocks (§2b "Utility
blocks": delay, moving_average, multiply_const, complex_to_mag_squared,
nlog10_ff, stream_to_vector, single-pole IIR, FIR filters with history) as
Blocks.  Stateless math lifts via `stateless`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Block:
    """A streaming processor: pure init/apply pair (see module docstring).

    `latency`: samples of pipeline delay before an input sample's effect is
    fully emitted (e.g. the RX history carry).  The executor flushes this
    many zero samples at end-of-stream so trailing outputs are not lost --
    the counterpart of the reference scheduler's end-of-stream drain."""

    init: Callable[[], Any]
    apply: Callable[[Any, Any], tuple[Any, Any]]
    name: str = "block"
    latency: int = 0
    # False for blocks whose input is not a per-sample stream (e.g. the
    # streaming TX consumes PDU slot batches); the executor then skips its
    # every-leaf-is-block_size-long shape check.
    stream_input: bool = True

    def __call__(self, state, x):
        return self.apply(state, x)


def stateless(fn: Callable[[Any], Any], name: str = "fn") -> Block:
    """Lift a pure elementwise/block function into a Block (cf. sync_block
    with no history)."""
    return Block(init=lambda: (), apply=lambda s, x: (s, fn(x)), name=name)


def chain(*blocks: Block, name: str = "chain") -> Block:
    """Sequential composition: y flows through blocks in order, states are
    carried as a tuple (replaces top_block.connect(b0, b1, ...))."""

    def init():
        return tuple(b.init() for b in blocks)

    def apply(states, x):
        new_states = []
        for b, s in zip(blocks, states):
            s, x = b.apply(s, x)
            new_states.append(s)
        return tuple(new_states), x

    return Block(init=init, apply=apply, name=name)


# ---------------------------------------------------------------------------
# Utility blocks (cf. gr-blocks/lib/*.cc, SURVEY.md §2b "Utility blocks")
# ---------------------------------------------------------------------------


def multiply_const(k, name: str = "multiply_const") -> Block:
    return stateless(lambda x: x * k, name)


def add_const(k, name: str = "add_const") -> Block:
    return stateless(lambda x: x + k, name)


def complex_to_mag_squared() -> Block:
    return stateless(lambda x: jnp.abs(x) ** 2, "complex_to_mag_squared")


def nlog10(n: float = 10.0, k: float = 0.0, floor: float = 1e-20) -> Block:
    """n*log10(x) + k (cf. nlog10_ff), with a floor to avoid -inf."""
    return stateless(
        lambda x: n * jnp.log10(jnp.maximum(x, floor)) + k, "nlog10"
    )


def stream_to_vector(vlen: int) -> Block:
    """(..., n) -> (..., n//vlen, vlen); block size must divide by vlen."""
    def fn(x):
        return x.reshape(*x.shape[:-1], x.shape[-1] // vlen, vlen)
    return stateless(fn, "stream_to_vector")


def vector_to_stream() -> Block:
    return stateless(
        lambda x: x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]),
        "vector_to_stream",
    )


def delay(n: int, dtype=jnp.complex64) -> Block:
    """Delay by n samples (cf. blocks.delay): carries the last n inputs."""

    def init():
        return np.zeros(n, dtype=np.dtype(jnp.dtype(dtype)))

    def apply(state, x):
        ext = jnp.concatenate([state, x], axis=-1)
        return ext[..., x.shape[-1]:], ext[..., : x.shape[-1]]

    return Block(init, apply, f"delay({n})")


def moving_average(n: int, dtype=jnp.float32, scale: float | None = None) -> Block:
    """Moving sum/average over the trailing n samples (cf.
    blocks.moving_average): y[i] = scale * sum_{k<n} x[i-k].  Carries the
    last n-1 inputs (overlap-save, = set_history(n))."""
    if scale is None:
        scale = 1.0

    def init():
        return np.zeros(n - 1, dtype=np.dtype(jnp.dtype(dtype)))

    def apply(state, x):
        ext = jnp.concatenate([state, x], axis=-1)
        c = jnp.cumsum(ext, axis=-1)
        lead = c[..., n - 1:]
        lag = jnp.concatenate(
            [jnp.zeros_like(c[..., :1]), c[..., : c.shape[-1] - n]], axis=-1
        )
        y = (lead - lag) * scale
        return ext[..., -(n - 1):], y

    return Block(init, apply, f"moving_average({n})")


def single_pole_iir(alpha: float, dtype=jnp.float32) -> Block:
    """y[i] = alpha*x[i] + (1-alpha)*y[i-1] (cf. single_pole_iir_filter_ff).

    The per-sample recurrence is a composition of affine maps
    f_i(y) = r*y + alpha*x[i]; affine composition is associative, so the
    whole block evaluates in O(log n) depth via lax.associative_scan instead
    of the reference's per-sample loop.
    """
    import jax

    r = dtype(1.0 - alpha)
    a = dtype(alpha)

    def init():
        return np.zeros((), dtype=np.dtype(jnp.dtype(dtype)))

    def apply(y0, x):
        m = jnp.full(x.shape[-1], r, dtype=dtype)
        b = (a * x).astype(dtype)

        def combine(l, rgt):
            ml, bl = l
            mr, br = rgt
            return ml * mr, bl * mr + br

        mm, bb = jax.lax.associative_scan(combine, (m, b), axis=-1)
        y = mm * y0 + bb
        return y[..., -1], y

    return Block(init, apply, f"single_pole_iir({alpha})")


# Tap counts above this use the frame-matmul FIR; below, shifted
# multiply-adds (matmul would waste (F+K-1)/K of its MACs).  Both
# constants were tuned on the accelerator the system was first built for
# and are kept as they run; their best values on the GPU are not measured.
_FIR_MATMUL_MIN_TAPS = 33
_FIR_FRAME = 128  # output frame width of the matmul form


def fir_ext(ext: jnp.ndarray, taps: np.ndarray, n_out: int) -> jnp.ndarray:
    """Causal FIR over a history-extended stream (the shared overlap-save
    core): ext (..., n_out + K - 1) whose first K-1 samples are history,
    y[m] = sum_k taps[k] * ext[K - 1 - k + m].

    The reference's VOLK dot-product loop maps to either K fused shifted
    multiply-adds (short filters) or an overlap-save frame matmul against
    a Toeplitz tap matrix (long filters): frames (nf, F+K-1) @ T (F+K-1, F)
    with T[r, c] = taps[K-1+c-r], in HIGHEST precision (no TF32).  Whether
    lax.conv beats either on the GPU is not measured.
    """
    taps = np.asarray(taps)
    K = len(taps)
    if K < _FIR_MATMUL_MIN_TAPS:
        tj = jnp.asarray(taps)
        acc = tj[K - 1] * ext[..., :n_out]
        for k in range(K - 2, -1, -1):
            acc = acc + tj[k] * ext[..., K - 1 - k : K - 1 - k + n_out]
        return acc
    F = _FIR_FRAME
    nf = -(-n_out // F)
    pad = nf * F + K - 1 - ext.shape[-1]
    if pad > 0:
        z = jnp.zeros((*ext.shape[:-1], pad), dtype=ext.dtype)
        ext = jnp.concatenate([ext, z], axis=-1)
    idx = (np.arange(nf) * F)[:, None] + np.arange(F + K - 1)[None, :]
    frames = ext[..., idx]  # (..., nf, F+K-1) overlapped gather
    t_np = np.zeros((F + K - 1, F), dtype=taps.dtype)
    c = np.arange(F)
    for k in range(K):
        t_np[K - 1 + c - k, c] = taps[k]
    y = jnp.einsum(
        "...nr,rc->...nc", frames, jnp.asarray(t_np),
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(*y.shape[:-2], nf * F)[..., :n_out]


def fir_filter(taps, decim: int = 1, dtype=jnp.complex64) -> Block:
    """Causal FIR y[n] = sum_k taps[k] x[n-k], optionally decimating
    (cf. kernel::fir_filter_ccf / fir_filter_ccc, gr-filter/lib/fir_filter.cc).

    Streaming via overlap-save: carries the last len(taps)-1 input samples.
    Block length must be a multiple of `decim`; output is len(x)//decim with
    output m tapping x at n = m*decim (phase 0).  Compute core: fir_ext.
    """
    taps = np.asarray(taps)
    nt = len(taps)

    def init():
        return np.zeros(nt - 1, dtype=np.dtype(jnp.dtype(dtype)))

    def apply(state, x):
        n = x.shape[-1]
        ext = jnp.concatenate([state, x.astype(dtype)], axis=-1)
        y = fir_ext(ext, taps, n)
        if decim > 1:
            y = y[..., ::decim]
        return ext[..., -(nt - 1):] if nt > 1 else state, y

    return Block(init, apply, f"fir({nt},decim={decim})")


def freq_xlating_fir(taps, center_freq_rel: float, decim: int = 1) -> Block:
    """Frequency-translating FIR (cf. freq_xlating_fir_filter_ccc): mix the
    band at `center_freq_rel` (fraction of fs) down to DC, lowpass, decimate.
    Carries the mixer phase across blocks for continuity."""
    taps = np.asarray(taps)
    base = fir_filter(taps, decim=decim)

    def init():
        return (np.zeros((), dtype=np.float32), base.init())

    def apply(state, x):
        ph0, fs = state
        n = x.shape[-1]
        ph = ph0 + 2.0 * np.pi * (-center_freq_rel) * (
            jnp.arange(n, dtype=jnp.float32) + 1.0
        )
        mixed = x * jnp.exp(1j * ph)
        fs, y = base.apply(fs, mixed.astype(jnp.complex64))
        ph_next = jnp.mod(ph[-1], 2.0 * np.pi)
        return (ph_next, fs), y

    return Block(init, apply, f"freq_xlating_fir({len(taps)})")


def interpolating_fir(taps, interp: int, dtype=jnp.complex64) -> Block:
    """Interpolating FIR (cf. interp_fir_filter_ccf,
    gr-filter/lib/interp_fir_filter.cc, unverified path): upsample by
    `interp` with polyphase decomposition -- y[m*L + p] = sum_k
    taps[k*L + p] * x[m - k] -- instead of the zero-stuff-then-filter
    identity, so no multiplies are wasted on the stuffed zeros.  Each of the
    L phase filters is a small static convolution; outputs interleave to a
    len(x)*L stream.  Carries ceil(nt/L)-1 input samples (overlap-save)."""
    taps = np.asarray(taps)
    L = int(interp)
    nt = len(taps)
    k = -(-nt // L)  # taps per phase arm
    poly = np.zeros((k, L), dtype=taps.dtype)
    poly.ravel()[:nt] = taps  # poly[k, p] = taps[k*L + p]

    def init():
        return np.zeros(k - 1, dtype=np.dtype(jnp.dtype(dtype)))

    def apply(state, x):
        n = x.shape[-1]
        ext = jnp.concatenate([state, x.astype(dtype)], axis=-1)
        phases = [fir_ext(ext, poly[:, p], n) for p in range(L)]
        y = jnp.stack(phases, axis=-1).reshape(*x.shape[:-1], n * L)
        return (ext[..., -(k - 1):] if k > 1 else state), y

    return Block(init, apply, f"interp_fir({nt},L={L})")


def rational_resampler(taps, interp: int, decim: int) -> Block:
    """Rate change by interp/decim (cf. rational_resampler_ccf): polyphase
    interpolation followed by decimation; block length must be a multiple
    of `decim` after interpolation."""
    up = interpolating_fir(taps, interp)

    def init():
        return up.init()

    def apply(state, x):
        state, y = up.apply(state, x)
        return state, y[..., ::decim]

    return Block(init, apply, f"resampler({interp}/{decim})")


def head(n: int) -> Block:
    """Pass samples through until n total, then zero + mask (cf. blocks.head;
    static-shape version returns (y, mask))."""

    def init():
        return np.zeros((), dtype=np.int64)

    def apply(count, x):
        m = x.shape[-1]
        idx = count + jnp.arange(m)
        mask = idx < n
        return count + m, (jnp.where(mask, x, 0), mask)

    return Block(init, apply, f"head({n})")


def probe_rate() -> Block:
    """Counts samples seen (cf. blocks.probe_rate); the host divides by wall
    time to get samples/s.  State IS the metric."""

    def init():
        return np.zeros((), dtype=np.int64)

    def apply(count, x):
        return count + x.shape[-1], x

    return Block(init, apply, "probe_rate")
