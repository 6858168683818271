"""Schmidl-Cox detect row summaries as two Pallas kernels (Triton route).

Frame detection is the only stage of the streaming receiver that reads
every sample.  ops.sync._detect_rows_jnp, left to XLA, forms about a dozen
block-length f32 arrays (products, energies, four window sums, the metric,
its boxcar and the t-indexed pads) before it reduces them to one summary
per ROW = 128 samples.  These kernels produce the same six summaries while
reading the two f32 sample planes, plus one f32 metric plane written by the
first kernel and read by the second.

Hopper blocks run in no order and carry nothing from one to the next, so
each program owns a fixed chunk of positions and recomputes a lookback halo
in front of it from global memory.  A program's tensor covers _BLOCK
positions [A, A + _BLOCK) of which the first `halo` (whole rows) only feed
the windows of the rest.

Window sums.  A trailing window sum of width w at tensor index j is the
prefix sum of the difference sequence z[j] = x[j] - x[j - w] (the lagged
term dropped for j < w), with both terms loaded from memory:

    sum_{u <= j} z[u] = sum x[j-w+1 .. j]        (exact for j >= w - 1)

A plain f32 scan would keep the rounding of every large term it passed
(a frame) in all the sums after it (the noise behind the frame), which is
the dynamic-range failure of prefix differences.  So each term is split
into three: a multiple of q1, a multiple of q2 = q1 * 2^(k+1-23) with
2^k >= w, and a rest below q2/2, with q1 chosen from the tensor's largest
term so that every partial sum of either multiple -- a difference of two
w-windows -- fits 24 bits of its quantum.  Those two scans are exact, and
the rest, below ~2^(2k-43) of the largest term, carries the only
rounding.  The result is a window sum good to f32 rounding whatever the
block length and across ~100 dB of dynamic range inside one program.

  metric kernel (one program per _BLOCK - halo positions):
    P(t)  = sum_{k<L} conj(r[t-k-L]) r[t-k]     (prod, lags 0 and L)
    R2(t) = sum_{k<L} |r[t-k]|^2,  R1(t) = R2(t - L)
    M(t)  = ops.sync._metric2(|P|^2, R1, R2)    -> metric plane
    rmax  = row max of R2 over t in [2L-1, n)   -> one value per row
  rows kernel (the same programs; each reads its own metric block):
    sm(t) = sum_{k<W} M(t-k) / W over t in [2L+W-2, n), -inf elsewhere,
            plus ops.sync._tiebreak(t)
    per row: max of sm, its first argmax t*, and P, R2 at t* - c summed
    directly (L loads per row) from the sample planes.

Indexing matches ops.sync._detect_rows_jnp (trailing t, same masks and
fills), so both feed ops.sync._select_from_rows identically.  Loads are
masked (lanes outside the stream touch no memory), which the Triton route
compiles to vector loads and the Pallas interpreter runs as it stands.

Tuning on one H100: _BLOCK 4096 with 4 warps was the fastest of 2048,
4096 and 8192 positions by 4, 8 and 16 warps and 1 or 2 stages
(measured 2026-10-16; PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ofdm_jax.ops.sync import ROW, _metric2, _tiebreak

_BLOCK = 4096      # positions per program tensor (a power of two)
_NUM_WARPS = 4
_NUM_STAGES = 1


def halo_len(L: int, cp: int) -> int:
    """Lookback of both kernels in samples (whole rows): a width-w
    difference scan is exact from tensor index w - 1 on, and the rows
    kernel's boxcar at j reads the metric from j - W + 1 on."""
    return -(-(L + cp - 1) // ROW) * ROW


def _quanta(e, w: int):
    """(q1, 1/q1, q2, 1/q2) for _wsum, from e = floor(log2(mx)) with mx >=
    every |term| of a tensor whose scan is differenced over windows of
    width w.  With 2^k >= w, a partial sum of q1-multiples stays below
    2w * 2^(e+1) <= 2^(e+k+2), half of 2^24 q1; the q2-multiples are about
    q1/2 at most, so theirs stay below ~w * q1, a quarter of 2^24 q2."""
    k = (w - 1).bit_length()
    e1 = e + k + 2 - 23
    e2 = e1 + k + 1 - 23
    if isinstance(e, int):                 # a bound known when tracing
        return 2.0 ** e1, 2.0 ** -e1, 2.0 ** e2, 2.0 ** -e2
    as_f32 = lambda x: jax.lax.bitcast_convert_type(
        (jnp.clip(x, -126, 126) + 127) << 23, jnp.float32)
    return as_f32(e1), as_f32(-e1), as_f32(e2), as_f32(-e2)


def _log2_floor(mx):
    """floor(log2(mx)) of a positive normal f32, from its exponent bits."""
    return (jax.lax.bitcast_convert_type(mx, jnp.int32) >> 23) - 127


def _wsum(x0, x1, quanta):
    """Prefix sums of x0 - x1, exact to f32 rounding of the window sums
    they difference to (see module doc); x1 is x0's sequence w places
    back, zero for j < w."""
    q1, inv_q1, q2, inv_q2 = quanta

    def split(x):
        h1 = jnp.floor(x * inv_q1 + 0.5) * q1
        r = x - h1
        h2 = jnp.floor(r * inv_q2 + 0.5) * q2
        return h1, h2, r - h2

    parts0, parts1 = split(x0), split(x1)
    out = None
    for p0, p1 in zip(parts0, parts1):
        s = jnp.cumsum(p0 - p1)
        out = s if out is None else out + s
    return out


def _prod(a, b):
    """(re, im) of conj(b) * a for a = (ar, ai), b = (br, bi)."""
    (ar, ai), (br, bi) = a, b
    return br * ar + bi * ai, br * ai - bi * ar


def _energy(a):
    return a[0] * a[0] + a[1] * a[1]


def _load(ref, pos, n, keep=True):
    """ref[pos] where 0 <= pos < n (and `keep`), else 0: a masked load,
    so lanes outside the stream touch no memory."""
    return plt.load(ref.at[pos], mask=(pos >= 0) & (pos < n) & keep,
                    other=0.0)


def _metric_kernel(re_ref, im_ref, m_ref, rmax_ref, *, L, n, halo):
    j = jnp.arange(_BLOCK, dtype=jnp.int32)
    t = pl.program_id(0) * (_BLOCK - halo) - halo + j
    lag = j >= L                  # lagged term inside this program's tensor
    x0 = _load(re_ref, t, n), _load(im_ref, t, n)
    x1 = _load(re_ref, t - L, n), _load(im_ref, t - L, n)
    x2 = _load(re_ref, t - 2 * L, n, lag), _load(im_ref, t - 2 * L, n, lag)
    p0, p1 = _prod(x0, x1), _prod(x1, x2)   # p1 = p0 one window back
    e0, e1, e2 = _energy(x0), _energy(x1), _energy(x2)
    # |conj(b) a| <= max(|a|^2, |b|^2): the energies bound every term
    mx = jnp.maximum(jnp.max(e0), jnp.max(e1))
    quanta = _quanta(_log2_floor(jnp.maximum(mx, 1e-30)), L)
    p_re = _wsum(p0[0], p1[0], quanta)
    p_im = _wsum(p0[1], p1[1], quanta)
    r2 = _wsum(e0, jnp.where(lag, e1, 0.0), quanta)
    r1 = _wsum(e1, e2, quanta)
    live = (t >= 2 * L - 1) & (t < n)
    m_ref[...] = jnp.where(live, _metric2(p_re * p_re + p_im * p_im, r1, r2),
                           0.0)
    rmax_ref[...] = jnp.max(
        jnp.where(live, r2, 0.0).reshape(_BLOCK // ROW, ROW), axis=1)


def _rows_kernel(m_ref, re_ref, im_ref, smmax_ref, smarg_ref, pre_ref,
                 pim_ref, rat_ref, *, L, W, c, n, halo):
    # m_ref is this program's own block of the metric plane: the metric
    # kernel's program of the same index covered the same positions
    j = jnp.arange(_BLOCK, dtype=jnp.int32)
    t0 = pl.program_id(0) * (_BLOCK - halo) - halo
    t = t0 + j
    m_lag = plt.load(m_ref.at[j - W], mask=j >= W, other=0.0)
    # ops.sync._metric2 caps the metric at 2 = 2^1
    s = _wsum(m_ref[...], m_lag, _quanta(1, W))
    live = (t >= 2 * L + W - 2) & (t < n)
    sm = jnp.where(live, s / W, -jnp.inf) + _tiebreak(t)
    rows = sm.reshape(_BLOCK // ROW, ROW)
    arg = jnp.argmax(rows, axis=1).astype(jnp.int32)
    tstar = t0 + jnp.arange(_BLOCK // ROW, dtype=jnp.int32) * ROW + arg
    # P and R2 at the plateau center t* - c, summed directly over the window
    k = jnp.arange(1 << (L - 1).bit_length(), dtype=jnp.int32)[None, :]
    u = (tstar - c)[:, None] - k
    inw = k < L
    a = _load(re_ref, u, n, inw), _load(im_ref, u, n, inw)
    b = _load(re_ref, u - L, n, inw), _load(im_ref, u - L, n, inw)
    pr, pi = _prod(a, b)
    full = tstar - c >= 2 * L - 1
    smmax_ref[...] = jnp.max(rows, axis=1)
    smarg_ref[...] = tstar
    pre_ref[...] = jnp.where(full, jnp.sum(pr, axis=1), 0.0)
    pim_ref[...] = jnp.where(full, jnp.sum(pi, axis=1), 0.0)
    rat_ref[...] = jnp.where(full, jnp.sum(_energy(a), axis=1), 0.0)


@functools.partial(jax.jit, static_argnames=("L", "cp", "interpret"))
def detect_rows(re, im, L: int, cp: int, interpret: bool = False):
    """(smmax, smarg, pre, pim, r_at, rmax), each of length ceil(n / ROW),
    for the 1-D f32 sample planes re/im -- the contract of
    ops.sync._detect_rows_jnp.  `interpret` runs the kernels in the Pallas
    interpreter (tests on the CPU)."""
    (n,) = re.shape
    # ops.sync._select_from_rows marks invalid candidates with 1 << 30
    assert n < (1 << 30), "positions must stay below the selection sentinel"
    W = cp + 1
    halo = halo_len(L, cp)
    assert halo <= _BLOCK // 2, (L, cp)
    rows = -(-n // ROW)
    R = _BLOCK // ROW
    grid = -(-n // (_BLOCK - halo))
    call = functools.partial(
        pl.pallas_call, grid=(grid,), backend="triton", interpret=interpret,
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=_NUM_STAGES))
    anywhere = pl.BlockSpec(memory_space=pl.ANY)

    def per_program(size, dtype=jnp.float32):
        return (pl.BlockSpec((None, size), lambda i: (i, 0)),
                jax.ShapeDtypeStruct((grid, size), dtype))

    (m_spec, m_shape), (r_spec, r_shape) = per_program(_BLOCK), per_program(R)
    m, rmax = call(
        functools.partial(_metric_kernel, L=L, n=n, halo=halo),
        in_specs=[anywhere, anywhere], out_specs=[m_spec, r_spec],
        out_shape=[m_shape, r_shape], name="detect_metric",
    )(re, im)
    i_spec, i_shape = per_program(R, jnp.int32)
    smmax, smarg, pre, pim, r_at = call(
        functools.partial(_rows_kernel, L=L, W=W, c=cp - cp // 2, n=n,
                          halo=halo),
        in_specs=[m_spec, anywhere, anywhere],
        out_specs=[r_spec, i_spec, r_spec, r_spec, r_spec],
        out_shape=[r_shape, i_shape, r_shape, r_shape, r_shape],
        name="detect_rows",
    )(m, re, im)

    def owned(x):
        return x[:, halo // ROW:].reshape(-1)[:rows]

    return tuple(owned(x) for x in (smmax, smarg, pre, pim, r_at, rmax))

