"""Polyphase filterbank channelizer (critically sampled).

JAX equivalent of pfb_channelizer_ccf / kernel::polyphase_filterbank
(SURVEY.md §2b, gr-filter/lib/pfb_channelizer_ccf_impl.cc and
polyphase_filterbank.cc, unverified paths): commutator -> N polyphase FIR
arms -> N-point IFFT across arms.

Array mapping instead of the reference's per-arm VOLK dot products:

  * the commutator is a reshape (n_out, n_chan) + lane reversal -- free;
  * ALL N FIR arms advance together as J fused multiply-accumulate passes
    over (n_out, n_chan) planes (J = taps per arm, ~8-16);
  * the cross-arm IFFT is a batched matmul DFT (kernels.fft).

Streaming state = the last (J-1)*N raw samples, the FIR lookback
(overlap-save, cf. set_history), carried by the executor.

Matches tests/golden/golden_ofdm.pfb_channelize bit-for-bit (same arm
ordering: arm a at output m consumes x[m*N + (N-1-a)]; channel k centered
at k*fs/N; output scaled by N).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ofdm_jax.kernels.fft import ifft
from ofdm_jax.stream.block import Block


def lowpass_taps(n_chan: int, taps_per_arm: int = 8, beta: float = 9.0) -> np.ndarray:
    """Prototype lowpass: windowed sinc, cutoff fs/(2*n_chan), unity per-arm
    DC gain (cf. firdes.low_pass + Kaiser; same as the golden model)."""
    ntaps = n_chan * taps_per_arm
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(n / n_chan) * np.kaiser(ntaps, beta)
    return (h / np.sum(h) * n_chan).astype(np.float32)


def polyphase_decompose(taps: np.ndarray, n_chan: int) -> np.ndarray:
    """taps -> (taps_per_arm, n_chan) polyphase matrix poly[j, arm]."""
    ntaps = len(taps)
    j = -(-ntaps // n_chan)
    tp = np.zeros(j * n_chan, dtype=np.float32)
    tp[:ntaps] = taps
    return tp.reshape(j, n_chan)


def channelize_ext(ext_rows: jnp.ndarray, poly: jnp.ndarray) -> jnp.ndarray:
    """Channelize history-extended commutator rows.

    ext_rows: (..., n_out + J - 1, n_chan) where the first J-1 rows are
    history (zeros at stream start) and rows are ALREADY lane-reversed
    commutator loads xa[m, a] = x[m*N + (N-1-a)].
    Returns (..., n_out, n_chan) channel samples.
    """
    J, n_chan = poly.shape
    n_out = ext_rows.shape[-2] - (J - 1)
    # causal FIR per arm: arm_out[m, a] = sum_j poly[j, a] * xa[m - j, a]
    acc = jnp.zeros((*ext_rows.shape[:-2], n_out, n_chan), dtype=jnp.complex64)
    for j in range(J):
        acc = acc + poly[j] * ext_rows[..., (J - 1 - j):(J - 1 - j) + n_out, :]
    # cross-arm IFFT: channel k = sum_a arm[a] * e^{2pi i a k / N}; batched
    # matmul DFT
    return ifft(acc) * n_chan


def commutator_rows(x: jnp.ndarray, n_chan: int) -> jnp.ndarray:
    """Serial samples -> lane-reversed commutator rows (..., n, n_chan)."""
    n_out = x.shape[-1] // n_chan
    rows = x[..., : n_out * n_chan].reshape(*x.shape[:-1], n_out, n_chan)
    return rows[..., ::-1]


def channelize(x: jnp.ndarray, n_chan: int, taps: np.ndarray) -> jnp.ndarray:
    """One-shot channelizer over a sample buffer (zero history), matching the
    golden model: (..., n_samples) -> (..., n_out, n_chan)."""
    poly = jnp.asarray(polyphase_decompose(np.asarray(taps), n_chan))
    rows = commutator_rows(x, n_chan)
    J = poly.shape[0]
    pad = jnp.zeros((*rows.shape[:-2], J - 1, n_chan), dtype=rows.dtype)
    return channelize_ext(jnp.concatenate([pad, rows], axis=-2), poly)


def tail_len(n_chan: int, taps_per_arm: int) -> int:
    """Raw-sample streaming carry: the FIR lookback (J-1)*N."""
    return (taps_per_arm - 1) * n_chan


def stream_tail_len(n_chan: int, taps: np.ndarray) -> int:
    """Raw-sample streaming-carry length for channelize_stream."""
    J = polyphase_decompose(np.asarray(taps), n_chan).shape[0]
    return tail_len(n_chan, J)


def channelize_stream(
    x: jnp.ndarray,
    tail: jnp.ndarray,
    n_chan: int,
    taps_np: np.ndarray,
    poly: jnp.ndarray,
):
    """One streaming channelizer step with a RAW-SAMPLE tail carry.

    x: (block,) complex64, block % n_chan == 0; tail: the
    stream_tail_len(n_chan, taps) samples immediately preceding x (zeros at
    stream start).  Returns (out (block//n_chan, n_chan), new_tail).  The
    carry is raw samples, not commutator rows, so it does not depend on how
    the step is computed.
    """
    C = tail_len(n_chan, poly.shape[0])
    x = x.astype(jnp.complex64)
    hist = commutator_rows(tail, n_chan)
    ext = jnp.concatenate([hist, commutator_rows(x, n_chan)], axis=-2)
    out = channelize_ext(ext, poly)
    n = x.shape[-1]
    if n >= C:
        new_tail = x[..., n - C :]
    else:
        new_tail = jnp.concatenate([tail, x], axis=-1)[..., -C:]
    return out, new_tail


def synthesize_wideband(chans: np.ndarray,
                        taps: np.ndarray | None = None) -> np.ndarray:
    """Synthesis filterbank (host-side numpy): per-channel baseband samples
    (M, n_chan) -> one wideband stream (M * n_chan,).

    The dual of `channelize` (cf. gr-filter's pfb_synthesizer_ccf,
    gr-filter/lib/pfb_synthesizer_ccf_impl.cc, unverified path): each
    channel is upsampled by n_chan, shaped with the prototype lowpass, and
    upconverted to its center k*fs/n_chan.  Used as the TX-side oracle for
    wideband RX tests and the config-5 capture builder; channels that are
    all-zero are skipped, so synthesizing a sparse capture is cheap.
    Filtering is FFT-based (exact linear convolution, truncated to the
    capture length like np.convolve(...)[:wide_len]).
    """
    chans = np.asarray(chans)
    M, N = chans.shape
    active = np.nonzero(np.abs(chans).sum(axis=0))[0]
    return synthesize_bursts(
        M * N, N, [(int(k), 0, chans[:, k]) for k in active], taps=taps
    )


def synthesize_bursts(wide_len: int, n_chan: int, bursts,
                      taps: np.ndarray | None = None) -> np.ndarray:
    """Sparse synthesis filterbank: place per-channel bursts into one
    wideband stream (host-side numpy).

    bursts: iterable of (channel k, per-channel offset, complex samples).
    Each burst is upsampled by n_chan, shaped with the prototype lowpass
    (exact FFT-based linear convolution over just the burst's footprint),
    upconverted to k*fs/n_chan with ABSOLUTE-index phase (so overlapping
    bursts on one channel stay coherent), and summed.  Cost scales with the
    occupied samples, not the capture length -- building a long config-5
    capture with a handful of frames is cheap.
    """
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    out = np.zeros(wide_len, np.complex128)
    for k, off, f in bursts:
        f = np.asarray(f)
        seg = np.zeros(len(f) * n_chan, np.complex128)
        seg[::n_chan] = f
        L = len(seg) + len(taps_np) - 1
        nfft = 1 << max(1, (L - 1).bit_length())
        s = np.fft.ifft(np.fft.fft(seg, nfft) * np.fft.fft(taps_np, nfft))[:L]
        pos = off * n_chan
        end = min(wide_len, pos + L)
        nn = np.arange(pos, end)
        out[pos:end] += s[: end - pos] * np.exp(2j * np.pi * k * nn / n_chan)
    return out.astype(np.complex64)


def channelizer_block(n_chan: int, taps: np.ndarray | None = None) -> Block:
    """Streaming channelizer Block: (block,) samples -> (n_out, n_chan)
    channel samples per step; carries a raw-sample overlap-save tail.
    Block size must be a multiple of n_chan."""
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    poly = jnp.asarray(polyphase_decompose(taps_np, n_chan))
    C = stream_tail_len(n_chan, taps_np)

    def init():
        return np.zeros((C,), dtype=np.complex64)

    def apply(tail, x):
        out, new_tail = channelize_stream(x, tail, n_chan, taps_np, poly)
        return new_tail, out

    return Block(init, apply, f"pfb_channelizer({n_chan})")
