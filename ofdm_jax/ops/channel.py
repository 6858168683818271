"""Channel models for loopback testing.

JAX equivalent of channels::channel_model (SURVEY.md §2b,
gr-channels/lib/channel_model_impl.cc, unverified path): AWGN + carrier
frequency offset + static phase + multipath FIR + integer timing offset.
Pure-functional with an explicit PRNG key (deterministic-seed fake channel,
mirroring the reference's use of channel_model as the test fixture,
SURVEY.md §4 "Fixtures/fakes").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def awgn(key: jax.Array, x: jnp.ndarray, snr_db: float,
         signal_power: jnp.ndarray | float | None = None) -> jnp.ndarray:
    """Add complex white Gaussian noise at the given SNR (dB).  If
    signal_power is None it is measured from x."""
    if signal_power is None:
        signal_power = jnp.mean(jnp.abs(x) ** 2)
    noise_pow = signal_power / (10.0 ** (snr_db / 10.0))
    kr, ki = jax.random.split(key)
    shape = x.shape
    noise = (jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
    return (x + noise * jnp.sqrt(noise_pow / 2.0)).astype(jnp.complex64)


def apply_cfo(x: jnp.ndarray, cfo_subcarriers: float, fft_len: int,
              phase: float = 0.0) -> jnp.ndarray:
    """Multiply by exp(j (2 pi cfo n / N + phase)) along the last axis."""
    n = jnp.arange(x.shape[-1], dtype=jnp.float32)
    ph = 2.0 * jnp.pi * cfo_subcarriers * n / fft_len + phase
    return (x * jnp.exp(1j * ph)).astype(jnp.complex64)


def multipath(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Causal FIR multipath: y[n] = sum_k taps[k] x[n-k], same length as x."""
    taps = jnp.asarray(taps, dtype=jnp.complex64)
    k = taps.shape[0]
    xp = jnp.concatenate([jnp.zeros((*x.shape[:-1], k - 1), x.dtype), x], axis=-1)
    # correlation with reversed taps == convolution
    y = jnp.convolve(xp.reshape(-1), taps, mode="valid") if x.ndim == 1 else None
    if y is None:
        flat = xp.reshape(-1, xp.shape[-1])
        y = jax.vmap(lambda v: jnp.convolve(v, taps, mode="valid"))(flat)
        y = y.reshape(*x.shape[:-1], -1)
    return y[..., : x.shape[-1]].astype(jnp.complex64)


def timing_offset(x: jnp.ndarray, delay: int) -> jnp.ndarray:
    """Prepend `delay` zero samples (static shift; grows the array)."""
    if delay == 0:
        return x
    z = jnp.zeros((*x.shape[:-1], delay), dtype=x.dtype)
    return jnp.concatenate([z, x], axis=-1)


def ofdm_signal_power(spec) -> float:
    """Per-sample TX power of an OFDM frame from this modem: the IFFT of
    n_occupied unit-power carriers over fft_len bins, times the TX scale --
    what channel_block's signal_power should be for a loopback graph whose
    realized per-FRAME-sample SNR must equal the requested snr_db (ADVICE r3:
    the generic 1.0 default under-delivers SNR by ~0.9 dB for the default
    64-FFT config, n_occupied/fft_len ~ 0.81)."""
    return float(spec.n_occupied) / float(spec.fft_len) * float(
        getattr(spec, "scale", 1.0)) ** 2


def channel_block(
    seed: int = 0,
    snr_db: float | None = None,
    cfo: float = 0.0,
    fft_len: int = 64,
    taps=None,
    phase: float = 0.0,
    signal_power: float | str = "ofdm",
):
    """Streaming channel-model Block (registrable in grc.REGISTRY): the
    block-at-a-time form of channel_model for executor-driven loopback
    flowgraphs (cf. channels::channel_model as a live flowgraph node,
    SURVEY.md §2b).  1-D sample streams only (the multipath history carry
    is a fixed (k_hist,) buffer); use channel_model directly for batched
    captures.

    Carries (PRNG key, CFO phase accumulator, multipath history) so the
    impairments are CONTINUOUS across block boundaries: the CFO rotation
    picks up where the previous block ended, and the FIR multipath sees the
    last len(taps)-1 samples of the previous block.  AWGN here is sized
    against a STATIC `signal_power`, not measured per block, because a
    block may be mostly inter-frame silence.  The default "ofdm" derives it
    from the default-carrier-map OFDM spec at this fft_len
    (ofdm_signal_power: n_occupied/fft_len, ~0.81 at 64-FFT), so a loopback
    graph's realized per-frame-sample SNR equals the requested snr_db
    (ADVICE r3: the old 1.0 default under-delivered by ~0.9 dB).  Pass an
    explicit float for non-OFDM sources, custom carrier maps, or a TX scale
    != 1 (use ofdm_signal_power(spec) for the latter two).
    """
    import numpy as np

    from ofdm_jax.stream.block import Block

    if signal_power == "ofdm":
        from ofdm_jax.config import OfdmConfig

        signal_power = ofdm_signal_power(OfdmConfig(fft_len=fft_len).spec)

    taps_np = None if taps is None else np.asarray(taps, np.complex64)
    k_hist = 0 if taps_np is None else len(taps_np) - 1

    def init():
        return (
            np.asarray(jax.random.PRNGKey(seed)),
            np.zeros((), np.float32),                  # CFO phase (radians)
            np.zeros(k_hist, np.complex64),            # multipath history
        )

    def apply(state, x):
        if x.ndim != 1:
            raise ValueError(
                "channel_block is a 1-D-stream block (its multipath history "
                "carry is (k_hist,)); vmap channel_model for batched inputs"
            )
        key, ph0, hist = state
        y = x
        if taps_np is not None:
            ext = jnp.concatenate([hist, y], axis=-1)
            y = multipath(ext, taps_np)[..., k_hist:]
            hist = ext[..., -k_hist:] if k_hist else hist
        n = jnp.arange(y.shape[-1], dtype=jnp.float32)
        w = jnp.float32(2.0 * jnp.pi * cfo / fft_len)
        y = (y * jnp.exp(1j * (w * n + ph0 + phase))).astype(jnp.complex64)
        ph1 = jnp.mod(ph0 + w * y.shape[-1], 2.0 * jnp.pi)
        if snr_db is not None:
            key, sub = jax.random.split(key)
            y = awgn(sub, y, snr_db, signal_power=signal_power)
        return (key, ph1, hist), y

    return Block(init, apply, "channel_model")


def channel_model(
    key: jax.Array,
    x: jnp.ndarray,
    snr_db: float | None = None,
    cfo: float = 0.0,
    fft_len: int = 64,
    taps: jnp.ndarray | None = None,
    delay: int = 0,
    phase: float = 0.0,
) -> jnp.ndarray:
    """Composite channel: multipath -> CFO/phase -> delay -> AWGN.

    Order matches the golden model's channel() so tests can cross-validate.
    SNR is measured against the CLEAN input power (pre-channel), like golden.
    """
    sig_pow = jnp.mean(jnp.abs(x) ** 2)
    y = x
    if taps is not None:
        y = multipath(y, taps)
    y = apply_cfo(y, cfo, fft_len, phase)
    y = timing_offset(y, delay)
    if snr_db is not None:
        y = awgn(key, y, snr_db, signal_power=sig_pow)
    return y
