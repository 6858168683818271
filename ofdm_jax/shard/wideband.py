"""BASELINE config 5: a wideband capture channelized and demodulated over a
(channel x time) device mesh.

The reference's only wideband-scaling story is "run N independent flowgraphs
behind a pfb_channelizer_ccf and ship results over sockets" (SURVEY.md §2c
DP row, gr-filter/lib/pfb_channelizer_ccf_impl.cc, unverified path).  Here
the whole capture is ONE jitted program over the mesh, in two stages:

  1. **Channelize, sharded over ALL devices.**  The flat wideband stream is
     split into contiguous chunks over the flattened (channel, time) device
     order; each device channelizes its chunk after fetching the
     stream_tail_len raw samples of its left neighbor with one ppermute
     ring step (the same overlap-save-as-halo pattern as shard.halo, over
     the flattened axis pair).
  2. **Demodulate, (channel x time) sharded.**  The channel rows transpose
     to (n_chan, M_total) and flow into shard.rx.sharded_rx_capture_fn;
     GSPMD inserts the all_to_all that redistributes stage-1's time-major
     rows into stage-2's channel-major layout (scaling-book recipe: annotate
     shardings, let XLA place collectives).  Frame ownership across time
     shards is exactly shard.rx's tiling -- every frame reported once,
     straddles included.

Constraints: n_chan % mesh.channel == 0, per_chan_shard % mesh.channel == 0
(so each device's stage-1 chunk is whole commutator loads).

Three entry points: sharded_wideband_capture_fn (one-shot capture, stream
start assumed), sharded_wideband_stream_block (the RESUMABLE streaming
form: raw-sample + channel-domain carries, checkpointable, exactly-once
across chunk boundaries), and mesh_psd_step_fn (the distributed analyzer's
PSD-consensus step).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ofdm_jax.config import OfdmSpec
from ofdm_jax.shard.mesh import CHANNEL_AXIS, TIME_AXIS
from ofdm_jax.shard.rx import sharded_rx_capture_fn
from ofdm_jax.spectrum.channelizer import (
    channelize_stream,
    lowpass_taps,
    polyphase_decompose,
    stream_tail_len,
)

try:  # JAX >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


def mesh_psd_step_fn(
    mesh,
    n_chan: int,
    nbins: int,
    taps: np.ndarray | None = None,
    window: str = "hann",
    floor: float = 1e-20,
):
    """Jittable distributed-analyzer step (the multi-device replacement for
    the reference's ship-every-PSD-over-a-socket design, SURVEY.md §5 last
    row): (tail, wideband block) -> ((n_chan, nbins) dB consensus PSD
    replicated on every device, new tail).

    Per step: the sharded channelizer (same raw-sample ppermute halo as
    sharded_wideband_capture_fn, with the FIRST device taking the carried
    cross-step tail) -> per-channel windowed PSD averaged over the block's
    frames -> `all_gather_spectrum` consensus (all_gather over the channel
    axis + pmean over time shards).  The returned tail is the block's last
    stream_tail_len raw samples; thread it back in as the next step's carry.
    Block length must be a multiple of n_chan * nbins (whole PSD frames per
    channel)."""
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    poly = jnp.asarray(polyphase_decompose(taps_np, n_chan))
    C_tail = stream_tail_len(n_chan, taps_np)
    n_c = mesh.shape[CHANNEL_AXIS]
    n_t = mesh.shape[TIME_AXIS]
    n_dev = n_c * n_t

    from ofdm_jax.shard.distributed import all_gather_spectrum
    from ofdm_jax.spectrum.psd import psd_frames

    def chan_local(tail, x):  # tail (C_tail,) replicated; x (L,) local chunk
        h = x[-C_tail:]
        if n_dev > 1:
            perm = [(i, i + 1) for i in range(n_dev - 1)]
            h = jax.lax.ppermute(h, (CHANNEL_AXIS, TIME_AXIS), perm)
        else:
            h = jnp.zeros_like(h)
        idx = (jax.lax.axis_index(CHANNEL_AXIS) * n_t
               + jax.lax.axis_index(TIME_AXIS))
        h = jnp.where(idx == 0, tail, h)
        out, _ = channelize_stream(x, h, n_chan, taps_np, poly)
        return out

    def step(tail, samples):  # samples: (n_chan * F * nbins * n_t,)
        x = samples.astype(jnp.complex64)
        rows = shard_map(
            chan_local,
            mesh=mesh,
            in_specs=(P(None), P((CHANNEL_AXIS, TIME_AXIS))),
            out_specs=P((CHANNEL_AXIS, TIME_AXIS), None),
            check_vma=False,
        )(tail.astype(jnp.complex64), x)
        chans = jnp.swapaxes(rows, 0, 1)          # (n_chan, M)
        p = psd_frames(chans, nbins, window)      # (n_chan, M//nbins, nbins)
        p_db = 10.0 * jnp.log10(jnp.maximum(p.mean(axis=-2), floor))
        full = all_gather_spectrum(p_db, mesh)    # replicated (n_chan, nbins)
        return full, x[-C_tail:]

    return step, C_tail


def flatten_band(psd_cn: np.ndarray) -> np.ndarray:
    """(n_chan, nbins) per-channel PSD -> one full-band vector ordered by
    absolute frequency (host-side presentation): flat[i] covers
    -fs/2 + i*fs/(n_chan*nbins).  Channel k is centered at k*fs/n_chan
    (wrapped), each channel's bins are FFT-ordered; fftshift both axes,
    flatten, then roll half a channel (the lowest channel straddles the
    -fs/2 wrap, so the shifted grid starts at -fs/2 - fs/(2*n_chan))."""
    shifted = np.fft.fftshift(psd_cn, axes=0)     # channels by center freq
    shifted = np.fft.fftshift(shifted, axes=1)    # bins within each channel
    return np.roll(shifted.reshape(-1), -(psd_cn.shape[1] // 2))


def sharded_wideband_stream_block(
    spec: OfdmSpec,
    mesh,
    n_chan: int,
    per_chan_shard: int,
    taps: np.ndarray | None = None,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
):
    """RESUMABLE streaming config-5 wideband RX: an executor Block whose one
    step channelizes AND demodulates a flat (n_chan * n_time * per_chan_shard,)
    wideband chunk over the (channel x time) mesh -- the continuously-running
    form of sharded_wideband_capture_fn (VERDICT r4 missing #1: the capture
    fn hard-zeroes device 0's channelizer halo, so it could only ever start
    a stream, never continue one).

    carry = (raw_tail, chan_tail, step):
      raw_tail  (stream_tail_len,) complex64 -- the raw wideband samples
                immediately preceding this chunk; device 0 of the flattened
                (channel, time) order takes it as its channelizer halo (the
                other devices ppermute theirs from the left neighbor), so
                the polyphase FIR state is continuous across chunks.  Raw
                samples, not commutator rows (channelize_stream's
                contract).
      chan_tail (n_chan, H) complex64 -- the last history_len channel-domain
                samples of the previous chunk; time shard 0 takes it as its
                demod halo, exactly sharded_rx_stream_block's carry, so the
                ownership tiling extends seamlessly across chunks: shard t
                of chunk k owns channel-domain absolute
                [(k*n_time + t)*S - H, ... + S), every frame reported
                exactly once however it straddles a chunk OR shard boundary.

    Both carries are explicit pytree leaves, so stream.checkpoint
    save_state/load_state work unchanged (kill/restart tested at 512
    channels in tests/test_shard_wideband.py).  Collect outputs with
    shard.rx.collect_sharded_stream_frames (channel-domain abs_start).
    """
    from ofdm_jax.modem.rx import rx_block
    from ofdm_jax.modem.rx_stream import history_len
    from ofdm_jax.shard.halo import halo_from_left
    from ofdm_jax.shard.rx import ShardedStreamOut
    from ofdm_jax.stream.block import Block

    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    poly = jnp.asarray(polyphase_decompose(taps_np, n_chan))
    C_tail = stream_tail_len(n_chan, taps_np)
    n_c = mesh.shape[CHANNEL_AXIS]
    n_t = mesh.shape[TIME_AXIS]
    n_dev = n_c * n_t
    S = per_chan_shard
    H = history_len(spec)
    K = max_frames_per_shard
    if n_chan % n_c:
        raise ValueError(f"n_chan={n_chan} not divisible by mesh channel={n_c}")
    if S % n_c:
        raise ValueError(f"per_chan_shard={S} not divisible by mesh "
                         f"channel={n_c} (stage-1 chunks must hold whole "
                         f"commutator loads)")
    c_local = n_chan // n_c
    chunk_len = n_chan * n_t * S

    def init():
        return (
            np.zeros(C_tail, dtype=np.complex64),
            np.zeros((n_chan, H), dtype=np.complex64),
            np.zeros((), dtype=np.int32),
        )

    def chan_local(rtail, x):  # rtail (C_tail,) replicated; x (L,) local
        h = x[-C_tail:]
        if n_dev > 1:
            perm = [(i, i + 1) for i in range(n_dev - 1)]
            h = jax.lax.ppermute(h, (CHANNEL_AXIS, TIME_AXIS), perm)
        else:
            h = jnp.zeros_like(h)
        idx = (jax.lax.axis_index(CHANNEL_AXIS) * n_t
               + jax.lax.axis_index(TIME_AXIS))
        h = jnp.where(idx == 0, rtail, h)
        out, _ = channelize_stream(x, h, n_chan, taps_np, poly)
        return out  # (L // n_chan, n_chan)

    def demod_ext(ext):  # (c_local, H + S)
        def one(row):
            return rx_block(spec, row, max_frames=K, own_lo=0, own_hi=S,
                            equalizer=equalizer)

        return jax.vmap(one)(ext)

    def demod_local(ctail, x):  # ctail (c_local, H) replicated over time
        halo = halo_from_left(x, H)
        t = jax.lax.axis_index(TIME_AXIS)
        halo = jnp.where(t == 0, ctail, halo)
        ext = jnp.concatenate([halo, x.astype(jnp.complex64)], axis=-1)
        return demod_ext(ext), ext[..., -H:]

    def out_spec_like(leaf):
        extra = (None,) * (leaf.ndim - 2)
        return P(CHANNEL_AXIS, TIME_AXIS, *extra)

    def apply(state, samples):  # samples: (n_chan * n_t * S,) flat wideband
        raw_tail, chan_tail, step = state
        x = samples.astype(jnp.complex64)
        rows = shard_map(
            chan_local,
            mesh=mesh,
            in_specs=(P(None), P((CHANNEL_AXIS, TIME_AXIS))),
            out_specs=P((CHANNEL_AXIS, TIME_AXIS), None),
            check_vma=False,
        )(raw_tail.astype(jnp.complex64), x)
        chans = jnp.swapaxes(rows, 0, 1)          # (n_chan, n_t * S)
        shapes = jax.eval_shape(
            demod_ext, jax.ShapeDtypeStruct((c_local, H + S), jnp.complex64)
        )
        res, tails = shard_map(
            demod_local,
            mesh=mesh,
            in_specs=(P(CHANNEL_AXIS, None), P(CHANNEL_AXIS, TIME_AXIS)),
            out_specs=(
                jax.tree.map(out_spec_like, shapes),
                P(CHANNEL_AXIS, TIME_AXIS),
            ),
            check_vma=False,
        )(chan_tail.astype(jnp.complex64), chans)
        out = ShardedStreamOut(res, step)
        new_state = (x[-C_tail:], tails[:, -H:], step + 1)
        return new_state, out

    return Block(init, apply, f"sharded_wideband_stream({n_chan}ch)",
                 latency=H * n_chan)


def sharded_wideband_capture_fn(
    spec: OfdmSpec,
    mesh,
    n_chan: int,
    per_chan_shard: int,
    taps: np.ndarray | None = None,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
):
    """Build the jittable config-5 capture: (n_chan * n_time * per_chan_shard,)
    wideband complex64 -> RxBlockResult with leading (n_chan, n_time * K)
    axes (collect with shard.rx.collect_sharded_frames).

    per_chan_shard is S, each time shard's per-channel sample count; frame
    ownership/abs_start semantics are identical to sharded_rx_capture_fn's.
    """
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    poly = jnp.asarray(polyphase_decompose(taps_np, n_chan))
    C_tail = stream_tail_len(n_chan, taps_np)
    n_c = mesh.shape[CHANNEL_AXIS]
    n_t = mesh.shape[TIME_AXIS]
    n_dev = n_c * n_t
    S = per_chan_shard
    if n_chan % n_c:
        raise ValueError(f"n_chan={n_chan} not divisible by mesh channel={n_c}")
    if S % n_c:
        raise ValueError(f"per_chan_shard={S} not divisible by mesh "
                         f"channel={n_c} (stage-1 chunks must hold whole "
                         f"commutator loads)")
    rx_fn = sharded_rx_capture_fn(
        spec, mesh, S, max_frames_per_shard=max_frames_per_shard,
        equalizer=equalizer,
    )

    def chan_local(x):  # (L,) local wideband chunk, L = n_chan * S / n_c
        tail = x[-C_tail:]
        if n_dev > 1:
            # left neighbor in the FLATTENED (channel, time) chunk order
            perm = [(i, i + 1) for i in range(n_dev - 1)]
            tail = jax.lax.ppermute(tail, (CHANNEL_AXIS, TIME_AXIS), perm)
        else:
            tail = jnp.zeros_like(tail)
        out, _ = channelize_stream(x, tail, n_chan, taps_np, poly)
        return out  # (L // n_chan, n_chan)

    def fn(samples):  # (n_chan * n_t * S,) global wideband
        rows = shard_map(
            chan_local,
            mesh=mesh,
            in_specs=P((CHANNEL_AXIS, TIME_AXIS)),
            out_specs=P((CHANNEL_AXIS, TIME_AXIS), None),
            check_vma=False,
        )(samples.astype(jnp.complex64))
        chans = jnp.swapaxes(rows, 0, 1)  # (n_chan, M_total)
        return rx_fn(chans)

    return fn
