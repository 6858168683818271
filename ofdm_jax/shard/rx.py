"""Sharded OFDM RX over a (channel x time) device mesh.

The multi-device execution model replacing the reference's "N independent
flowgraphs + sockets" scaling story (SURVEY.md §2c):

  * channel axis: pure data parallelism -- each device demodulates its own
    subset of channels (the N demod chains after pfb_channelizer_ccf).
  * time axis: sequence parallelism over a long capture -- each shard
    processes [left-halo | local] samples (overlap-save via ppermute,
    shard.halo) and OWNS detections whose start falls in its tiling window,
    so every frame is reported by exactly one shard no matter how it
    straddles a shard boundary (SURVEY.md §7 hard part 2's ownership rule).

The ownership tiling matches modem.rx_stream exactly: shard t's ext buffer
is [H halo | S local] with ext[0] at absolute t*S - H, and it owns ext
positions [0, S) = absolute [t*S - H, (t+1)*S - H).  A frame starting in
the owned window always has its full max_frame_len of samples inside ext
(H = max_frame_len + 2*sym_len guarantees the margin).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ofdm_jax.config import OfdmSpec
from ofdm_jax.modem.rx import RxBlockResult, rx_block
from ofdm_jax.modem.rx_stream import history_len
from ofdm_jax.shard.halo import extend_with_left_halo, halo_from_left
from ofdm_jax.shard.mesh import CHANNEL_AXIS, TIME_AXIS
from ofdm_jax.stream.block import Block

try:  # JAX >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


def sharded_rx_capture_fn(
    spec: OfdmSpec,
    mesh,
    shard_len: int,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
):
    """Build the jittable sharded-capture RX: (C, T*shard_len) complex64
    -> RxBlockResult with leading (C, T*K) axes + per-slot local starts.

    C must be divisible by the mesh's channel axis and T by its time axis.
    The caller wraps with device_io.packed_io/jit as needed.
    """
    H = history_len(spec)
    S = shard_len
    K = max_frames_per_shard

    def demod_ext(ext):  # ext: (c_local, H + S) -- halo-extended local block
        def one(row):
            return rx_block(
                spec, row, max_frames=K, own_lo=0, own_hi=S, equalizer=equalizer
            )

        res: RxBlockResult = jax.vmap(one)(ext)   # leaves: (c_local, K, ...)
        return res

    def local_step(x):  # x: (c_local, S) -- one device's raw block
        return demod_ext(extend_with_left_halo(x, H))

    def out_spec_like(leaf):
        # leaves are (c_local, K, ...): channel axis shards dim 0, time axis
        # concatenates shard results along the K dim -> global (C, T*K, ...)
        extra = (None,) * (leaf.ndim - 2)
        return P(CHANNEL_AXIS, TIME_AXIS, *extra)

    def fn(samples):  # (C, T*S) global
        # out_specs derived from a collective-free stand-in (eval_shape must
        # not trace ppermute outside the mesh context)
        c_local = samples.shape[0] // mesh.shape[CHANNEL_AXIS]
        shapes = jax.eval_shape(
            demod_ext, jax.ShapeDtypeStruct((c_local, H + S), samples.dtype)
        )
        mapped = shard_map(
            local_step,
            mesh=mesh,
            in_specs=P(CHANNEL_AXIS, TIME_AXIS),
            out_specs=jax.tree.map(out_spec_like, shapes),
            check_vma=False,
        )
        return mapped(samples)

    return fn


class ShardedStreamOut(NamedTuple):
    result: RxBlockResult     # frame slots, leading (C, T*K) axes
    chunk_index: jnp.ndarray  # () int32 chunks processed before this one


def sharded_rx_stream_block(
    spec: OfdmSpec,
    mesh,
    n_channels: int,
    shard_len: int,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
) -> Block:
    """RESUMABLE sharded streaming RX: an executor Block whose one step
    demodulates a (C, T*shard_len) chunk over the (channel x time) mesh.

    carry = (tail, step): `tail` is the last H = history_len samples of the
    previous chunk per channel, (C, H) complex64.  Inside the chunk every
    time shard fetches its left halo via ppermute (shard.halo); shard 0 --
    which has no left neighbor -- takes the carry instead, so the ownership
    tiling of modem.rx_stream extends seamlessly ACROSS chunks: shard t of
    chunk k owns absolute [(k*T + t)*S - H, (k*T + t)*S - H + S), every
    frame reported exactly once however it straddles a chunk boundary.

    Because the carry is an explicit pytree, stream.checkpoint.save_state /
    load_state work unchanged: a killed multi-host capture resumes at the
    chunk boundary with zero frames lost or duplicated (SURVEY.md §5
    "Failure detection / elastic recovery"; the reference has nothing --
    a stopped flowgraph loses all sync state).
    """
    H = history_len(spec)
    S = shard_len
    K = max_frames_per_shard
    n_t = mesh.shape[TIME_AXIS]
    n_c = mesh.shape[CHANNEL_AXIS]
    assert n_channels % n_c == 0, (n_channels, n_c)
    c_local = n_channels // n_c

    def init():
        return (
            np.zeros((n_channels, H), dtype=np.complex64),
            np.zeros((), dtype=np.int32),
        )

    def demod_ext(ext):  # (c_local, H + S)
        def one(row):
            return rx_block(
                spec, row, max_frames=K, own_lo=0, own_hi=S,
                equalizer=equalizer,
            )

        return jax.vmap(one)(ext)

    def local_step(tail, x):  # tail: (c_local, H) replicated over time axis
        halo = halo_from_left(x, H)
        t = jax.lax.axis_index(TIME_AXIS)
        halo = jnp.where(t == 0, tail, halo)
        ext = jnp.concatenate([halo, x.astype(jnp.complex64)], axis=-1)
        return demod_ext(ext), ext[..., -H:]

    def out_spec_like(leaf):
        extra = (None,) * (leaf.ndim - 2)
        return P(CHANNEL_AXIS, TIME_AXIS, *extra)

    def apply(state, samples):  # samples: (C, T*S)
        tail, step = state
        shapes = jax.eval_shape(
            demod_ext, jax.ShapeDtypeStruct((c_local, H + S), jnp.complex64)
        )
        mapped = shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(CHANNEL_AXIS, None), P(CHANNEL_AXIS, TIME_AXIS)),
            out_specs=(
                jax.tree.map(out_spec_like, shapes),
                P(CHANNEL_AXIS, TIME_AXIS),
            ),
            check_vma=False,
        )
        res, tails = mapped(tail, samples.astype(jnp.complex64))
        new_tail = tails[:, -H:]  # the LAST time shard's tail
        out = ShardedStreamOut(res, step)
        return (new_tail, step + 1), out

    return Block(init, apply, f"sharded_rx_stream({n_channels}ch)", latency=H)


def collect_sharded_stream_frames(outs, shard_len: int, spec: OfdmSpec,
                                  n_time: int):
    """Flatten ShardedStreamOut chunks into frame dicts with ABSOLUTE start
    positions in the global per-channel stream (host-side PDU sink)."""
    H = history_len(spec)
    frames = []
    for o in outs:
        step = int(np.asarray(o.chunk_index))
        valid = np.asarray(o.result.valid)
        K = valid.shape[1] // n_time
        for c in range(valid.shape[0]):
            for j in np.nonzero(valid[c])[0]:
                t, _ = divmod(int(j), K)
                f = o.result.frames
                plen = int(np.asarray(f.payload_len)[c, j])
                frames.append(
                    {
                        "channel": c,
                        "payload": bytes(np.asarray(f.payload)[c, j][:plen]),
                        "payload_len": plen,
                        "frame_num": int(np.asarray(f.frame_num)[c, j]),
                        "crc_ok": bool(np.asarray(f.crc_ok)[c, j]),
                        "evm": float(np.asarray(f.evm)[c, j]),
                        "abs_start": (step * n_time + t) * shard_len - H
                        + int(np.asarray(o.result.starts)[c, j]),
                    }
                )
    frames.sort(key=lambda d: (d["channel"], d["abs_start"]))
    return frames


def collect_sharded_frames(res: RxBlockResult, shard_len: int, spec: OfdmSpec,
                           n_time: int):
    """Flatten a sharded-capture result into per-channel frame dicts with
    absolute start positions (host-side PDU sink equivalent)."""
    H = history_len(spec)
    K = np.asarray(res.valid).shape[1] // n_time
    frames = []
    valid = np.asarray(res.valid)
    C = valid.shape[0]
    for c in range(C):
        for j in np.nonzero(valid[c])[0]:
            t, k = divmod(int(j), K)
            f = res.frames
            plen = int(np.asarray(f.payload_len)[c, j])
            frames.append(
                {
                    "channel": c,
                    "payload": bytes(np.asarray(f.payload)[c, j][:plen]),
                    "payload_len": plen,
                    "frame_num": int(np.asarray(f.frame_num)[c, j]),
                    "crc_ok": bool(np.asarray(f.crc_ok)[c, j]),
                    "evm": float(np.asarray(f.evm)[c, j]),
                    "abs_start": t * shard_len - H
                    + int(np.asarray(res.starts)[c, j]),
                }
            )
    return frames
