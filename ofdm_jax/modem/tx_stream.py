"""Streaming OFDM transmitter: the TX chain as an executor Block.

Static-shape streaming counterpart of modem.tx, mirroring the reference's
continuously-running TX flowgraph (SURVEY.md §3.2: the tagged-stream chain
from crc32_bb through ofdm_cyclic_prefixer runs forever, pulled by the
scheduler, emitting silence when no packets are queued).  Here:

  * input per step: a fixed-capacity batch of up to K payload slots
    (payloads, lens, frame_nums, valid) -- the device-side face of a host
    PduQueue (io.pdu), replacing the message-port PDU input of the
    reference's tagged-stream TX,
  * carry: a pending-sample buffer of B = block_size + K*(max_frame_len +
    gap) samples plus a write cursor -- the modulated stream that has not
    yet been emitted (frames straddle block boundaries exactly as in the
    reference's circular buffers),
  * output per step: exactly block_size samples (frames + inter-frame
    silence) plus an `accepted` mask -- a slot is refused (back-pressure)
    when the pending buffer cannot hold it, and the host re-queues it.

Frame placement uses dynamic_slice + dynamic_update_slice (read-modify-
write) rather than element scatter: frames are laid down at the running
cursor, and adding the zero-padded tail of one frame over the head of the
next is harmless (zeros), so no masking is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmSpec, StreamConfig
from ofdm_jax.modem.tx import tx_frames
from ofdm_jax.stream.block import Block


class TxStreamIn(NamedTuple):
    payloads: jnp.ndarray   # (K, max_payload_bytes - 4) uint8
    lens: jnp.ndarray       # (K,) int32 valid bytes per slot
    frame_nums: jnp.ndarray  # (K,) int32
    valid: jnp.ndarray      # (K,) bool: slot holds a queued PDU


class TxStreamOut(NamedTuple):
    samples: jnp.ndarray    # (block_size,) complex64 continuous TX stream
    accepted: jnp.ndarray   # (K,) bool: slot was modulated this step
    n_pending: jnp.ndarray  # () int32 samples still queued after this step


def empty_tx_in(spec: OfdmSpec, k: int):
    """Host-side all-invalid input batch (numpy; the executor packs it)."""
    import numpy as np

    return TxStreamIn(
        np.zeros((k, spec.max_payload_bytes - 4), np.uint8),
        np.zeros(k, np.int32),
        np.zeros(k, np.int32),
        np.zeros(k, bool),
    )


def queue_tx_in(spec: OfdmSpec, k: int, pdus, frame_num0: int = 0):
    """Pack up to k (payload bytes, frame_num) host PDUs into a TxStreamIn;
    returns (tx_in, leftover_pdus)."""
    import numpy as np

    ti = empty_tx_in(spec, k)
    cap = spec.max_payload_bytes - 4
    for i, p in enumerate(pdus[:k]):
        data = bytes(p)[:cap]
        ti.payloads[i, : len(data)] = np.frombuffer(data, np.uint8)
        ti.lens[i] = len(data)
        ti.frame_nums[i] = frame_num0 + i
        ti.valid[i] = True
    return ti, list(pdus[k:])


def tx_stream_block(
    spec: OfdmSpec,
    stream_cfg: StreamConfig,
    gap: int | None = None,
) -> Block:
    """Continuous transmitter Block (see module docstring).

    gap: inter-frame silence in samples (default cp_len*4 -- enough for the
    RX detector's NMS row granularity, see ops.sync.min_frame_gap; any
    value >= 0 is legal because frames themselves exceed min_frame_gap).
    """
    S = stream_cfg.block_size
    K = stream_cfg.max_frames_per_block
    F = spec.max_frame_len
    if gap is None:
        gap = 4 * spec.cp_len
    B = S + K * (F + gap)

    def init():
        import numpy as np

        return (
            np.zeros(B, dtype=np.complex64),   # pending samples
            np.zeros((), dtype=np.int32),      # write cursor
        )

    def apply(state, x: TxStreamIn):
        buf, cur = state
        frames = tx_frames(spec, x.payloads, x.lens, x.frame_nums)

        def place(carry, slot):
            buf, cur = carry
            samples, n, ok = slot
            ok = ok & (cur + F <= B)
            contrib = jnp.where(ok, samples, 0.0 + 0.0j)
            start = jnp.minimum(cur, B - F)  # clamp; contrib=0 when refused
            window = jax.lax.dynamic_slice(buf, (start,), (F,))
            buf = jax.lax.dynamic_update_slice(buf, window + contrib, (start,))
            cur = cur + jnp.where(ok, n + gap, 0)
            return (buf, cur), ok

        (buf, cur), accepted = jax.lax.scan(
            place, (buf, cur), (frames.samples, frames.n_samples, x.valid)
        )
        out = buf[:S]
        buf = jnp.concatenate([buf[S:], jnp.zeros(S, buf.dtype)])
        cur = jnp.maximum(cur - S, 0)
        return (buf, cur), TxStreamOut(out, accepted, cur)

    return Block(init, apply, "ofdm_tx_stream", latency=0,
                 stream_input=False)
