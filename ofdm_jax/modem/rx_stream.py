"""Streaming OFDM receiver: the RX chain as an executor Block.

This is the static-shape streaming counterpart of modem.rx -- it replaces
the reference's continuously-running ofdm_rx flowgraph (SURVEY.md §3.3)
including the implicit cross-iteration state GNU Radio keeps in buffers and
block members: sample history (set_history/overlap-save), the absolute
sample counter behind stream tags, and frame deduplication at block seams.

Mechanics (SURVEY.md §7 decisions 1-3):
  carry = (history[H], abs_offset) with H >= max_frame_len + 2*sym_len.
  Each step processes ext = [history | new_block]; detections are accepted
  only if their start lies in the ownership window [0, block_size) of ext
  coordinates shifted by -H... i.e. exactly the samples that entered one
  step ago, so every frame is reported exactly once no matter how it
  straddles block boundaries, at a fixed latency of H samples.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ofdm_jax.config import OfdmSpec, StreamConfig
from ofdm_jax.modem.rx import RxBlockResult, rx_block
from ofdm_jax.stream.block import Block


class RxStreamOut(NamedTuple):
    result: RxBlockResult     # frame slots for this step
    block_index: jnp.ndarray  # () int32 steps processed before this one
    # Absolute sample positions are derived HOST-side (collect_frames) as
    # block_index*block_size - history_len + start, with Python ints --
    # device-side int32 would wrap after ~2^31 samples of capture.


def history_len(spec: OfdmSpec) -> int:
    """Carry length: a full frame + margin for the sync metric windows,
    rounded up to a multiple of 1024 samples.  The stream contract, the
    shard code and the tests depend on this value; whether the rounding
    helps on the GPU is not measured."""
    need = spec.max_frame_len + 2 * spec.sym_len
    return -(-need // 1024) * 1024


def rx_stream_block(
    spec: OfdmSpec,
    stream_cfg: StreamConfig,
    equalizer: str = "pilot_phase",
    output: str = "hard",
) -> Block:
    H = history_len(spec)
    S = stream_cfg.block_size
    K = stream_cfg.max_frames_per_block

    def init():
        # history starts as synthetic zeros occupying absolute [-H, 0); the
        # first step's ownership window is therefore absolute [-H, -H+S).
        import numpy as np

        return (
            np.zeros(H, dtype=np.complex64),    # history
            np.zeros((), dtype=np.int32),       # step counter
        )

    def apply(state, x):
        from ofdm_jax.utils.device_io import PackedComplex, encode

        hist, step = state
        # per-PLANE concat: detection and the slot gathers read f32 planes,
        # so the extended buffer is built and consumed as planes and complex
        # is rebuilt only on the small per-slot windows inside rx_block.
        he = encode(jnp.asarray(hist, dtype=jnp.complex64))
        xe = encode(jnp.asarray(x, dtype=jnp.complex64))
        ext_re = jnp.concatenate([he.re, xe.re], axis=-1)
        ext_im = jnp.concatenate([he.im, xe.im], axis=-1)
        # ownership: starts within [0, S) of ext coords = absolute
        # [step*S - H, step*S - H + S) -- tiles the stream exactly
        res = rx_block(
            spec, PackedComplex(ext_re, ext_im), max_frames=K,
            own_lo=0, own_hi=S, equalizer=equalizer, output=output,
        )
        new_hist = (ext_re[S:S + H] + 1j * ext_im[S:S + H]).astype(
            jnp.complex64)
        out = RxStreamOut(res, step)
        return (new_hist, step + 1), out

    return Block(init, apply, "ofdm_rx_stream", latency=H)


def collect_frames(outs, block_size: int | None = None, hist: int | None = None):
    """Flatten a list of RxStreamOut (one per step) into a list of dicts for
    valid frames, host-side (the message-port/PDU sink equivalent).

    If block_size/hist are given, each frame carries "abs_start", the
    absolute sample index of its detected start in the fed stream.
    """
    import numpy as np

    frames = []
    for o in outs:
        valid = np.asarray(o.result.valid)
        step = int(np.asarray(o.block_index))
        for i in np.nonzero(valid)[0]:
            f = o.result.frames
            plen = int(np.asarray(f.payload_len)[i])
            rec_start = int(np.asarray(o.result.starts)[i])
            abs_start = (
                step * block_size - hist + rec_start
                if block_size is not None and hist is not None
                else rec_start
            )
            frames.append(
                {
                    "payload": bytes(np.asarray(f.payload)[i][:plen]),
                    "payload_len": plen,
                    "frame_num": int(np.asarray(f.frame_num)[i]),
                    "crc_ok": bool(np.asarray(f.crc_ok)[i]),
                    "hdr_ok": bool(np.asarray(f.hdr_ok)[i]),
                    "evm": float(np.asarray(f.evm)[i]),
                    "int_cfo": int(np.asarray(f.int_cfo)[i]),
                    "fine_cfo": float(np.asarray(o.result.fine_cfo)[i]),
                    "abs_start": abs_start,
                }
            )
            if f.llr.shape[-1]:  # soft-output RX: wire-byte LLRs incl CRC32
                frames[-1]["llr"] = np.asarray(f.llr)[i][: (plen + 4) * 8]
    return frames
