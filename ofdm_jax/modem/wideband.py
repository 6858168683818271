"""Wideband RX: polyphase channelizer -> N parallel OFDM demods, one Block.

JAX equivalent of the reference's wideband pattern (SURVEY.md §2c
"DP over channels": N independent demod chains -- N flowgraph subtrees --
after a pfb_channelizer_ccf; BASELINE.json config 4).  Instead of N thread
groups, the N channels ride a vmapped batch axis through ONE jitted RX:
the channelizer's FIR arms and the per-channel FFT batch are array ops
over the channel axis, and on a multi-device mesh the channel axis shards
(shard.rx handles the sharded-capture variant).

Carry = (channelizer history rows, per-channel RX sample history, step).
Per-channel sample rate is fs / n_chan; each step consumes `block_size`
wideband samples and advances every channel by block_size / n_chan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ofdm_jax.config import OfdmSpec, StreamConfig
from ofdm_jax.modem.rx import RxBlockResult, rx_block
from ofdm_jax.modem.rx_stream import history_len
from ofdm_jax.spectrum.channelizer import (
    channelize_stream,
    lowpass_taps,
    polyphase_decompose,
    stream_tail_len,
)
from ofdm_jax.stream.block import Block


class WidebandRxOut(NamedTuple):
    result: RxBlockResult     # leaves lead with (n_chan, K, ...)
    block_index: jnp.ndarray  # () int32


def wideband_rx_block(
    spec: OfdmSpec,
    n_chan: int,
    stream_cfg: StreamConfig,
    taps: np.ndarray | None = None,
    equalizer: str = "pilot_phase",
) -> Block:
    """Channelizer + N parallel streaming OFDM RX chains as one Block.

    stream_cfg.block_size counts WIDEBAND samples and must be a multiple of
    n_chan; per-channel blocks are block_size // n_chan samples.
    """
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    poly = jnp.asarray(polyphase_decompose(taps_np, n_chan))
    C = stream_tail_len(n_chan, taps_np)

    H = history_len(spec)
    S = stream_cfg.block_size // n_chan
    if S * n_chan != stream_cfg.block_size:
        raise ValueError("block_size must be a multiple of n_chan")
    K = stream_cfg.max_frames_per_block

    def init():
        return (
            np.zeros((C,), dtype=np.complex64),         # channelizer tail
            np.zeros((n_chan, H), dtype=np.complex64),  # per-chan history
            np.zeros((), dtype=np.int32),               # step
        )

    def apply(state, x):
        ch_tail, rx_hist, step = state
        chans, new_tail = channelize_stream(x, ch_tail, n_chan, taps_np, poly)
        chans = jnp.swapaxes(chans, -1, -2)                 # (n_chan, S)

        ext = jnp.concatenate([rx_hist, chans], axis=-1)    # (n_chan, H + S)
        res = jax.vmap(
            lambda row: rx_block(
                spec, row, max_frames=K, own_lo=0, own_hi=S,
                equalizer=equalizer,
            )
        )(ext)

        new_state = (
            new_tail,
            ext[..., S:],
            step + 1,
        )
        return new_state, WidebandRxOut(res, step)

    return Block(
        init, apply, f"wideband_rx({n_chan})", latency=H * n_chan + C
    )


def collect_wideband_frames(outs, per_chan_block: int, spec: OfdmSpec):
    """Flatten WidebandRxOut steps -> frame dicts with channel + abs_start
    in PER-CHANNEL sample units (host-side)."""
    H = history_len(spec)
    frames = []
    for o in outs:
        valid = np.asarray(o.result.valid)        # (n_chan, K)
        step = int(np.asarray(o.block_index))
        for c, k in zip(*np.nonzero(valid)):
            f = o.result.frames
            plen = int(np.asarray(f.payload_len)[c, k])
            frames.append(
                {
                    "channel": int(c),
                    "payload": bytes(np.asarray(f.payload)[c, k][:plen]),
                    "frame_num": int(np.asarray(f.frame_num)[c, k]),
                    "crc_ok": bool(np.asarray(f.crc_ok)[c, k]),
                    "evm": float(np.asarray(f.evm)[c, k]),
                    "abs_start": step * per_chan_block - H
                    + int(np.asarray(o.result.starts)[c, k]),
                }
            )
    return frames
