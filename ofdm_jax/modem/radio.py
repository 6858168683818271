"""Full-duplex OFDM radio: TX + RX as one executor Block.

JAX counterpart of gr-ofdm_tools' ofdm_radio_hier (SURVEY.md §2a row
1: the hier block wrapping digital.ofdm_tx and digital.ofdm_rx into one
full-duplex modem, python/ofdm_radio_hier.py, unverified path).  One jitted
step consumes (queued TX payload slots, received sample block) and produces
(modulated sample block, demodulated frame slots) -- both directions ride a
single XLA program per time-block, where the reference ran two independent
thread pools.

State is simply (tx_state, rx_state); the directions share no carry, as in
the reference (TX and RX of a transceiver are independent signal paths).
"""

from __future__ import annotations

from typing import NamedTuple

from ofdm_jax.config import OfdmSpec, StreamConfig
from ofdm_jax.modem.rx_stream import RxStreamOut, rx_stream_block
from ofdm_jax.modem.tx_stream import TxStreamIn, TxStreamOut, tx_stream_block
from ofdm_jax.stream.block import Block


class RadioOut(NamedTuple):
    tx: TxStreamOut   # samples to the air interface + accepted mask
    rx: RxStreamOut   # demodulated frame slots from the received block


def ofdm_radio(
    spec: OfdmSpec,
    stream_cfg: StreamConfig,
    equalizer: str = "pilot_phase",
    output: str = "hard",
    tx_gap: int | None = None,
) -> Block:
    """Full-duplex modem Block.

    Input per step: (TxStreamIn, rx_samples[block_size]).
    Output per step: RadioOut(tx=TxStreamOut, rx=RxStreamOut).
    """
    tx = tx_stream_block(spec, stream_cfg, gap=tx_gap)
    rx = rx_stream_block(spec, stream_cfg, equalizer=equalizer, output=output)

    def init():
        return (tx.init(), rx.init())

    def apply(state, x):
        tx_in, rx_samples = x
        ts, rs = state
        ts, tout = tx.apply(ts, TxStreamIn(*tx_in))
        rs, rout = rx.apply(rs, rx_samples)
        return (ts, rs), RadioOut(tout, rout)

    return Block(init, apply, "ofdm_radio", latency=rx.latency,
                 stream_input=False)
