"""OFDM packet header generation and parsing.

JAX equivalent of packet_headergenerator_bb / packet_headerparser_b
with the packet_header_ofdm format (SURVEY.md §2b "Header/payload machinery",
gr-digital/lib/packet_header_ofdm.cc, unverified path): 12-bit payload length
(bytes), 12-bit frame number, 8-bit CRC8 -- 32 bits, BPSK-mapped onto one
OFDM symbol's data carriers (zero-padded).  Matches the golden model exactly.
"""

from __future__ import annotations

import jax.numpy as jnp

from ofdm_jax.config import (
    HEADER_BITS,
    HEADER_CRC_BITS,
    HEADER_LEN_BITS,
    HEADER_NUM_BITS,
    OfdmSpec,
)
from ofdm_jax.ops.crc import crc8_bits
from ofdm_jax.utils.bits import bits_to_uint, uint_to_bits


def make_header_bits(payload_len: jnp.ndarray, frame_num: jnp.ndarray) -> jnp.ndarray:
    """(...,) lengths + frame numbers -> (..., 32) header bits."""
    lbits = uint_to_bits(payload_len.astype(jnp.uint32), HEADER_LEN_BITS)
    nbits = uint_to_bits(
        frame_num.astype(jnp.uint32) % (1 << HEADER_NUM_BITS), HEADER_NUM_BITS
    )
    body = jnp.concatenate([lbits, nbits], axis=-1)
    if body.ndim == 1:
        crc = crc8_bits(body)
    else:
        import jax

        crc = jax.vmap(crc8_bits)(body.reshape(-1, body.shape[-1])).reshape(
            body.shape[:-1]
        )
    cbits = uint_to_bits(crc, HEADER_CRC_BITS)
    return jnp.concatenate([body, cbits], axis=-1)


def parse_header_bits(bits: jnp.ndarray):
    """(32,) header bits -> (payload_len:int32, frame_num:int32, crc_ok:bool)."""
    body = bits[: HEADER_LEN_BITS + HEADER_NUM_BITS]
    plen = bits_to_uint(body[:HEADER_LEN_BITS], HEADER_LEN_BITS).astype(jnp.int32)
    fnum = bits_to_uint(body[HEADER_LEN_BITS:], HEADER_NUM_BITS).astype(jnp.int32)
    got = bits_to_uint(bits[HEADER_LEN_BITS + HEADER_NUM_BITS: HEADER_BITS],
                       HEADER_CRC_BITS)
    ok = got == crc8_bits(body)
    return plen, fnum, ok


def header_padding(spec: OfdmSpec) -> int:
    if spec.n_data < HEADER_BITS:
        raise ValueError("need >= 32 data carriers for the header symbol")
    return spec.n_data - HEADER_BITS
