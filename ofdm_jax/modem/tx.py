"""OFDM transmitter composite.

JAX equivalent of digital.ofdm_tx (SURVEY.md §3.2,
gr-digital/python/digital/ofdm_txrx.py, unverified path), i.e. the chain
crc32_bb -> packet_headergenerator_bb -> repack/chunks_to_symbols ->
ofdm_carrier_allocator_cvc -> fft_vcc(inverse) -> ofdm_cyclic_prefixer ->
multiply_const_cc -- but as ONE jitted pure function over fixed-capacity
frame buffers instead of nine thread-coupled blocks.

Variable packet length under static shapes (SURVEY.md §7 decision 2): every
frame occupies a (max_frame_len,) sample buffer; OFDM symbols beyond the
actual payload are zeroed (silence), and `n_samples` reports the true frame
length.  Bit/symbol conventions match tests/golden/golden_ofdm.py exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ofdm_jax.config import HEADER_BITS, OfdmSpec
from ofdm_jax.ops import carrier_alloc
from ofdm_jax.ops.constellation import map_bits
from ofdm_jax.ops.crc import append_crc32_bytes, crc32
from ofdm_jax.ops.header import make_header_bits
from ofdm_jax.ops.transform import add_cyclic_prefix, ofdm_ifft
from ofdm_jax.utils.bits import bytes_to_bits


class TxFrame(NamedTuple):
    samples: jnp.ndarray    # (max_frame_len,) complex64; zero beyond n_samples
    n_samples: jnp.ndarray  # () int32: true frame length incl. sync+header
    wire_len: jnp.ndarray   # () int32: payload bytes incl. CRC32


def tx_frame(
    spec: OfdmSpec,
    payload: jnp.ndarray,       # (max_payload_bytes - 4,) uint8 buffer
    payload_len: jnp.ndarray,   # () int32: valid bytes in `payload`
    frame_num: jnp.ndarray | int = 0,
) -> TxFrame:
    """Modulate one frame: [sync1 | sync2 | header | payload syms], CP each."""
    payload_len = jnp.asarray(payload_len, dtype=jnp.int32)
    frame_num = jnp.asarray(frame_num, dtype=jnp.int32)
    cap = spec.max_payload_bytes
    bps = spec.bits_per_symbol
    nd = spec.n_data

    # ---- crc32_bb equivalent: wire = payload || CRC32(payload) (LE) -------
    pay_buf = jnp.zeros(cap, dtype=jnp.uint8).at[: payload.shape[0]].set(payload)
    # zero bytes at/after payload_len so buffer junk can't leak into bits
    byte_idx = jnp.arange(cap, dtype=jnp.int32)
    pay_buf = jnp.where(byte_idx < payload_len, pay_buf, 0)
    crc = crc32(pay_buf, payload_len)
    crc_b = append_crc32_bytes(crc)
    wire_len = payload_len + 4
    # scatter CRC bytes at positions payload_len..payload_len+3
    wire = pay_buf
    for k in range(4):
        wire = wire.at[payload_len + k].set(crc_b[k], mode="drop")

    # ---- header symbol (BPSK over all data carriers, zero-bit padded) -----
    hdr_bits = make_header_bits(wire_len, frame_num)
    hdr_bits_padded = jnp.zeros(nd, dtype=jnp.uint8).at[:HEADER_BITS].set(
        hdr_bits.astype(jnp.uint8)
    )
    hdr_syms = map_bits(hdr_bits_padded, "bpsk")

    # ---- payload symbols ---------------------------------------------------
    bits = bytes_to_bits(wire)  # (cap*8,)
    wire_bits = wire_len * 8
    n_mod_syms = (wire_bits + bps - 1) // bps            # traced
    sym_capacity = spec.max_payload_ofdm_syms * nd
    bit_capacity = sym_capacity * bps
    bits_padded = jnp.zeros(bit_capacity, dtype=jnp.uint8).at[: bits.shape[0]].set(bits)
    bits_padded = jnp.where(
        jnp.arange(bit_capacity) < wire_bits, bits_padded, 0
    )
    syms = map_bits(bits_padded, spec.modulation)        # (sym_capacity,)
    # golden pads the final OFDM symbol's unused data carriers with ZERO
    # symbols (not zero-bit constellation points)
    syms = jnp.where(jnp.arange(sym_capacity) < n_mod_syms, syms, 0.0 + 0.0j)

    # ---- carrier allocation + zero unused trailing OFDM symbols -----------
    pay_grid = carrier_alloc.allocate(spec, syms)        # (max_pay_syms, N)
    n_pay_syms = (n_mod_syms + nd - 1) // nd             # traced
    sym_mask = jnp.arange(spec.max_payload_ofdm_syms) < n_pay_syms
    pay_grid = jnp.where(sym_mask[:, None], pay_grid, 0.0 + 0.0j)

    hdr_grid = carrier_alloc.allocate(spec, hdr_syms)    # (1, N)
    sync = carrier_alloc.sync_grids(spec)                # (2, N)
    grid = jnp.concatenate([sync, hdr_grid, pay_grid], axis=0)

    # ---- IFFT + CP + scale --------------------------------------------------
    td = ofdm_ifft(grid)
    samples = add_cyclic_prefix(spec, td) * spec.cfg.scale
    n_syms = spec.n_sync_syms + spec.n_header_syms + n_pay_syms
    n_samples = (n_syms * spec.sym_len).astype(jnp.int32)
    return TxFrame(samples.astype(jnp.complex64), n_samples, wire_len)


def tx_frames(spec: OfdmSpec, payloads, payload_lens, frame_nums) -> TxFrame:
    """Batched TX: (B, cap-4) payload buffers -> (B, max_frame_len) frames."""
    return jax.vmap(lambda p, l, n: tx_frame(spec, p, l, n))(
        payloads, payload_lens, frame_nums
    )


def pack_stream(frames: TxFrame, gap: int = 0) -> jnp.ndarray:
    """Concatenate padded frames into one sample stream, keeping each frame's
    zero padding as inter-frame silence plus `gap` extra zeros.  (Host-side
    convenience for loopback tests; true streaming TX uses the executor.)"""
    b, flen = frames.samples.shape
    if gap:
        z = jnp.zeros((b, gap), dtype=frames.samples.dtype)
        return jnp.concatenate([frames.samples, z], axis=1).reshape(-1)
    return frames.samples.reshape(-1)
