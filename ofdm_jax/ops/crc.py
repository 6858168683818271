"""CRC32 (IEEE 802.3) and CRC8 as pure JAX ops.

JAX equivalent of the reference's crc32_bb block and the CRC8 inside
packet_header_ofdm (SURVEY.md §2b "Header/payload machinery",
gr-digital/lib/crc32_bb_impl.cc / packet_header_ofdm.cc, unverified paths).
The byte-serial table loop becomes a lax.scan with a 256-entry lookup; for
masked variable-length payloads inside static shapes, bytes beyond `length`
leave the register untouched.

Conventions match zlib.crc32 (reflected, init/xorout 0xFFFFFFFF) and the
golden model's crc8 (poly 0x07, init 0, MSB-first).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _crc32_table_np() -> np.ndarray:
    poly = 0xEDB88320
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        table[i] = c
    return table


@functools.lru_cache(maxsize=None)
def _crc32_basis_np(cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Distance-basis tables for the parallel CRC32.

    CRC32 is GF(2)-linear: one byte step is reg' = A(reg) ^ table[b] with
    A(r) = table[r & 0xFF] ^ (r >> 8), so over n bytes

        reg_n = A^n(init) ^ XOR_i A^(n-1-i)(table[b_i]).

    Returns (basis, initc):
      basis[d, j] = A^d(table[1 << j])  -- contribution of byte-bit j at
                    distance d from the END of the message; (cap, 8) uint32
      initc[n]    = A^n(0xFFFFFFFF);  (cap + 1,) uint32
    """
    table = _crc32_table_np()

    def A(r: np.ndarray) -> np.ndarray:
        return table[r & 0xFF] ^ (r >> np.uint32(8))

    basis = np.zeros((max(cap, 1), 8), dtype=np.uint32)
    basis[0] = table[1 << np.arange(8)]
    for d in range(1, cap):
        basis[d] = A(basis[d - 1])
    initc = np.zeros(cap + 1, dtype=np.uint32)
    initc[0] = 0xFFFFFFFF
    for n in range(1, cap + 1):
        initc[n] = A(initc[n - 1 : n])[0]
    return basis, initc


def _xor_reduce(x: jnp.ndarray) -> jnp.ndarray:
    """XOR of all elements, log-depth tree (static shapes)."""
    x = x.reshape(-1)
    n = x.shape[0]
    while n > 1:
        if n % 2:
            x = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
            n += 1
        x = x[0::2] ^ x[1::2]
        n //= 2
    return x[0]


def crc32(data: jnp.ndarray, length: jnp.ndarray | int | None = None) -> jnp.ndarray:
    """CRC32 of uint8 array `data` (1-D).  If `length` is given, only the
    first `length` bytes participate (static shape, masked).

    Fully parallel (one gather + a log-depth XOR tree) via the GF(2)
    linearity of CRC, rather than a byte-serial lax.scan, which serializes
    execution (whether the scan form is slower on the GPU is not
    measured)."""
    n = data.shape[0]
    if length is None:
        length = n
    length = jnp.asarray(length, dtype=jnp.int32)
    basis_np, initc_np = _crc32_basis_np(n)
    basis = jnp.asarray(basis_np)
    initc = jnp.asarray(initc_np)

    i = jnp.arange(n, dtype=jnp.int32)
    d = length - 1 - i                                  # distance from end
    rows = basis[jnp.clip(d, 0, n - 1)]                 # (n, 8)
    bits = (data.astype(jnp.uint32)[:, None] >> jnp.arange(8, dtype=jnp.uint32)) & 1
    contrib = jnp.where((bits == 1) & (d >= 0)[:, None], rows, jnp.uint32(0))
    reg = _xor_reduce(contrib) ^ initc[jnp.clip(length, 0, n)]
    return reg ^ jnp.uint32(0xFFFFFFFF)


def append_crc32_bytes(crc: jnp.ndarray) -> jnp.ndarray:
    """CRC32 value -> 4 little-endian bytes (matches golden append_crc32)."""
    shifts = jnp.arange(0, 32, 8, dtype=jnp.uint32)
    return ((crc[..., None] >> shifts) & 0xFF).astype(jnp.uint8)


def check_crc32(data: jnp.ndarray, wire_len: jnp.ndarray | int) -> jnp.ndarray:
    """True iff data[:wire_len-4] has CRC32 == data[wire_len-4:wire_len]
    (little-endian).  `data` is a fixed-capacity uint8 buffer."""
    wire_len = jnp.asarray(wire_len, dtype=jnp.int32)
    body_len = jnp.maximum(wire_len - 4, 0)
    got = crc32(data, body_len)
    tail = data[body_len + jnp.arange(4)].astype(jnp.uint32)  # gather, clamped
    want = (tail << jnp.arange(0, 32, 8, dtype=jnp.uint32)).sum()
    return (got == want) & (wire_len >= 4)


@functools.lru_cache(maxsize=None)
def _crc8_powers_np(n: int) -> np.ndarray:
    """P[d] = L^d(0x07) where L is the one-bit CRC-8 step on the register:
    L(r) = ((r << 1) & 0xFF) ^ (0x07 if r & 0x80 else 0).  The bit step
    reg' = L(reg) ^ b*0x07 is GF(2)-linear, so over n bits (init 0)
    reg_n = XOR_{i: b_i=1} P[n-1-i]."""
    p = np.zeros(max(n, 1), dtype=np.uint32)
    p[0] = 0x07
    for d in range(1, n):
        r = int(p[d - 1])
        p[d] = ((r << 1) & 0xFF) ^ (0x07 if r & 0x80 else 0)
    return p


def crc8_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """CRC-8 poly 0x07, init 0, over an MSB-first bit vector (static
    length).  Fully parallel via GF(2) linearity (one table row per bit +
    log-depth XOR tree) -- the bit-serial lax.scan form serialized 24 tiny
    steps per frame slot when vmapped over the RX's K slots."""
    n = bits.shape[-1]
    rows = jnp.asarray(_crc8_powers_np(n)[::-1].copy())  # rows[i] = P[n-1-i]
    contrib = jnp.where(bits.astype(jnp.uint32) == 1, rows, jnp.uint32(0))
    while contrib.shape[-1] > 1:
        m = contrib.shape[-1]
        if m % 2:
            contrib = jnp.concatenate(
                [contrib, jnp.zeros((*contrib.shape[:-1], 1), contrib.dtype)],
                axis=-1,
            )
            m += 1
        contrib = contrib[..., 0::2] ^ contrib[..., 1::2]
    return contrib[..., 0]
