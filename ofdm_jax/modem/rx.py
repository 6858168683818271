"""OFDM receiver composite.

JAX equivalent of digital.ofdm_rx (SURVEY.md §3.3,
gr-digital/python/digital/ofdm_txrx.py + ofdm_sync_sc_cfb +
header_payload_demux + ofdm_chanest/equalizer/serializer +
constellation_decoder + crc32_bb, unverified paths).

The reference's hardest control flow -- the packet_headerparser_b ->
header_payload_demux message-port feedback loop that tells the demux how many
payload samples to pass -- is restructured as a static two-pass design
(SURVEY.md §7 decision 2 / hard part 1):

  pass 1: detect up to K frame starts per block (ops.sync.detect_frames),
  pass 2: for each candidate slot (vmapped), gather a fixed-capacity window,
          derotate, FFT the whole frame, estimate/equalize, parse the header,
          and demap payload bytes under masks derived from the header length.

Everything is fixed capacity + validity masks; no data-dependent shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ofdm_jax.config import HEADER_BITS, OfdmSpec
from ofdm_jax.ops import carrier_alloc
from ofdm_jax.ops.chanest import coarse_int_cfo, ls_estimate, roll_bins
from ofdm_jax.ops.constellation import demap_hard, demap_soft, evm as evm_op
from ofdm_jax.ops.crc import check_crc32
from ofdm_jax.ops.equalizer import equalize_pilot_phase, equalize_simpledfe
from ofdm_jax.ops.header import parse_header_bits
from ofdm_jax.ops.sync import Detections, derotate, detect_frames
from ofdm_jax.ops.transform import ofdm_fft
from ofdm_jax.utils.bits import bits_to_bytes


class FrameResult(NamedTuple):
    payload: jnp.ndarray     # (max_payload_bytes,) uint8 wire bytes (incl CRC)
    payload_len: jnp.ndarray  # () int32: payload bytes EXCL. CRC32 (wire-4)
    frame_num: jnp.ndarray   # () int32
    hdr_ok: jnp.ndarray      # () bool: header CRC8 passed
    crc_ok: jnp.ndarray      # () bool: payload CRC32 passed
    evm: jnp.ndarray         # () float32: payload EVM vs hard decisions
    int_cfo: jnp.ndarray     # () int32
    data_syms: jnp.ndarray   # (sym_capacity,) complex64 equalized payload syms
    sym_mask: jnp.ndarray    # (sym_capacity,) bool: valid payload symbols
    sync_q: jnp.ndarray      # () float32: sync1 spectral-support quality
    sync_ok: jnp.ndarray     # () bool: sync_q above acquisition threshold
    llr: jnp.ndarray         # (sym_capacity*bps,) f32 max-log LLRs of the
    #   payload bits (positive => bit 0; zeroed outside wire_bits), scaled by
    #   the per-frame post-equalization noise estimate (EVM^2).  Shape (0,)
    #   when the RX runs with output="hard" (the default) -- the soft path is
    #   BASELINE config 3's "pilot-based LS equalization + soft demap".


def demod_frame(
    spec: OfdmSpec,
    frame: jnp.ndarray,          # (max_frame_len,) starting at detected start
    equalizer: str = "pilot_phase",
    output: str = "hard",        # "hard" | "soft": also emit payload LLRs
) -> FrameResult:
    """Demodulate one start-aligned frame window (already CFO-derotated).

    frame[0] must be the detected FFT-window start of sync word 1 (a few
    samples inside its CP -- the resulting circular shift is absorbed into
    the channel estimate as a linear phase).
    """
    n_syms = spec.max_frame_ofdm_syms
    # FFT windows at stride sym_len from the aligned start (CP skipped by
    # construction: each window is the first fft_len of its sym_len slot)
    wins = frame[: n_syms * spec.sym_len].reshape(n_syms, spec.sym_len)
    grids = ofdm_fft(wins[:, : spec.fft_len])                  # (n_syms, N)

    ic = coarse_int_cfo(spec, grids[0])
    grids = roll_bins(grids, ic)                                # undo +ic shift

    # Frame-acquisition gate (role of ofdm_chanest_vcvc's frame check in the
    # reference): sync word 1 occupies ONLY the even occupied bins, while
    # every data/header symbol carries pilots on odd carriers -- so symbol-0
    # energy concentrated on the sync1 support (vs all occupied bins)
    # separates a true preamble (~1) from any mid-frame or noise window
    # (~0.5).  This kills false detections that the 8-bit header CRC would
    # otherwise pass by luck, chopping-independently.
    e_on = jnp.sum(jnp.abs(grids[0, spec.sync1_bins]) ** 2)
    e_occ = jnp.sum(jnp.abs(grids[0, spec.occupied_bins]) ** 2)
    sync_q = e_on / jnp.maximum(e_occ, 1e-12)
    sync_ok = (sync_q > 0.75) & (e_occ > 1e-9)

    H = ls_estimate(spec, grids[1])

    hdr_eq = equalize_pilot_phase(spec, grids[2:3], H)          # (1, N)
    hdr_syms = carrier_alloc.serialize(spec, hdr_eq)            # (n_data,)
    hdr_bits = demap_hard(hdr_syms[:HEADER_BITS], "bpsk")
    wire_len, fnum, hdr_ok = parse_header_bits(hdr_bits)
    wire_len = jnp.clip(wire_len, 0, spec.max_payload_bytes)

    pay = grids[3:]                                             # (max_pay, N)
    if equalizer == "simpledfe":
        pay_eq = equalize_simpledfe(spec, pay, H)
    else:
        pay_eq = equalize_pilot_phase(spec, pay, H)
    syms = carrier_alloc.serialize(spec, pay_eq)                # (sym_cap,)

    bps = spec.bits_per_symbol
    wire_bits = wire_len * 8
    n_mod_syms = (wire_bits + bps - 1) // bps
    sym_cap = syms.shape[0]
    sym_mask = jnp.arange(sym_cap) < n_mod_syms

    bits = demap_hard(syms, spec.modulation)                    # (sym_cap*bps,)
    bits = jnp.where(jnp.arange(bits.shape[0]) < wire_bits, bits, 0)
    wire = bits_to_bytes(bits)[: spec.max_payload_bytes]
    byte_mask = jnp.arange(wire.shape[0]) < wire_len
    wire = jnp.where(byte_mask, wire, 0)

    crc_ok = check_crc32(wire, wire_len) & hdr_ok & sync_ok
    e = evm_op(syms, spec.modulation, mask=sym_mask)

    if output == "soft":
        # Max-log LLRs scaled by the post-equalization noise estimate: EVM^2
        # is the mean squared symbol error vs hard decisions over the valid
        # payload -- the per-frame sigma^2 the LLR denominator needs.
        noise_var = jnp.maximum(e.astype(jnp.float32) ** 2, 1e-6)
        llr = demap_soft(syms, spec.modulation, noise_var)
        llr = jnp.where(jnp.arange(llr.shape[0]) < wire_bits, llr, 0.0)
    else:
        llr = jnp.zeros((0,), jnp.float32)

    return FrameResult(
        payload=wire,
        payload_len=jnp.maximum(wire_len - 4, 0),
        frame_num=fnum,
        hdr_ok=hdr_ok,
        crc_ok=crc_ok,
        evm=e.astype(jnp.float32),
        int_cfo=ic,
        data_syms=syms.astype(jnp.complex64),
        sym_mask=sym_mask,
        sync_q=sync_q.astype(jnp.float32),
        sync_ok=sync_ok,
        llr=llr,
    )


def gather_windows(s_re, s_im, starts, F: int) -> jnp.ndarray:
    """(K, F) complex64 windows [start, start + F) of the f32 planes, one
    per slot; starts are clamped into [0, n - F] so that invalid slots
    still index safely.  Vmapped over the slots, XLA emits one gather for
    all windows."""
    starts = jnp.clip(starts, 0, max(s_re.shape[-1] - F, 0))

    def one(start):
        return (jax.lax.dynamic_slice(s_re, (start,), (F,))
                + 1j * jax.lax.dynamic_slice(s_im, (start,), (F,))
                ).astype(jnp.complex64)

    return jax.vmap(one)(starts)


class RxBlockResult(NamedTuple):
    frames: FrameResult      # batched over K slots
    starts: jnp.ndarray      # (K,) int32 start index within the input buffer
    fine_cfo: jnp.ndarray    # (K,) float32
    valid: jnp.ndarray       # (K,) bool: slot holds an accepted detection


def rx_block(
    spec: OfdmSpec,
    samples,                 # (n,) extended block: [history | new samples]
    max_frames: int,
    own_lo: int = 0,
    own_hi: int | None = None,
    equalizer: str = "pilot_phase",
    output: str = "hard",
) -> RxBlockResult:
    """Detect + demodulate up to `max_frames` frames in a sample buffer.

    Ownership window [own_lo, own_hi): only detections whose start falls in
    it are accepted -- the streaming executor uses this to deduplicate
    detections across overlapping blocks (SURVEY.md §7 hard part 2's
    ownership rule, single-shard version).

    `samples` may be complex64 (n,) or a device_io.PackedComplex of two
    (n,) f32 planes.  Detection and the per-slot window gathers read the
    f32 planes directly; complex is only ever built on the small
    (max_frames, max_frame_len) windows.
    """
    from ofdm_jax.utils.device_io import PackedComplex

    if isinstance(samples, PackedComplex):
        s_re, s_im = samples.re, samples.im
    else:
        s_re = jnp.real(samples).astype(jnp.float32)
        s_im = jnp.imag(samples).astype(jnp.float32)
    n = s_re.shape[0]
    if own_hi is None:
        own_hi = n
    det: Detections = detect_frames(
        spec, PackedComplex(s_re, s_im), max_frames
    )
    owned = det.valid & (det.start >= own_lo) & (det.start < own_hi)
    wins = gather_windows(s_re, s_im, det.start, spec.max_frame_len)
    frames = jax.vmap(
        lambda win, cfo: demod_frame(
            spec, derotate(win, cfo, spec.fft_len),
            equalizer=equalizer, output=output)
    )(wins, det.fine_cfo)
    # a slot is valid only if owned AND acquisition confirmed AND header ok
    valid = owned & frames.sync_ok & frames.hdr_ok
    return RxBlockResult(frames, det.start, det.fine_cfo, valid)
