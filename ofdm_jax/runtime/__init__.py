"""Native host runtime: ring buffers, format converters, threaded readers.

C++ equivalents of the reference's native runtime substrate around the
compute path (SURVEY.md §2b: vmcircbuf circular buffers, VOLK format
conversions, file_source + its scheduler thread) -- the device compute
itself is jitted XLA/Pallas, but the host-side ingest pipeline is native, as in
the reference.  See native/*.cc for the per-component mapping.

Falls back to pure-numpy implementations (same API) when no C++ toolchain
is available; `NATIVE` tells you which you got.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator

import numpy as np

from ofdm_jax.runtime import build as _build

_lib = None
NATIVE = False


def _load():
    global _lib, NATIVE
    so = _build.ensure_built()
    if so is None:
        return
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_size_t]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    for f in ("rb_capacity", "rb_readable", "rb_writable"):
        getattr(lib, f).restype = ctypes.c_size_t
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.rb_write_ptr.restype = ctypes.c_void_p
    lib.rb_write_ptr.argtypes = [ctypes.c_void_p]
    lib.rb_read_ptr.restype = ctypes.c_void_p
    lib.rb_read_ptr.argtypes = [ctypes.c_void_p]
    lib.rb_commit.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.rb_consume.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.reader_start.restype = ctypes.c_void_p
    lib.reader_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_size_t]
    lib.reader_state.restype = ctypes.c_int
    lib.reader_state.argtypes = [ctypes.c_void_p]
    lib.reader_stop.argtypes = [ctypes.c_void_p]
    _lib, NATIVE = lib, True


_load()


class RingBuffer:
    """Double-mapped SPSC byte ring (native) or a numpy deque fallback.

    The native path hands out zero-copy numpy views of the doubly-mapped
    region, so a read spanning the wrap point is still one contiguous view
    (the vmcircbuf property)."""

    def __init__(self, capacity: int):
        if NATIVE:
            self._h = _lib.rb_create(capacity)
            if not self._h:
                raise MemoryError("rb_create failed")
            self.capacity = _lib.rb_capacity(self._h)
        else:
            self._h = None
            self.capacity = capacity
            self._buf = bytearray()
            self._lock = threading.Lock()

    # --- producer side -----------------------------------------------------
    def writable(self) -> int:
        if self._h:
            return _lib.rb_writable(self._h)
        with self._lock:
            return self.capacity - len(self._buf)

    def write(self, data: np.ndarray | bytes) -> int:
        data = np.frombuffer(
            data.tobytes() if isinstance(data, np.ndarray) else data,
            dtype=np.uint8,
        )
        n = min(len(data), self.writable())
        if n == 0:
            return 0
        if self._h:
            ptr = _lib.rb_write_ptr(self._h)
            dst = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(n,)
            )
            dst[:] = data[:n]
            _lib.rb_commit(self._h, n)
        else:
            with self._lock:
                self._buf.extend(data[:n].tobytes())
        return n

    # --- consumer side -----------------------------------------------------
    def readable(self) -> int:
        if self._h:
            return _lib.rb_readable(self._h)
        with self._lock:
            return len(self._buf)

    def peek(self, n: int) -> np.ndarray:
        """Zero-copy (native) view of the next n readable bytes."""
        n = min(n, self.readable())
        if self._h:
            ptr = _lib.rb_read_ptr(self._h)
            return np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(n,)
            )
        with self._lock:
            return np.frombuffer(bytes(self._buf[:n]), dtype=np.uint8)

    def consume(self, n: int) -> None:
        if self._h:
            _lib.rb_consume(self._h, n)
        else:
            with self._lock:
                del self._buf[:n]

    def close(self):
        if self._h:
            _lib.rb_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_ITEM = {"i8c": 2, "i16c": 4, "f32c": 8}


def to_planar(raw: np.ndarray, fmt: str, scale: float | None = None):
    """Interleaved IQ bytes -> (re, im) float32 planes (PackedComplex
    layout).  Native deinterleave when available; numpy otherwise."""
    raw = np.ascontiguousarray(raw.view(np.uint8).ravel())
    n = len(raw) // _ITEM[fmt]
    re = np.empty(n, dtype=np.float32)
    im = np.empty(n, dtype=np.float32)
    if fmt == "i8c":
        s = np.float32(scale if scale is not None else 1.0 / 127.0)
        if NATIVE:
            _lib.conv_i8c_to_planar_f32(
                raw.ctypes.data, re.ctypes.data_as(ctypes.c_void_p),
                im.ctypes.data_as(ctypes.c_void_p), n, ctypes.c_float(s))
        else:
            iq = raw.view(np.int8).astype(np.float32).reshape(n, 2) * s
            re[:], im[:] = iq[:, 0], iq[:, 1]
    elif fmt == "i16c":
        s = np.float32(scale if scale is not None else 1.0 / 32767.0)
        if NATIVE:
            _lib.conv_i16c_to_planar_f32(
                raw.ctypes.data, re.ctypes.data_as(ctypes.c_void_p),
                im.ctypes.data_as(ctypes.c_void_p), n, ctypes.c_float(s))
        else:
            iq = raw.view(np.int16).astype(np.float32).reshape(n, 2) * s
            re[:], im[:] = iq[:, 0], iq[:, 1]
    elif fmt == "f32c":
        if NATIVE:
            _lib.conv_f32c_to_planar(
                raw.ctypes.data, re.ctypes.data_as(ctypes.c_void_p),
                im.ctypes.data_as(ctypes.c_void_p), n)
        else:
            iq = raw.view(np.float32).reshape(n, 2)
            re[:], im[:] = iq[:, 0], iq[:, 1]
    else:
        raise ValueError(f"unknown format {fmt!r}")
    return re, im


def from_planar(re: np.ndarray, im: np.ndarray, fmt: str,
                scale: float | None = None) -> bytes:
    """(re, im) float32 planes -> interleaved IQ wire bytes."""
    n = len(re)
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    if fmt == "f32c":
        out = np.empty(2 * n, dtype=np.float32)
        if NATIVE:
            _lib.conv_planar_to_f32c(
                re.ctypes.data, im.ctypes.data,
                out.ctypes.data_as(ctypes.c_void_p), n)
        else:
            out[0::2], out[1::2] = re, im
        return out.tobytes()
    if fmt == "i16c":
        s = np.float32(scale if scale is not None else 32767.0)
        out = np.empty(2 * n, dtype=np.int16)
        if NATIVE:
            _lib.conv_planar_to_i16c(
                re.ctypes.data, im.ctypes.data,
                out.ctypes.data_as(ctypes.c_void_p), n, ctypes.c_float(s))
        else:
            out[0::2] = np.clip(re * s, -32768, 32767).astype(np.int16)
            out[1::2] = np.clip(im * s, -32768, 32767).astype(np.int16)
        return out.tobytes()
    raise ValueError(f"unknown format {fmt!r}")


if NATIVE:
    _lib.conv_i8c_to_planar_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_float]
    _lib.conv_i16c_to_planar_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_float]
    _lib.conv_f32c_to_planar.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    _lib.conv_planar_to_f32c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    _lib.conv_planar_to_i16c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_float]


class FileStreamer:
    """Stream fixed-size planar sample blocks from a capture file.

    Native path: a C++ reader thread fills the ring while Python converts
    and yields; fallback: plain incremental reads.  Yields (re, im) f32
    pairs of exactly block_size samples (zero-padded at EOF).
    """

    def __init__(self, path: str, fmt: str = "f32c", block_size: int = 1 << 17,
                 ring_bytes: int = 1 << 24, scale: float | None = None):
        self.path, self.fmt = path, fmt
        self.block = block_size
        self.scale = scale
        self.item = _ITEM[fmt]
        self._ring = RingBuffer(ring_bytes)
        if NATIVE:
            self._rd = _lib.reader_start(
                self._ring._h, path.encode(), 1 << 18)
            if not self._rd:
                raise OSError(f"cannot open {path}")
        else:
            self._rd = None
            self._fh = open(path, "rb")

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        import time as _t

        want = self.block * self.item
        while True:
            if self._rd is not None:
                while (self._ring.readable() < want
                       and _lib.reader_state(self._rd) == 0):
                    _t.sleep(0.0005)
                avail = self._ring.readable()
                n = min(want, avail)
                if n == 0:
                    break
                chunk = self.peeked = self._ring.peek(n).copy()
                self._ring.consume(n)
            else:
                chunk = np.frombuffer(self._fh.read(want), dtype=np.uint8)
                if len(chunk) == 0:
                    break
            n_samp = len(chunk) // self.item
            re, im = to_planar(chunk[: n_samp * self.item], self.fmt,
                               self.scale)
            if n_samp < self.block:   # zero-pad the tail block
                re = np.pad(re, (0, self.block - n_samp))
                im = np.pad(im, (0, self.block - n_samp))
            yield re, im
            if n_samp < self.block:
                break

    def packed(self):
        """Yield utils.device_io.PackedComplex blocks -- directly shippable
        through io.feed.DeviceFeed to the executor with zero extra copies."""
        from ofdm_jax.utils.device_io import PackedComplex

        for re, im in self:
            yield PackedComplex(re, im)

    def close(self):
        if self._rd is not None:
            _lib.reader_stop(self._rd)
            self._rd = None
        elif getattr(self, "_fh", None):
            self._fh.close()
        self._ring.close()
