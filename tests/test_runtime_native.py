"""Native host runtime tests: ring buffer, converters, file streamer.

These run against whichever engine loaded (NATIVE C++ or the numpy
fallback); the API contract is identical.  A couple of tests assert
native-only properties and skip on the fallback.
"""

import os
import threading

import numpy as np
import pytest

from ofdm_jax import runtime


def test_engine_reported():
    # the build image has g++; if this starts failing the build broke
    assert isinstance(runtime.NATIVE, bool)


def test_ring_roundtrip_with_wraparound():
    rb = runtime.RingBuffer(1 << 12)
    cap = rb.capacity
    rng = np.random.RandomState(0)
    chunk = rng.randint(0, 256, size=cap // 3 + 7, dtype=np.uint8)
    got = []
    # push/pull enough times to wrap several times
    for _ in range(10):
        assert rb.write(chunk) == len(chunk)
        view = rb.peek(len(chunk))
        got.append(view.copy())
        rb.consume(len(chunk))
    for g in got:
        np.testing.assert_array_equal(g, chunk)
    rb.close()


def test_ring_backpressure():
    rb = runtime.RingBuffer(4096)
    big = np.zeros(2 * rb.capacity, dtype=np.uint8)
    n = rb.write(big)
    assert n == rb.capacity
    assert rb.writable() == 0
    rb.consume(100)
    assert rb.writable() == 100
    rb.close()


def test_ring_spsc_threaded():
    rb = runtime.RingBuffer(1 << 14)
    total = 1 << 20
    src = np.arange(total, dtype=np.uint8)  # wraps mod 256, deterministic
    out = np.empty(total, dtype=np.uint8)

    def producer():
        sent = 0
        while sent < total:
            n = rb.write(src[sent : sent + 4096])
            sent += n

    t = threading.Thread(target=producer)
    t.start()
    rcvd = 0
    while rcvd < total:
        n = min(rb.readable(), total - rcvd)
        if n == 0:
            continue
        out[rcvd : rcvd + n] = rb.peek(n)
        rb.consume(n)
        rcvd += n
    t.join()
    np.testing.assert_array_equal(out, src)
    rb.close()


@pytest.mark.parametrize("fmt,dtype,scale", [
    ("i8c", np.int8, 1 / 127.0),
    ("i16c", np.int16, 1 / 32767.0),
    ("f32c", np.float32, None),
])
def test_to_planar_matches_numpy(fmt, dtype, scale):
    rng = np.random.RandomState(1)
    n = 1000
    if fmt == "f32c":
        wire = rng.randn(2 * n).astype(np.float32)
        want = wire.reshape(n, 2)
    else:
        info = np.iinfo(dtype)
        wire = rng.randint(info.min, info.max, size=2 * n).astype(dtype)
        want = wire.astype(np.float32).reshape(n, 2) * scale
    re, im = runtime.to_planar(wire.view(np.uint8), fmt)
    np.testing.assert_allclose(re, want[:, 0], rtol=1e-6)
    np.testing.assert_allclose(im, want[:, 1], rtol=1e-6)


def test_planar_roundtrip_i16():
    rng = np.random.RandomState(2)
    re = rng.uniform(-0.9, 0.9, 500).astype(np.float32)
    im = rng.uniform(-0.9, 0.9, 500).astype(np.float32)
    wire = runtime.from_planar(re, im, "i16c")
    re2, im2 = runtime.to_planar(np.frombuffer(wire, np.uint8), "i16c")
    np.testing.assert_allclose(re2, re, atol=1e-4)
    np.testing.assert_allclose(im2, im, atol=1e-4)


def test_file_streamer_roundtrip(tmp_path):
    rng = np.random.RandomState(3)
    n = 300000
    samples = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    path = os.path.join(tmp_path, "capture.c64")
    wire = np.empty(2 * n, dtype=np.float32)
    wire[0::2], wire[1::2] = samples.real, samples.imag
    wire.tofile(path)

    block = 1 << 16
    fs = runtime.FileStreamer(path, fmt="f32c", block_size=block)
    got = []
    for re, im in fs:
        assert re.shape == (block,)
        got.append(re + 1j * im)
    fs.close()
    flat = np.concatenate(got)[:n]
    np.testing.assert_allclose(flat, samples, rtol=1e-6)
