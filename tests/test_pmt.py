"""Typed-value serialization (io.pmt) round-trip tests -- the counterpart
of the reference's pmt C++ qa (SURVEY.md §4 "C++ qa ... pmt tests")."""

import numpy as np
import pytest

from ofdm_jax.io import pmt
from ofdm_jax.io.pdu import Pdu, UdpPduLink


CASES = [
    None, True, False, 0, -1, 12345678901234, -(1 << 70), (1 << 100) + 7,
    3.14159, -1e-300, complex(1.5, -2.5), "", "symbol", "ünïcode ☢",
    b"", b"\x00\xff" * 100,
    [], [1, "two", 3.0, None, [True, b"x"]],
    {}, {"freq": 2.4e9, "gain": 30, "tags": ["a", "b"],
         "nested": {"ok": True}},
]


@pytest.mark.parametrize("v", CASES, ids=[repr(c)[:30] for c in CASES])
def test_roundtrip(v):
    got = pmt.loads(pmt.dumps(v))
    assert got == v and type(got) is type(v)


@pytest.mark.parametrize("dtype", [
    np.uint8, np.int16, np.int32, np.float32, np.float64, np.complex64,
    np.complex128,
])
def test_ndarray_roundtrip(dtype):
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5)
    a = (a + 1j * a if np.issubdtype(dtype, np.complexfloating) else a)
    a = a.astype(dtype)
    got = pmt.loads(pmt.dumps(a))
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)


def test_ndarray_in_dict():
    v = {"psd": np.arange(8, dtype=np.float32), "meta": {"n": 8}}
    got = pmt.loads(pmt.dumps(v))
    np.testing.assert_array_equal(got["psd"], v["psd"])
    assert got["meta"] == {"n": 8}


def test_trailing_bytes_rejected():
    with pytest.raises(ValueError, match="trailing"):
        pmt.loads(pmt.dumps(1) + b"x")


def test_bad_type_rejected():
    with pytest.raises(TypeError):
        pmt.dumps(object())
    with pytest.raises(TypeError, match="keys must be str"):
        pmt.dumps({1: 2})


def test_pdu_wire_roundtrip():
    p = Pdu(b"payload bytes", {"src": "nodeA", "seq": 7})
    q = Pdu.from_bytes(p.to_bytes())
    assert q.payload == p.payload and q.meta == p.meta


def test_udp_pdu_link_loopback():
    rx = UdpPduLink(0)
    tx = UdpPduLink(0, remote=("127.0.0.1", rx.port))
    try:
        tx.send(b"hello", kind="chat", n=1)
        got = rx.receive(timeout=2.0)
        assert got is not None
        assert got.payload == b"hello" and got.meta == {"kind": "chat", "n": 1}
    finally:
        tx.close()
        rx.close()
