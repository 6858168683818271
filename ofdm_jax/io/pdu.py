"""PDU-style message queues and the samples-over-UDP "air interface".

JAX counterpart of the reference's async message plumbing
(SURVEY.md §2b "Async message passing": PDUs = (metadata, u8vector) PMT
pairs, blocks.socket_pdu) and of gr-ofdm_tools' messaging/chat utilities
(SURVEY.md §2a "Messaging/chat over OFDM").

Device code never sees a PDU: frames cross the host<->device boundary as
fixed-capacity byte buffers + lengths (modem.tx/rx), and the host-side
queues here carry the variable-length payloads around them.
"""

from __future__ import annotations

import queue
import socket
from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class Pdu:
    """(metadata, payload) pair, cf. the reference's PDU PMT convention."""

    payload: bytes
    meta: dict[str, Any] = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        """Typed wire form via io.pmt (cf. pmt::serialize of a PDU pair)."""
        from ofdm_jax.io import pmt

        return pmt.dumps_pdu(self.meta, self.payload)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Pdu":
        from ofdm_jax.io import pmt

        meta, payload = pmt.loads_pdu(buf)
        return cls(payload, meta)


class PduQueue:
    """Thread-safe typed queue of Pdus (replaces message-port wiring)."""

    def __init__(self, maxsize: int = 0):
        self._q: queue.Queue[Pdu] = queue.Queue(maxsize)

    def post(self, pdu: Pdu | bytes, **meta):
        if not isinstance(pdu, Pdu):
            pdu = Pdu(bytes(pdu), dict(meta))
        self._q.put(pdu)

    def get(self, timeout: float | None = None) -> Pdu | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> list[Pdu]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def __len__(self) -> int:
        return self._q.qsize()


class UdpPduLink:
    """Typed PDUs over UDP datagrams (cf. blocks.socket_pdu in UDP mode):
    each datagram is one pmt-serialized (metadata, payload) pair."""

    def __init__(self, bind_port: int, remote: tuple[str, int] | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", bind_port))
        self.remote = remote

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def send(self, pdu: Pdu | bytes, **meta):
        if not isinstance(pdu, Pdu):
            pdu = Pdu(bytes(pdu), dict(meta))
        assert self.remote is not None
        self.sock.sendto(pdu.to_bytes(), self.remote)

    def receive(self, timeout: float = 1.0) -> Pdu | None:
        self.sock.settimeout(timeout)
        try:
            data, peer = self.sock.recvfrom(1 << 16)
        except (socket.timeout, BlockingIOError):
            return None
        if self.remote is None:
            self.remote = peer
        return Pdu.from_bytes(data)

    def close(self):
        self.sock.close()


class UdpSampleLink:
    """Complex64 sample blocks over UDP -- the simulated air interface
    joining two modem apps on different hosts (cf. blocks.udp_source/sink
    carrying the reference's modulated stream between machines).

    Datagrams carry raw interleaved float32 I/Q; blocks larger than the
    datagram budget are fragmented and reassembled by simple sequencing
    (loss => dropped fragment => zeros, matching UDP stream semantics).
    """

    FRAG_SAMPLES = 2048  # 16 KiB payload per datagram

    def __init__(self, bind_port: int, remote: tuple[str, int] | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", bind_port))
        self.remote = remote

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def send(self, samples: np.ndarray):
        assert self.remote is not None
        x = np.asarray(samples, np.complex64)
        inter = np.empty(2 * x.size, np.float32)
        inter[0::2], inter[1::2] = x.real, x.imag
        raw = inter.tobytes()
        step = self.FRAG_SAMPLES * 8
        for i in range(0, len(raw), step):
            self.sock.sendto(raw[i : i + step], self.remote)

    def receive(self, n_samples: int, timeout: float = 1.0) -> np.ndarray | None:
        """Collect ~n_samples of stream; returns None on timeout with no
        data.  Short reads are zero-padded (lost datagrams)."""
        self.sock.settimeout(timeout)
        chunks = []
        have = 0
        while have < n_samples:
            try:
                data, peer = self.sock.recvfrom(1 << 16)
            except (socket.timeout, BlockingIOError):
                break
            if self.remote is None:
                self.remote = peer
            f = np.frombuffer(data, np.float32)
            chunks.append((f[0::2] + 1j * f[1::2]).astype(np.complex64))
            have += len(chunks[-1])
        if not chunks:
            return None
        x = np.concatenate(chunks)[:n_samples]
        if len(x) < n_samples:
            x = np.concatenate([x, np.zeros(n_samples - len(x), np.complex64)])
        return x

    def close(self):
        self.sock.close()
