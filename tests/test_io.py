"""Host IO: file sources/sinks, UDP spectrum transport, PDU queues, feed."""

import os

import numpy as np
import pytest

from ofdm_jax.io import (
    DeviceFeed,
    Pdu,
    PduQueue,
    SpectrumPublisher,
    SpectrumSubscriber,
    UdpSampleLink,
    file_sink,
    file_size_samples,
    file_source,
    head,
    noise_source,
    pack_spectrum,
    sig_source,
    unpack_spectrum,
    vector_source,
)


class TestFileIO:
    @pytest.mark.parametrize("fmt", ["c64", "f32", "i16"])
    def test_roundtrip(self, tmp_path, fmt):
        path = str(tmp_path / f"capture.{fmt}")
        rng = np.random.RandomState(0)
        x = ((rng.randn(5000) + 1j * rng.randn(5000)) * 0.1).astype(np.complex64)
        write, close = file_sink(path, fmt)
        write(x[:2000])
        write(x[2000:])
        close()
        assert file_size_samples(path, fmt) == 5000
        got = np.concatenate(list(file_source(path, 1024, fmt)))
        assert len(got) == 5 * 1024  # zero-padded tail
        atol = 1e-4 if fmt in ("c64", "f32") else 1e-3
        np.testing.assert_allclose(got[:5000], x, atol=atol)
        assert np.all(got[5000:] == 0)

    def test_repeat_and_head(self, tmp_path):
        path = str(tmp_path / "loop.c64")
        write, close = file_sink(path)
        write(np.arange(256).astype(np.complex64))
        close()
        blocks = list(head(file_source(path, 256, repeat=True), 5))
        assert len(blocks) == 5
        np.testing.assert_allclose(blocks[0], blocks[4])


class TestSyntheticSources:
    def test_sig_source_phase_continuous(self):
        src = sig_source(100, freq_rel=0.05)
        x = np.concatenate([next(src), next(src)])
        t = np.arange(200)
        np.testing.assert_allclose(
            x, np.exp(2j * np.pi * 0.05 * t), atol=1e-5
        )

    def test_noise_source_stats(self):
        x = next(noise_source(65536, amplitude=2.0, seed=1))
        assert abs(np.mean(np.abs(x) ** 2) - 4.0) < 0.1

    def test_vector_source(self):
        data = np.arange(10).astype(np.complex64)
        blocks = list(vector_source(data, 4))
        assert len(blocks) == 3
        np.testing.assert_allclose(blocks[2], [8, 9, 0, 0])


class TestSpectrumTransport:
    def test_pack_unpack(self):
        avg = np.linspace(-100, -20, 256).astype(np.float32)
        mx = avg + 5
        pkt = pack_spectrum(7, 2.4e9, 10e6, avg, mx, 42)
        fr = unpack_spectrum(pkt)
        assert fr.seq == 7 and fr.n_frames == 42
        assert fr.center_freq == 2.4e9 and fr.sample_rate == 10e6
        np.testing.assert_allclose(fr.avg_db, avg)
        np.testing.assert_allclose(fr.max_db, mx)

    def test_udp_loopback_and_control(self):
        sub = SpectrumSubscriber(bind_port=0)
        pub = SpectrumPublisher(("127.0.0.1", sub.port))
        try:
            avg = np.full(128, -60.0, np.float32)
            pub.publish(1e9, 5e6, avg, avg + 3, 10)
            fr = sub.receive(timeout=2.0)
            assert fr is not None and fr.center_freq == 1e9
            # control path back to the worker
            sub.send_control({"cmd": "retune", "freq": 1.1e9})
            import time

            msgs = []
            for _ in range(20):
                msgs = pub.poll_control()
                if msgs:
                    break
                time.sleep(0.05)
            assert msgs == [{"cmd": "retune", "freq": 1.1e9}]
        finally:
            pub.close()
            sub.close()

    def test_bad_magic_rejected(self):
        with pytest.raises(ValueError):
            unpack_spectrum(b"\x00" * 64)


class TestPdu:
    def test_queue(self):
        q = PduQueue()
        q.post(b"hello", channel=3)
        q.post(Pdu(b"world", {"x": 1}))
        pdus = q.drain()
        assert [p.payload for p in pdus] == [b"hello", b"world"]
        assert pdus[0].meta == {"channel": 3}

    def test_udp_sample_link(self):
        rxl = UdpSampleLink(bind_port=0)
        txl = UdpSampleLink(bind_port=0, remote=("127.0.0.1", rxl.port))
        try:
            rng = np.random.RandomState(2)
            x = ((rng.randn(5000) + 1j * rng.randn(5000))).astype(np.complex64)
            txl.send(x)
            got = rxl.receive(5000, timeout=2.0)
            assert got is not None
            np.testing.assert_allclose(got, x, atol=1e-6)
        finally:
            txl.close()
            rxl.close()


class TestDeviceFeed:
    def test_feed_matches_source(self):
        data = [np.full(64, i, np.complex64) for i in range(10)]
        got = [np.asarray(b) for b in DeviceFeed(iter(data), depth=2)]
        assert len(got) == 10
        for i, g in enumerate(got):
            np.testing.assert_allclose(g, data[i])

    def test_feed_propagates_errors(self):
        def bad():
            yield np.zeros(8, np.complex64)
            raise RuntimeError("source died")

        it = iter(DeviceFeed(bad(), depth=2))
        next(it)
        with pytest.raises(RuntimeError, match="source died"):
            next(it)
