"""Sharded (channel x time) RX tests on the virtual 8-device CPU mesh.

Covers SURVEY.md §2c: channel data-parallelism, time sequence-parallelism
with ppermute overlap-save halos, and the cross-shard frame-ownership rule
(a preamble straddling a shard boundary is recovered exactly once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ofdm_jax.config import OfdmConfig
from ofdm_jax.modem import tx as txm
from ofdm_jax.modem.rx_stream import history_len
from ofdm_jax.shard import (
    TIME_AXIS,
    collect_sharded_frames,
    extend_with_left_halo,
    halo_from_left,
    make_mesh,
    sharded_rx_capture_fn,
)

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from jax.sharding import PartitionSpec as P


def test_halo_from_left_ring():
    mesh = make_mesh(n_channel=1, n_time=8)
    x = jnp.arange(8 * 16, dtype=jnp.float32).reshape(1, 8 * 16)

    def f(local):  # (1, 16)
        return halo_from_left(local, 4)

    out = shard_map(
        f, mesh=mesh, in_specs=P(None, TIME_AXIS),
        out_specs=P(None, TIME_AXIS), check_vma=False,
    )(x)
    out = np.asarray(out).reshape(8, 4)
    # shard 0 gets zeros; shard t gets the last 4 samples of shard t-1
    assert np.all(out[0] == 0)
    for t in range(1, 8):
        np.testing.assert_array_equal(out[t], np.arange(t * 16 - 4, t * 16))


def test_extend_with_left_halo_shapes():
    mesh = make_mesh(n_channel=2, n_time=4)
    x = jnp.ones((2, 4 * 32), dtype=jnp.float32)

    def f(local):
        return extend_with_left_halo(local, 8)

    out = shard_map(
        f, mesh=mesh, in_specs=P("channel", TIME_AXIS),
        out_specs=P("channel", TIME_AXIS), check_vma=False,
    )(x)
    assert out.shape == (2, 4 * 40)


def _make_frame(spec, payload: bytes, frame_num=0):
    cap = spec.max_payload_bytes - 4
    buf = np.zeros((1, cap), np.uint8)
    buf[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    fr = jax.jit(lambda p, l, n: txm.tx_frames(spec, p, l, n))(
        buf, np.array([len(payload)], np.int32), np.array([frame_num], np.int32)
    )
    n = int(fr.n_samples[0])
    return np.asarray(fr.samples[0][:n], np.complex64)


@pytest.mark.parametrize("boundary_straddle", [False, True])
def test_sharded_rx_capture(boundary_straddle):
    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")
    spec = cfg.spec
    mesh = make_mesh(n_channel=2, n_time=4)
    S = 4096
    C, T = 2, 4
    rng = np.random.RandomState(3)
    stream = np.zeros((C, T * S), np.complex64)

    frame0 = _make_frame(spec, b"channel zero frame", frame_num=5)
    frame1 = _make_frame(spec, b"channel one straddles", frame_num=9)
    pos0 = 1000
    # straddle: frame crosses the shard-1/shard-2 boundary at 2*S
    pos1 = 2 * S - len(frame1) // 2 if boundary_straddle else 5000
    stream[0, pos0 : pos0 + len(frame0)] = frame0
    stream[1, pos1 : pos1 + len(frame1)] = frame1
    stream += (
        (rng.randn(C, T * S) + 1j * rng.randn(C, T * S)) * np.sqrt(10 ** (-28 / 10) / 2)
    ).astype(np.complex64)

    fn = jax.jit(sharded_rx_capture_fn(spec, mesh, S, max_frames_per_shard=4))
    res = jax.tree.map(np.asarray, fn(stream))
    frames = collect_sharded_frames(res, S, spec, n_time=T)
    got = {(f["channel"], f["payload"]) for f in frames if f["crc_ok"]}
    assert got == {(0, b"channel zero frame"), (1, b"channel one straddles")}
    # exactly one detection per frame (ownership dedup across shards)
    assert len([f for f in frames if f["crc_ok"]]) == 2
    by_chan = {f["channel"]: f for f in frames if f["crc_ok"]}
    assert abs(by_chan[0]["abs_start"] - pos0) < spec.cp_len
    assert abs(by_chan[1]["abs_start"] - pos1) < spec.cp_len
    assert by_chan[0]["frame_num"] == 5 and by_chan[1]["frame_num"] == 9


def test_sharded_matches_single_device():
    """Same capture through the 8-way mesh and a 1x1 mesh -> same frames."""
    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="bpsk")
    spec = cfg.spec
    S = 4096
    T = 4
    rng = np.random.RandomState(7)
    stream = np.zeros((2, T * S), np.complex64)
    fr = _make_frame(spec, b"determinism check", frame_num=1)
    stream[0, 3000 : 3000 + len(fr)] = fr
    stream[1, 9000 : 9000 + len(fr)] = fr
    stream += ((rng.randn(*stream.shape) + 1j * rng.randn(*stream.shape))
               * 0.01).astype(np.complex64)

    mesh8 = make_mesh(n_channel=2, n_time=4)
    mesh1 = make_mesh(n_channel=1, n_time=1, devices=jax.devices()[:1])
    out8 = jax.tree.map(
        np.asarray,
        jax.jit(sharded_rx_capture_fn(spec, mesh8, S, 4))(stream),
    )
    out1 = jax.tree.map(
        np.asarray,
        jax.jit(sharded_rx_capture_fn(spec, mesh1, T * S, 16))(stream),
    )
    f8 = collect_sharded_frames(out8, S, spec, n_time=T)
    f1 = collect_sharded_frames(out1, T * S, spec, n_time=1)
    key = lambda f: (f["channel"], f["abs_start"], f["payload"], f["crc_ok"])
    assert sorted(map(key, f8)) == sorted(map(key, f1))
    assert len([f for f in f8 if f["crc_ok"]]) == 2


def test_sharded_stream_carry_across_chunks():
    """sharded_rx_stream_block: a frame straddling the boundary between two
    CHUNKS (not just two shards) is recovered exactly once -- shard 0 of
    chunk 1 demodulates it from the carried tail of chunk 0."""
    from ofdm_jax.modem.rx_stream import history_len
    from ofdm_jax.shard import collect_sharded_stream_frames, sharded_rx_stream_block
    from ofdm_jax.stream.executor import StreamExecutor

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")
    spec = cfg.spec
    mesh = make_mesh(n_channel=2, n_time=4)
    S, C, T = 4096, 2, 4
    chunk = T * S
    rng = np.random.RandomState(11)
    stream = np.zeros((C, 2 * chunk), np.complex64)

    f0 = _make_frame(spec, b"inside chunk zero", frame_num=1)
    f1 = _make_frame(spec, b"straddles the chunk boundary", frame_num=2)
    f2 = _make_frame(spec, b"inside chunk one", frame_num=3)
    pos = {0: 2500, 1: chunk - len(f1) // 2, 2: chunk + 7000}
    stream[0, pos[0] : pos[0] + len(f0)] = f0
    stream[1, pos[1] : pos[1] + len(f1)] = f1
    stream[1, pos[2] : pos[2] + len(f2)] = f2
    stream += ((rng.randn(C, 2 * chunk) + 1j * rng.randn(C, 2 * chunk))
               * 0.01).astype(np.complex64)

    block = sharded_rx_stream_block(spec, mesh, C, S, max_frames_per_shard=4)
    ex = StreamExecutor(block, chunk, donate=False)
    outs = [ex.push(stream[:, :chunk]), ex.push(stream[:, chunk:]),
            ex.push(np.zeros((C, chunk), np.complex64))]  # drain
    frames = [f for f in collect_sharded_stream_frames(outs, S, spec, n_time=T)
              if f["crc_ok"]]
    assert {(f["channel"], f["payload"]) for f in frames} == {
        (0, b"inside chunk zero"),
        (1, b"straddles the chunk boundary"),
        (1, b"inside chunk one"),
    }
    assert len(frames) == 3  # exactly once each, no seam duplicates
    for f, p in zip(sorted(frames, key=lambda d: d["frame_num"]),
                    [pos[0], pos[1], pos[2]]):
        assert abs(f["abs_start"] - p) < spec.cp_len
