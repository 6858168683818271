"""Checkpoint/resume of streaming state (SURVEY.md §5)."""

import numpy as np

from ofdm_jax.config import OfdmConfig, StreamConfig
from ofdm_jax.modem.rx_stream import collect_frames, history_len, rx_stream_block
from ofdm_jax.stream.checkpoint import load_state, resume_step, save_state
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import to_host

from tests.test_stream import _make_stream


def test_resume_recovers_straddling_frame(tmp_path):
    """Checkpoint mid-stream with a frame straddling the cut; the resumed
    executor must still decode it (sync state survives the restart)."""
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    spec = cfg.spec
    bs = 2048
    # frame 1 straddles the boundary between block 1 and block 2
    stream, pos = _make_stream(
        cfg, [b"before checkpoint", b"straddles the cut"], [500, 2950]
    )
    n_blocks = -(-len(stream) // bs)
    pad = np.concatenate([stream, np.zeros(n_blocks * bs - len(stream),
                                           np.complex64)])

    scfg = StreamConfig(block_size=bs, max_frames_per_block=4)

    # uninterrupted reference run
    ex_ref = StreamExecutor(rx_stream_block(spec, scfg), bs, donate=False)
    want = collect_frames(ex_ref.run(pad, drain=True), bs, history_len(spec))

    # run half, checkpoint, restore into a fresh executor, run the rest
    ex1 = StreamExecutor(rx_stream_block(spec, scfg), bs, donate=False)
    outs_a = [to_host(ex1.push(pad[i * bs:(i + 1) * bs])) for i in range(2)]
    save_state(str(tmp_path / "ckpt"), ex1, meta={"note": "mid-capture"})

    ex2 = StreamExecutor(rx_stream_block(spec, scfg), bs, donate=False)
    meta = load_state(str(tmp_path / "ckpt"), ex2)
    assert resume_step(meta) == 2
    rest = pad[2 * bs:]
    outs_b = [to_host(o) for o in ex2.run(rest, drain=True)]
    # outs_b step counters continue from the checkpoint
    got = collect_frames(outs_a + outs_b, bs, history_len(spec))

    key = lambda f: (f["payload"], f["frame_num"], f["abs_start"], f["crc_ok"])
    assert sorted(map(key, got)) == sorted(map(key, want))
    assert len(got) == 2 and all(f["crc_ok"] for f in got)


def test_mismatched_config_rejected(tmp_path):
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    scfg = StreamConfig(block_size=1024, max_frames_per_block=4)
    ex = StreamExecutor(rx_stream_block(cfg.spec, scfg), 1024, donate=False)
    save_state(str(tmp_path / "c"), ex)

    ex_other = StreamExecutor(rx_stream_block(cfg.spec, scfg), 2048,
                              donate=False)
    import pytest

    with pytest.raises(ValueError, match="block_size"):
        load_state(str(tmp_path / "c"), ex_other)


def test_sharded_stream_checkpoint_restart(tmp_path):
    """Kill/restart a SHARDED capture mid-stream (VERDICT r1 item 9): the
    multi-device carry round-trips through a checkpoint, and a frame straddling the
    checkpoint cut is recovered exactly once by the restarted executor."""
    import jax

    from ofdm_jax.shard import (collect_sharded_stream_frames, make_mesh,
                                sharded_rx_stream_block)
    from tests.test_shard import _make_frame

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")
    spec = cfg.spec
    mesh = make_mesh(n_channel=2, n_time=4)
    S, C, T = 4096, 2, 4
    chunk = T * S
    rng = np.random.RandomState(13)
    stream = np.zeros((C, 2 * chunk), np.complex64)
    f0 = _make_frame(spec, b"pre-checkpoint frame", frame_num=0)
    f1 = _make_frame(spec, b"straddles the restart", frame_num=1)
    p0, p1 = 4000, chunk - len(f1) // 2
    stream[0, p0 : p0 + len(f0)] = f0
    stream[0, p1 : p1 + len(f1)] = f1
    stream += ((rng.randn(*stream.shape) + 1j * rng.randn(*stream.shape))
               * 0.01).astype(np.complex64)

    def mk():
        return StreamExecutor(
            sharded_rx_stream_block(spec, mesh, C, S, max_frames_per_shard=4),
            chunk, donate=False,
        )

    zeros = np.zeros((C, chunk), np.complex64)

    # uninterrupted reference
    ex_ref = mk()
    want = [ex_ref.push(stream[:, :chunk]), ex_ref.push(stream[:, chunk:]),
            ex_ref.push(zeros)]

    # run chunk 0, checkpoint, "crash", restore into a fresh executor
    ex1 = mk()
    outs_a = [to_host(ex1.push(stream[:, :chunk]))]
    save_state(str(tmp_path / "shard_ckpt"), ex1)
    del ex1

    ex2 = mk()
    meta = load_state(str(tmp_path / "shard_ckpt"), ex2)
    assert resume_step(meta) == 1
    outs_b = [to_host(ex2.push(stream[:, chunk:])), to_host(ex2.push(zeros))]

    key = lambda f: (f["channel"], f["abs_start"], f["payload"], f["crc_ok"],
                     f["frame_num"])
    got = collect_sharded_stream_frames(outs_a + outs_b, S, spec, n_time=T)
    ref = collect_sharded_stream_frames(
        [jax.tree.map(np.asarray, o) for o in want], S, spec, n_time=T)
    assert sorted(map(key, got)) == sorted(map(key, ref))
    ok = [f for f in got if f["crc_ok"]]
    assert {f["payload"] for f in ok} == {b"pre-checkpoint frame",
                                          b"straddles the restart"}
    assert len(ok) == 2
