"""BASELINE config 5 at its stated shape: 512 channels x long capture over
a (channel x time) mesh, frames recovered exactly once (VERDICT r3 item 1).

Runs on the virtual 8-device CPU mesh (tests/conftest.py).  The capture is
built with the synthesis filterbank (spectrum.channelizer.synthesize_
wideband, the channelizer's TX dual), so recovery exercises the REAL
analysis chain: sharded channelizer (raw-sample ppermute halo) -> GSPMD
all_to_all reshard -> (channel x time) sharded demod with ownership tiling.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmConfig
from ofdm_jax.modem.rx_stream import history_len
from ofdm_jax.modem.tx import tx_frame
from ofdm_jax.shard.mesh import make_mesh
from ofdm_jax.shard.rx import (
    collect_sharded_frames,
    collect_sharded_stream_frames,
)
from ofdm_jax.shard.wideband import (
    sharded_wideband_capture_fn,
    sharded_wideband_stream_block,
)
from ofdm_jax.spectrum.channelizer import lowpass_taps, synthesize_wideband


def _frame(spec, payload: bytes, fnum: int) -> np.ndarray:
    buf = np.zeros(spec.max_payload_bytes - 4, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    r = jax.jit(lambda p: tx_frame(spec, p, len(payload), fnum))(
        jnp.asarray(buf)
    )
    n = int(r.n_samples)
    return np.asarray(r.samples)[:n]


@pytest.mark.slow
def test_config5_512ch_sharded_wideband_exactly_once():
    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                     max_payload_bytes=64)
    spec = cfg.spec
    H = history_len(spec)
    n_chan = 512
    n_c, n_t = 4, 2
    mesh = make_mesh(n_channel=n_c, n_time=n_t)
    S = 2048                      # per-channel samples per time shard (>= H)
    M = n_t * S                   # per-channel capture length
    own_edge = S - H              # ownership boundary between time shards

    # three frames: mid-shard-0, straddling the ownership boundary (owned by
    # shard 0, samples extending into shard 1's block), and mid-shard-1
    targets = {
        5: (b"config5 channel five", 300),
        300: (b"config5 straddler", own_edge - 200),
        511: (b"config5 last channel", own_edge + 500),
    }
    chans = np.zeros((M, n_chan), np.complex64)
    for k, (msg, off) in targets.items():
        f = _frame(spec, msg, k)
        assert off + len(f) < M - H  # the capture's last H is owned by no shard
        chans[off : off + len(f), k] = f

    taps = lowpass_taps(n_chan, taps_per_arm=8)
    wide = synthesize_wideband(chans, taps)
    rng = np.random.RandomState(0)
    wide = wide + (rng.randn(len(wide)) + 1j * rng.randn(len(wide))).astype(
        np.complex64
    ) * 0.004

    fn = jax.jit(sharded_wideband_capture_fn(
        spec, mesh, n_chan, S, taps=taps, max_frames_per_shard=4
    ))
    res = jax.block_until_ready(fn(jnp.asarray(wide)))
    frames = [f for f in collect_sharded_frames(res, S, spec, n_t)
              if f["crc_ok"]]

    got = {(f["channel"], f["payload"]) for f in frames}
    assert got == {(k, msg) for k, (msg, _) in targets.items()}
    # exactly once: no frame reported by both time shards
    assert len(frames) == len(targets), [
        (f["channel"], f["abs_start"]) for f in frames
    ]
    by_chan = {f["channel"]: f for f in frames}
    for k, (_, off) in targets.items():
        # analysis+synthesis filterbank group delay ~ taps_per_arm at
        # channel rate (cf. test_wideband tolerance)
        assert abs(by_chan[k]["abs_start"] - off) < 40, (
            k, off, by_chan[k]["abs_start"]
        )
        assert by_chan[k]["frame_num"] == k


@pytest.mark.slow
def test_config5_512ch_streaming_checkpoint_restart(tmp_path):
    """Kill/restart the RESUMABLE streaming wideband RX mid-stream at 512
    channels (VERDICT r4 missing #1): the raw-sample channelizer carry and
    the channel-domain demod carry round-trip through a checkpoint, and frames
    straddling a chunk boundary AND a time-shard ownership boundary are
    each recovered exactly once by the restarted executor.

    The carries are raw/channel-domain samples, not backend kernel state
    (channelize_stream's contract), so a checkpoint taken on one backend
    resumes on another -- this test runs the CPU path on the virtual mesh.
    """
    from ofdm_jax.stream.checkpoint import load_state, resume_step, save_state
    from ofdm_jax.stream.executor import StreamExecutor
    from ofdm_jax.utils.device_io import to_host

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                     max_payload_bytes=64)
    spec = cfg.spec
    H = history_len(spec)
    n_chan = 512
    n_c, n_t = 4, 2
    mesh = make_mesh(n_channel=n_c, n_time=n_t)
    S = 2048                       # per-channel samples per time shard (>= H)
    M_c = n_t * S                  # per-channel samples per chunk
    chunk = n_chan * M_c           # flat wideband samples per chunk

    # ownership tiling (chan-domain abs): chunk k, shard t owns
    # [(k*n_t + t)*S - H, ... + S).  With S == H the boundaries fall at
    # 0, S, 2S, ...; abs 2S = M_c is simultaneously a time-shard ownership
    # boundary and the chunk data boundary.
    targets = {
        5: (b"wideband stream early", 300),            # mid shard, chunk 0
        300: (b"straddles chunk cut", M_c - 400),      # spans chunks 0->1
        511: (b"straddles shard edge", S - 200),       # spans shard 0->1
    }
    chans = np.zeros((2 * M_c, n_chan), np.complex64)
    for k, (msg, off) in targets.items():
        f = _frame(spec, msg, k)
        chans[off : off + len(f), k] = f

    taps = lowpass_taps(n_chan, taps_per_arm=8)
    wide = synthesize_wideband(chans, taps)
    rng = np.random.RandomState(1)
    wide = wide + (rng.randn(len(wide)) + 1j * rng.randn(len(wide))).astype(
        np.complex64) * 0.004
    wide = np.concatenate([wide, np.zeros(3 * chunk - len(wide),
                                          np.complex64)])
    feeds = [wide[:chunk], wide[chunk : 2 * chunk], wide[2 * chunk :]]

    def mk():
        return StreamExecutor(
            sharded_wideband_stream_block(
                spec, mesh, n_chan, S, taps=taps, max_frames_per_shard=4),
            chunk, donate=False,
        )

    # uninterrupted reference
    ex_ref = mk()
    want = [to_host(ex_ref.push(f)) for f in feeds]

    # run chunk 0, checkpoint, "crash", restore into a fresh executor
    ex1 = mk()
    outs_a = [to_host(ex1.push(feeds[0]))]
    save_state(str(tmp_path / "wb_ckpt"), ex1)
    del ex1

    ex2 = mk()
    meta = load_state(str(tmp_path / "wb_ckpt"), ex2)
    assert resume_step(meta) == 1
    outs_b = [to_host(ex2.push(feeds[1])), to_host(ex2.push(feeds[2]))]

    key = lambda f: (f["channel"], f["abs_start"], f["payload"], f["crc_ok"],
                     f["frame_num"])
    got = collect_sharded_stream_frames(outs_a + outs_b, S, spec, n_time=n_t)
    ref = collect_sharded_stream_frames(want, S, spec, n_time=n_t)
    assert sorted(map(key, got)) == sorted(map(key, ref))
    ok = [f for f in got if f["crc_ok"]]
    assert {(f["channel"], f["payload"]) for f in ok} == {
        (k, msg) for k, (msg, _) in targets.items()}
    assert len(ok) == len(targets), [
        (f["channel"], f["abs_start"]) for f in ok]
    by_chan = {f["channel"]: f for f in ok}
    for k, (_, off) in targets.items():
        # analysis+synthesis filterbank group delay ~ taps_per_arm
        assert abs(by_chan[k]["abs_start"] - off) < 40, (
            k, off, by_chan[k]["abs_start"])
        assert by_chan[k]["frame_num"] == k
