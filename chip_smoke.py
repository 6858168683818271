"""Smoke test of the streaming OFDM receiver on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # config 5 on four cards vs one card

Phases, in order; every check is an assert and any failure exits non-zero:

  1. device: JAX's backend must be a GPU (there is no CPU fallback); prints
     the device kind and nvidia-smi's name and power limit.
  2-3. the GPU lane, tests/test_gpu.py, in this process: detect kernels vs
     the plain path vs float64 at n = 2^25 + history, the slot gather, the
     channelizer, the PSD, BASELINE configs 1-4 and streaming TX.
  4. the headline main path: StreamExecutor(rx_stream_block) at fft_len
     64, CP 16, QPSK, 2^25-sample blocks, K = 480, 448 frames per block
     made by the TX on the card, 24 steps, every frame checked (CRC,
     payload, position).  Then steady-state Msamp/s with and without the
     detect kernels, for information.
  5. the last line: {"ok": true, "device": {...}}.

--four-cards runs phase 1 and config 5 only: the 512-channel wideband
capture through sharded_wideband_capture_fn and
sharded_wideband_stream_block on a 2x2 (channel x time) mesh of four
cards, compared with the same capture on one card, plus the psum /
all_gather paths of shard.distributed.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ofdm_jax.config import OfdmConfig, StreamConfig  # noqa: E402
from ofdm_jax.modem.rx_stream import (collect_frames, history_len,  # noqa: E402
                                      rx_stream_block)
from ofdm_jax.modem.tx import tx_frame  # noqa: E402
from ofdm_jax.ops import sync  # noqa: E402
from ofdm_jax.stream.executor import StreamExecutor  # noqa: E402
from ofdm_jax.utils.compile_cache import enable_compile_cache  # noqa: E402
from ofdm_jax.utils.device_io import to_host  # noqa: E402

FRAMES_PER_BLOCK = 448
N_TIMED = 24


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_phase():
    assert jax.default_backend() == "gpu", jax.default_backend()
    devices = jax.devices()
    assert devices and devices[0].platform == "gpu", devices
    print("device_kind:", devices[0].device_kind, "count:", len(devices))
    card = card_line()
    print("card:", card.splitlines()[0])
    return devices, card.splitlines()[0]


def gpu_lane_phase():
    import pytest

    os.environ["OFDM_JAX_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", str(REPO / "tests" / "test_gpu.py")])
    assert rc == 0, f"GPU lane failed (pytest exit {rc})"


def device_frame(spec, payload: bytes, frame_num: int = 0) -> np.ndarray:
    """One frame from the TX chain on the device (modem.tx.tx_frame)."""
    buf = np.zeros(spec.max_payload_bytes - 4, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    r = jax.jit(lambda p: tx_frame(spec, p, len(payload), frame_num))(buf)
    return np.asarray(r.samples)[:int(r.n_samples)]


def headline_blocks(spec, frame, n_blocks: int, block_size: int, seed=0):
    """Blocks of FRAMES_PER_BLOCK frames over a noise floor, at the same
    offsets in every block, so any order of the staged blocks is a stream
    whose every frame is intact.  Returns (blocks, positions)."""
    gap = (block_size - 2 * len(frame)) // FRAMES_PER_BLOCK
    assert gap > len(frame), "frames would overlap"
    pos = 100 + gap * np.arange(FRAMES_PER_BLOCK)
    rng = np.random.RandomState(seed)
    blocks = ((rng.randn(n_blocks, block_size)
               + 1j * rng.randn(n_blocks, block_size)) * 0.02
              ).astype(np.complex64)
    for b in range(n_blocks):
        for p in pos:
            blocks[b, p:p + len(frame)] += frame
    return blocks, pos


def _plain_detect(spec, r):
    return sync._detect_rows_jnp(spec, (r.re + 1j * r.im).astype(jnp.complex64))


def headline_phase(card: str, block_size: int = 1 << 25,
                   max_frames: int = 480, n_steps: int = N_TIMED):
    import golden.golden_ofdm as G

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")
    spec = cfg.spec
    sc = StreamConfig(block_size=block_size, max_frames_per_block=max_frames)
    payload = bytes(range(64)) * 2
    frame = device_frame(spec, payload)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    np.testing.assert_allclose(frame, G.tx_frame(gp, payload), atol=2e-5)
    blocks, pos = headline_blocks(spec, frame, 4, sc.block_size)
    staged = [jax.device_put(b) for b in blocks]
    jax.block_until_ready(staged)
    H = history_len(spec)
    assert pos[-1] < sc.block_size - H      # every frame owned by its step
    backoff = min(4, cfg.cp_len // 4)

    # correctness: every frame of every step, on the path the card runs
    ex = StreamExecutor(rx_stream_block(spec, sc), sc.block_size)
    frames = collect_frames(
        [to_host(ex.push(staged[i % 4])) for i in range(n_steps)],
        sc.block_size, H)
    want = [s * sc.block_size + int(p) + cfg.cp_len - backoff
            for s in range(n_steps) for p in pos]
    assert len(frames) == len(want), (len(frames), len(want))
    for f, w in zip(frames, want):
        assert f["crc_ok"] and f["payload"] == payload, f["abs_start"]
        assert abs(f["abs_start"] - w) <= 4, (f["abs_start"], w)
    print(f"headline: {len(frames)}/{len(want)} frames over {n_steps} steps "
          f"of {sc.block_size} samples, CRC, payload and position checked")

    @jax.jit
    def n_valid(vs):
        return jnp.sum(jnp.stack([v.sum() for v in vs]))

    def rate(label):
        ex = StreamExecutor(rx_stream_block(spec, sc), sc.block_size)

        def trial():
            t0 = time.perf_counter()
            vs = [ex.push(staged[i % 4]).result.valid for i in range(n_steps)]
            n = int(jax.device_get(n_valid(vs)))
            return time.perf_counter() - t0, n

        trial()
        ex.reset()
        runs = [trial() for _ in range(3)]
        assert all(n == len(want) for _, n in runs), runs
        msps = n_steps * sc.block_size / min(t for t, _ in runs) / 1e6
        print(f"headline detect={label}: {msps:.1f} Msamp/s steady state "
              f"({n_steps} steps, best of 3; {card})")
        return msps

    kernel_rows = sync.detect_rows
    rates = {"kernel": [], "plain": []}
    try:
        for label in ("kernel", "plain", "plain", "kernel"):
            sync.detect_rows = kernel_rows if label == "kernel" else _plain_detect
            rates[label].append(rate(label))
    finally:
        sync.detect_rows = kernel_rows
    return rates


# ---------------------------------------------------------------- config 5

N_CHAN = 512
ACTIVE = (5, 130, 300, 511)


def config5_capture(spec, taps, n_total: int, gap: int = 2500):
    """Sparse 512-channel capture: periodic frames (TX on the device) on
    the ACTIVE channels, synthesized through the polyphase synthesis
    filterbank, over a noise floor."""
    from ofdm_jax.spectrum.channelizer import synthesize_bursts

    M = n_total // N_CHAN
    payload = b"config5 frame"
    f = device_frame(spec, payload)
    bursts = []
    limit = M - history_len(spec) - len(f)
    for k in ACTIVE:
        p = 300 + 37 * k % 600
        while p < limit:
            bursts.append((k, p, f))
            p += gap
    wide = synthesize_bursts(n_total, N_CHAN, bursts, taps=taps)
    rng = np.random.RandomState(0)
    wide = wide + ((rng.randn(n_total) + 1j * rng.randn(n_total)) * 0.004
                   ).astype(np.complex64)
    return wide, sorted((k, p, payload) for k, p, _ in bursts)


def _frame_set(frames):
    """Every valid slot as (channel, abs_start, payload, crc_ok): a header
    can pass on a neighbouring channel's leakage, so CRC-failed slots are
    compared too, and the injected frames are matched on crc_ok only."""
    return sorted((f["channel"], f["abs_start"], f["payload"], f["crc_ok"])
                  for f in frames)


def four_cards_phase(devices, card: str, per_card: int = 1 << 25):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ofdm_jax.shard import distributed as D
    from ofdm_jax.shard.mesh import CHANNEL_AXIS, TIME_AXIS, make_mesh
    from ofdm_jax.shard.rx import (collect_sharded_frames,
                                   collect_sharded_stream_frames)
    from ofdm_jax.shard.wideband import (sharded_wideband_capture_fn,
                                         sharded_wideband_stream_block)
    from ofdm_jax.spectrum.channelizer import lowpass_taps

    assert len(devices) >= 4, f"needs four devices, found {len(devices)}"
    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                     max_payload_bytes=64)
    spec = cfg.spec
    taps = lowpass_taps(N_CHAN, taps_per_arm=8)
    n_total = 4 * per_card
    M = n_total // N_CHAN
    wide, injected = config5_capture(spec, taps, n_total)
    meshes = {4: make_mesh(2, 2, devices=devices[:4]),
              1: make_mesh(1, 1, devices=devices[:1])}
    flat = P((CHANNEL_AXIS, TIME_AXIS))

    captured, streamed = {}, {}
    for n_dev, mesh in meshes.items():
        n_t = mesh.shape[TIME_AXIS]
        S = M // n_t
        x = jax.device_put(wide, NamedSharding(mesh, flat))
        # frame slots per channel and shard: frames are >= 2048 apart
        fn = jax.jit(sharded_wideband_capture_fn(
            spec, mesh, N_CHAN, S, taps=taps,
            max_frames_per_shard=S // 2048 + 4))
        res = jax.block_until_ready(fn(x))
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(x))
        dt = time.perf_counter() - t0
        captured[n_dev] = _frame_set(
            collect_sharded_frames(to_host(res), S, spec, n_t))
        print(f"config5 capture on {n_dev} card(s), mesh {dict(mesh.shape)}:"
              f" {sum(f[3] for f in captured[n_dev])} frames with CRC, "
              f"{len(captured[n_dev])} valid slots, {dt * 1e3:.1f} ms for "
              f"{n_total} wideband samples ({card})")

        # resumable streaming form: the capture in two chunks
        blk = sharded_wideband_stream_block(
            spec, mesh, N_CHAN, S // 2, taps=taps,
            max_frames_per_shard=S // 4096 + 4)
        step = jax.jit(blk.apply)
        state = blk.init()
        outs = []
        for k in range(2):
            chunk = jax.device_put(wide[k * n_total // 2:(k + 1) * n_total // 2],
                                   NamedSharding(mesh, flat))
            state, o = step(state, chunk)
            outs.append(to_host(o))
        streamed[n_dev] = _frame_set(
            collect_sharded_stream_frames(outs, S // 2, spec, n_t))
        print(f"config5 stream on {n_dev} card(s): {len(streamed[n_dev])} "
              f"frames over 2 chunks")

    # exactly once, same channel, same abs_start on four cards as on one
    assert captured[4] == captured[1], "capture differs between 4 and 1 cards"
    assert streamed[4] == streamed[1], "stream differs between 4 and 1 cards"
    good = [f[:3] for f in captured[4] if f[3]]
    assert len(good) == len(injected), (len(good), len(injected))
    for (c, s, p), (ic, ip, ipl) in zip(good, injected):
        assert c == ic and p == ipl and abs(s - ip) < 40, ((c, s), (ic, ip))
    # no frame lies in the last history_len samples, so the two chunks of
    # the stream own exactly what the one-shot capture owns
    assert streamed[4] == captured[4], "stream differs from the capture"

    mesh = meshes[4]
    counters = D.LinkCounters(
        *(np.full(4, float(i + 1), np.float32) for i in range(6)))
    tot = D.psum_tree(counters, mesh)
    assert D.metrics_from_counters(jax.tree.map(np.asarray, tot))[
        "frames_detected"] == 4
    psd = np.random.RandomState(1).rand(mesh.shape[CHANNEL_AXIS], 128
                                        ).astype(np.float32)
    np.testing.assert_allclose(np.asarray(D.all_gather_spectrum(psd, mesh)),
                               psd, rtol=1e-5)
    hb = D.MeshHeartbeat(mesh)
    hb.beat(1)
    hb.beat(2)
    assert hb.stalled == []
    print(f"config5: {len(good)}/{len(injected)} frames exactly once "
          f"on 4 cards == 1 card; psum/all_gather/heartbeat OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only config 5 on four cards against one card")
    args = ap.parse_args(argv)
    enable_compile_cache()
    devices, card = device_phase()
    if args.four_cards:
        four_cards_phase(devices, card)
    else:
        gpu_lane_phase()
        headline_phase(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
