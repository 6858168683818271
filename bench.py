"""Headline benchmark: streaming OFDM RX throughput on one GPU.

Prints the platform, device kind and card (nvidia-smi name and power
limit), then ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}.  Exits non-zero when JAX's backend is not a GPU: a number from
any other backend is not a measurement of this system.

vs_baseline reports the fraction of 1 Gsample/s (BASELINE.json's
aggregate target) achieved by this single-card measurement.

Method: steady-state samples/s of the full jitted RX chain (Schmidl-Cox
sync -> CFO derotate -> FFT demod -> chanest -> equalize -> demap -> CRC)
over a continuous stream of 2^25-sample blocks carrying 448 real frames per
block (burst traffic within the 480-frame-slot capacity).  Every injected
frame must be detected AND demodulated with a valid header -- the count is
asserted, so the number cannot be inflated by dropping work.  Blocks are
pre-staged on the device: this cell measures the receiver, not the
host-to-device feed (io.feed).  Warmup excluded; each timed trial ends
with a readback of a value that depends on every step.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

from ofdm_jax.config import OfdmConfig, StreamConfig  # noqa: E402
from ofdm_jax.modem.rx_stream import history_len, rx_stream_block  # noqa: E402
from ofdm_jax.stream.executor import StreamExecutor  # noqa: E402
from ofdm_jax.utils.compile_cache import enable_compile_cache  # noqa: E402
from ofdm_jax.utils.device_io import maybe_encode  # noqa: E402

BASELINE_SAMPLES_PER_S = 1e9  # north-star aggregate target (BASELINE.json)

FRAMES_PER_BLOCK = 448


def make_blocks(spec, n_blocks: int, block_size: int, seed=0):
    """Blocks with FRAMES_PER_BLOCK frames each over a noise floor.

    Frames come from the frozen numpy golden TX (bit-identical to modem.tx,
    asserted by tests/test_modem.py) to keep the benchmark's compile budget
    on the RX chain being measured.  Frames are placed fully inside each
    block at identical offsets so that recycling the staged blocks in any
    order yields a stream whose every frame is intact and countable.
    """
    from golden import golden_ofdm as G

    rng = np.random.RandomState(seed)
    msg = bytes(range(64)) * 2
    gp = G.GoldenOfdmParams(
        fft_len=spec.fft_len, cp_len=spec.cp_len, modulation=spec.modulation
    )
    frame = G.tx_frame(gp, msg).astype(np.complex64)
    gap = (block_size - 2 * len(frame)) // FRAMES_PER_BLOCK
    assert gap > len(frame), "frames would overlap"
    blocks = (
        rng.randn(n_blocks, block_size) + 1j * rng.randn(n_blocks, block_size)
    ).astype(np.complex64) * 0.02
    for b in range(n_blocks):
        for j in range(FRAMES_PER_BLOCK):
            pos = 100 + j * gap
            blocks[b, pos : pos + len(frame)] += frame
    return blocks


def main():
    enable_compile_cache()
    platform = jax.default_backend()
    dev = jax.devices()[0]
    print(f"platform={platform} device_kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    if platform != "gpu":
        print(f"bench.py measures the GPU; JAX's backend is {platform}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card={card}")
    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")
    spec = cfg.spec
    # 2^25-sample blocks and K = 480 frame slots (448 injected frames, ~7%
    # headroom) are the headline shape; bench/headline_sweep.py sweeps the
    # block size, which on the GPU is not tuned yet
    sc = StreamConfig(block_size=1 << 25, max_frames_per_block=480)

    blocks = make_blocks(spec, 4, sc.block_size)
    enc = [jax.device_put(maybe_encode(b)) for b in blocks]
    jax.block_until_ready(enc)

    ex = StreamExecutor(rx_stream_block(spec, sc), sc.block_size)

    # Each trial reduces every step's detection mask to one scalar on the
    # device and fetches it, so the time covers every step's execution.
    import jax.numpy as jnp

    n_timed = 24

    def reduce_valid(vs):
        return jnp.sum(jnp.stack([v.sum() for v in vs]))

    reduce_jit = jax.jit(reduce_valid)

    def trial():
        t0 = time.perf_counter()
        outs = [
            ex.push(enc[i % len(enc)]).result.valid for i in range(n_timed)
        ]
        n_frames = int(jax.device_get(reduce_jit(outs)))
        return time.perf_counter() - t0, n_frames

    trial()  # warmup: compiles the step + the reducer
    ex.reset()
    results = [trial() for _ in range(3)]
    dt = min(r[0] for r in results)
    n_frames = results[0][1]
    # Every injected frame must come out as a valid detection.  The first
    # trial after reset() sees exactly n_timed blocks; frames whose ownership
    # window lags past the final step (the trailing history_len samples) are
    # reported one step later, so allow that tail only.
    expect = FRAMES_PER_BLOCK * n_timed
    tail = -(-history_len(spec) * FRAMES_PER_BLOCK // sc.block_size) + 1
    assert expect - tail <= n_frames <= expect, (n_frames, expect)

    sps = n_timed * sc.block_size / dt
    print(
        json.dumps(
            {
                "metric": "ofdm_rx_stream_throughput_1chip",
                "value": round(sps / 1e6, 3),
                "unit": "Msamples/s",
                "vs_baseline": round(sps / BASELINE_SAMPLES_PER_S, 4),
                "device": {"platform": platform, "kind": dev.device_kind,
                           "card": card},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
