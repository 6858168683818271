"""Config 4 measured row: wideband RX (polyphase channelizer -> N parallel
OFDM demods) single-chip throughput in WIDEBAND samples/s.

BASELINE.json config 4: "64-ch polyphase channelizer feeding parallel OFDM
demods (wideband spectrum probe)".  Frames ride a few channels; every
injected frame must come back valid (same no-dropped-work rule as bench.py).

Run on the card: python bench/wideband.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tests"))

import numpy as np

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmConfig, StreamConfig
from ofdm_jax.modem.wideband import wideband_rx_block
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import maybe_encode


def make_wideband_block(spec, n_chan: int, block: int, frame, chans=(3, 17, 40)):
    """One wideband block with `frame` synthesized on a few channel centers.

    Zero-stuff upsampling is followed by a REAL interpolation lowpass (the
    channelizer prototype itself) -- bare zero-stuffing replicates the frame
    spectrum at every channel frequency, and each image decodes (measured:
    64 detections/block from 3 injected frames)."""
    from ofdm_jax.spectrum.channelizer import lowpass_taps

    rng = np.random.RandomState(0)
    x = (rng.randn(block) + 1j * rng.randn(block)).astype(np.complex64) * 0.01
    per = block // n_chan
    n = np.arange(block)
    interp = lowpass_taps(n_chan)
    m = 1 << int(np.ceil(np.log2(block + len(interp))))  # FFT conv: direct
    ifft_taps = np.fft.fft(interp, m)                    # conv is O(n*taps)
    for c in chans:
        up = np.zeros(per, np.complex64)
        pos = 200
        if pos + len(frame) <= per:
            up[pos : pos + len(frame)] = frame
        stuffed = np.zeros(block, np.complex64)
        stuffed[::n_chan] = up * n_chan
        base = np.fft.ifft(np.fft.fft(stuffed, m) * ifft_taps)[:block]
        base = base.astype(np.complex64)
        x += (base * np.exp(2j * np.pi * c * n / n_chan)).astype(np.complex64)
    return x, len(chans)


def main():
    from golden import golden_ofdm as G

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                     max_payload_bytes=64)
    spec = cfg.spec
    n_chan = 64
    sc = StreamConfig(block_size=1 << 25, max_frames_per_block=4)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(48))).astype(np.complex64)

    x, n_frames = make_wideband_block(spec, n_chan, sc.block_size, frame)
    enc = jax.device_put(maybe_encode(x))
    jax.block_until_ready(enc)

    ex = StreamExecutor(wideband_rx_block(spec, n_chan, sc), sc.block_size)

    @jax.jit
    def reduce_valid(vs):
        return jnp.sum(jnp.stack([v.sum() for v in vs]))

    n_timed = max(4, (1 << 24) // sc.block_size)

    def trial():
        t0 = time.perf_counter()
        outs = [ex.push(enc).result.valid for _ in range(n_timed)]
        nf = int(jax.device_get(reduce_valid(outs)))
        return time.perf_counter() - t0, nf

    trial()
    ex.reset()
    results = [trial() for _ in range(3)]
    dt = min(r[0] for r in results)
    nf = results[0][1]
    # frames sit 200 samples into each per-channel block, inside the same
    # step's ownership window: exactly n_frames detections per step, no
    # images on other channels (interpolated synthesis above)
    assert nf == n_frames * n_timed, (nf, n_frames, n_timed)

    sps = n_timed * sc.block_size / dt
    row = {
        "kernel": "wideband_rx_64ch",
        "n_chan": n_chan,
        "block": sc.block_size,
        "sec": dt / n_timed,
        "msamp_s_wideband": sps / 1e6,
        "frames_per_block_detected": nf / n_timed,
    }
    print(json.dumps(row))
    path = pathlib.Path(__file__).parent / "results_wideband.json"
    path.write_text(json.dumps({"suite": "wideband_rx", "rows": [row]},
                               indent=1))


if __name__ == "__main__":
    main()
