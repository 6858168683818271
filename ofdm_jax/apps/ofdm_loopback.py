"""OFDM loopback demo: TX frames -> channel -> streaming RX, print stats.

JAX equivalent of the reference's transceiver example flowgraphs
(SURVEY.md §2a "Examples": loopback TX->channel->RX .grc demos) driven from
the CLI, exercising the full modem both ways on one device.

Usage:
  python -m ofdm_jax.apps.ofdm_loopback --frames 10 --snr 20 --cfo 0.1
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

import jax

from ofdm_jax.apps.common import add_ofdm_args, ofdm_config, run
from ofdm_jax.config import StreamConfig
from ofdm_jax.modem.rx_stream import collect_frames, history_len, rx_stream_block
from ofdm_jax.modem.tx import tx_frames
from ofdm_jax.ops.channel import channel_model
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import jit_safe, to_host


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ofdm_loopback", description=__doc__)
    add_ofdm_args(p)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--payload", default="the quick brown fox jumps over the lazy dog")
    p.add_argument("--snr", type=float, default=None, help="AWGN SNR in dB")
    p.add_argument("--cfo", type=float, default=0.0,
                   help="carrier offset in subcarrier units")
    p.add_argument("--multipath", action="store_true",
                   help="apply a 3-tap multipath channel")
    p.add_argument("--gap", type=int, default=500,
                   help="silence samples between frames")
    p.add_argument("--block-size", type=int, default=1 << 14)
    p.add_argument("--equalizer", default="pilot_phase",
                   choices=["pilot_phase", "simpledfe"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cfg = ofdm_config(args)
    spec = cfg.spec

    # --- TX ---------------------------------------------------------------
    payloads = [
        f"[{i:03d}] {args.payload}".encode()[: cfg.max_payload_bytes - 4]
        for i in range(args.frames)
    ]
    cap = cfg.max_payload_bytes - 4
    bufs = np.zeros((args.frames, cap), np.uint8)
    lens = np.zeros(args.frames, np.int32)
    for i, pl in enumerate(payloads):
        bufs[i, : len(pl)] = np.frombuffer(pl, np.uint8)
        lens[i] = len(pl)
    fr = jit_safe(lambda b, l, n: tx_frames(spec, b, l, n))(
        bufs, lens, np.arange(args.frames, dtype=np.int32)
    )
    parts = []
    for i in range(args.frames):
        parts.append(np.zeros(args.gap, np.complex64))
        n = int(fr.n_samples[i])
        parts.append(np.asarray(fr.samples[i][:n], np.complex64))
    parts.append(np.zeros(args.gap, np.complex64))
    clean = np.concatenate(parts)

    # --- channel ----------------------------------------------------------
    taps = np.array([1.0, 0.25 - 0.15j, 0.12j]) if args.multipath else None
    rx = np.asarray(
        jit_safe(
            lambda v: channel_model(
                jax.random.PRNGKey(args.seed), v, snr_db=args.snr,
                cfo=args.cfo, fft_len=cfg.fft_len,
                taps=None if taps is None else np.asarray(taps, np.complex64),
            )
        )(clean)
    )

    # --- RX ---------------------------------------------------------------
    sc = StreamConfig(block_size=args.block_size, max_frames_per_block=8)
    ex = StreamExecutor(rx_stream_block(spec, sc, equalizer=args.equalizer),
                        sc.block_size)
    outs = [to_host(o) for o in ex.run(rx, drain=True)]
    frames = collect_frames(outs, block_size=sc.block_size,
                            hist=history_len(spec))

    ok = 0
    for f in frames:
        status = "OK " if f["crc_ok"] else "CRC-FAIL"
        print(
            f"{status} #{f['frame_num']:3d} start={f['abs_start']:7d} "
            f"evm={f['evm']:.4f} cfo={f['fine_cfo']:+.4f} "
            f"payload={f['payload'][:48]!r}"
        )
        if f["crc_ok"] and f["payload"] in payloads:
            ok += 1
    print(
        f"recovered {ok}/{args.frames} frames "
        f"({cfg.modulation}, fft={cfg.fft_len}, snr={args.snr}, "
        f"cfo={args.cfo}, multipath={args.multipath})",
        file=sys.stderr,
    )
    return 0 if ok == args.frames else 1


if __name__ == "__main__":
    run(main)
