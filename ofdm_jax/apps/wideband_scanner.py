"""Wideband scanner: channelize a wideband stream, report per-channel power
and optionally demodulate OFDM on every channel in parallel.

JAX rebuild of the reference's scanner app over the polyphase
channelizer (SURVEY.md §2a "Apps": scanner; §2b pfb_channelizer feeding N
demod chains).  One jitted program channelizes and demodulates all N
channels per time-block (BASELINE.json config 4).

Usage:
  python -m ofdm_jax.apps.wideband_scanner --file wide.c64 --channels 64
  python -m ofdm_jax.apps.wideband_scanner --noise 1 --channels 16 --blocks 8 --demod
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ofdm_jax.apps.common import add_ofdm_args, add_source_args, make_source, ofdm_config, run
from ofdm_jax.config import StreamConfig
from ofdm_jax.modem.wideband import collect_wideband_frames, wideband_rx_block
from ofdm_jax.spectrum.channelizer import channelizer_block
from ofdm_jax.stream.block import Block, chain, complex_to_mag_squared, stateless
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import to_host


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wideband_scanner", description=__doc__)
    add_source_args(p)
    add_ofdm_args(p)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--block-size", type=int, default=0,
                   help="wideband samples per step (default 1024*channels)")
    p.add_argument("--blocks", type=int, default=16)
    p.add_argument("--demod", action="store_true",
                   help="run OFDM RX on every channel")
    p.add_argument("--threshold", type=float, default=-50.0,
                   help="active-channel power threshold (dBFS)")
    args = p.parse_args(argv)

    n_chan = args.channels
    bs = args.block_size or 1024 * n_chan
    src = make_source(args, bs)

    if args.demod:
        cfg = ofdm_config(args)
        spec = cfg.spec
        sc = StreamConfig(block_size=bs, max_frames_per_block=4)
        ex = StreamExecutor(wideband_rx_block(spec, n_chan, sc), bs)
        all_frames = []
        for i, block in enumerate(src):
            if i >= args.blocks:
                break
            out = ex.push(block)
            all_frames.extend(
                f for f in collect_wideband_frames([to_host(out)],
                                                   bs // n_chan, spec)
                if f["crc_ok"]
            )
        for f in all_frames:
            print(f"ch {f['channel']:3d} frame {f['frame_num']:4d} "
                  f"evm={f['evm']:.4f} {f['payload'][:40]!r}")
        print(f"{len(all_frames)} frames across {n_chan} channels",
              file=sys.stderr)
        return 0

    # power-scan mode: channelizer -> mean |.|^2 per channel
    import jax.numpy as jnp

    probe = chain(
        channelizer_block(n_chan),
        complex_to_mag_squared(),
        stateless(lambda x: jnp.mean(x, axis=-2), "chan_power"),
        name="scanner",
    )
    ex = StreamExecutor(probe, bs)
    acc = np.zeros(n_chan)
    n = 0
    for i, block in enumerate(src):
        if i >= args.blocks:
            break
        acc += np.asarray(to_host(ex.push(block)))
        n += 1
    pwr_db = 10 * np.log10(np.maximum(acc / max(n, 1), 1e-20))
    active = np.nonzero(pwr_db > args.threshold)[0]
    for c in range(n_chan):
        tag = " *" if c in active else ""
        print(f"ch {c:3d}  {pwr_db[c]:7.1f} dBFS{tag}")
    print(f"{len(active)} active channels above {args.threshold} dBFS",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    run(main)
