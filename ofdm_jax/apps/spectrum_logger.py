"""Spectrum logger: periodic PSD snapshots to disk with metadata.

JAX rebuild of gr-ofdm_tools' spectrum_logger (SURVEY.md §2a,
python/spectrum_logger.py, unverified path): runs the PSD probe over a
source and appends timestamped avg/max PSD records.

Format: one .npz per run, arrays stacked over snapshots:
  t (s), center_freq (s,), avg_db (s, nfft), max_db (s, nfft), n_frames (s,)
plus a sidecar .jsonl with one metadata line per snapshot (greppable).

Usage:
  python -m ofdm_jax.apps.spectrum_logger --file cap.c64 --out log --snapshots 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ofdm_jax.apps.common import add_source_args, make_source, run
from ofdm_jax.spectrum import spectrum_probe_block
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import to_host


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrum_logger", description=__doc__)
    add_source_args(p)
    p.add_argument("--fft-len", type=int, default=1024)
    p.add_argument("--window", default="blackman_harris")
    p.add_argument("--block-size", type=int, default=1 << 17)
    p.add_argument("--center-freq", type=float, default=0.0)
    p.add_argument("--sample-rate", type=float, default=1e6)
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between snapshots")
    p.add_argument("--blocks-per-snapshot", type=int, default=0,
                   help="snapshot every N blocks instead of wall time")
    p.add_argument("--snapshots", type=int, default=0,
                   help="stop after N snapshots (0 = endless)")
    p.add_argument("--out", required=True, help="output path stem")
    p.add_argument("--reset-each", action="store_true",
                   help="reset max-hold/avg after every snapshot")
    args = p.parse_args(argv)

    ex = StreamExecutor(
        spectrum_probe_block(args.fft_len, window=args.window),
        args.block_size,
    )
    src = make_source(args, args.block_size)
    recs = {"t": [], "center_freq": [], "avg_db": [], "max_db": [],
            "n_frames": []}
    jsonl = open(args.out + ".jsonl", "a")
    t_next = time.time()
    n_snap = 0
    out = None
    try:
        for i, block in enumerate(src):
            out = ex.push(block)
            due = (
                (i + 1) % args.blocks_per_snapshot == 0
                if args.blocks_per_snapshot
                else time.time() >= t_next
            )
            if not due:
                continue
            t_next = time.time() + args.interval
            s = to_host(out)
            now = time.time()
            recs["t"].append(now)
            recs["center_freq"].append(args.center_freq)
            recs["avg_db"].append(s.avg_db)
            recs["max_db"].append(s.max_db)
            recs["n_frames"].append(int(s.n_frames))
            jsonl.write(json.dumps({
                "t": now, "center_freq": args.center_freq,
                "sample_rate": args.sample_rate, "fft_len": args.fft_len,
                "n_frames": int(s.n_frames),
                "peak_db": float(np.max(s.max_db)),
                "peak_bin": int(np.argmax(s.max_db)),
            }) + "\n")
            n_snap += 1
            if args.reset_each:
                ex.reset()
            if args.snapshots and n_snap >= args.snapshots:
                break
    except KeyboardInterrupt:
        pass
    finally:
        jsonl.close()
        np.savez(
            args.out + ".npz",
            **{k: np.asarray(v) for k, v in recs.items()},
        )
    print(f"wrote {n_snap} snapshots to {args.out}.npz/.jsonl",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    run(main)
