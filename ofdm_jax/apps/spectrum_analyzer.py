"""Distributed spectrum analyzer: local worker + remote client.

JAX rebuild of gr-ofdm_tools' flagship tool pair (SURVEY.md §2a
"Local spectrum worker"/"Remote spectrum client", §3.4 call stack:
python/local_worker.py + remote_client.py, unverified paths).

  local  -- runs beside the capture: source -> jitted PSD probe on device ->
            packs avg/max PSD + metadata -> UDP to the client; polls the
            socket for control messages (retune => frequency-shift the
            source stream; a real SDR frontend would retune hardware).
  remote -- receives PSD frames, renders spectrum/waterfall in the
            terminal, can send a retune on startup.

Usage:
  python -m ofdm_jax.apps.spectrum_analyzer local --remote-host H [--file F]
  python -m ofdm_jax.apps.spectrum_analyzer remote [--port P]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ofdm_jax.apps.common import add_source_args, make_source, run
from ofdm_jax.io import SpectrumPublisher, SpectrumSubscriber
from ofdm_jax.spectrum import render_ascii, render_spectrum_line, spectrum_probe_block
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import to_host


def run_local(args) -> int:
    ex = StreamExecutor(
        spectrum_probe_block(args.fft_len, window=args.window),
        args.block_size,
    )
    src = make_source(args, args.block_size)
    pub = SpectrumPublisher((args.remote_host, args.port))
    center_freq = args.center_freq
    shift = 0.0  # software retune offset (fraction of fs)
    sent = 0
    t_next = time.time()
    try:
        for i, block in enumerate(src):
            if args.blocks and i >= args.blocks:
                break
            if shift:
                n = np.arange(len(block))
                block = (block * np.exp(-2j * np.pi * shift * n)).astype(
                    np.complex64
                )
            out = ex.push(block)
            now = time.time()
            if now >= t_next:
                s = to_host(out)
                pub.publish(
                    center_freq, args.sample_rate, s.avg_db, s.max_db,
                    int(s.n_frames),
                )
                sent += 1
                t_next = now + 1.0 / args.frame_rate
                for msg in pub.poll_control():
                    if msg.get("cmd") == "retune":
                        new = float(msg["freq"])
                        shift += (new - center_freq) / args.sample_rate
                        center_freq = new
                        print(f"retuned to {center_freq/1e6:.3f} MHz",
                              file=sys.stderr)
                    elif msg.get("cmd") == "reset":
                        ex.reset()
    except KeyboardInterrupt:
        pass
    finally:
        pub.close()
    print(f"published {sent} spectrum frames", file=sys.stderr)
    return 0


def run_mesh(args) -> int:
    """Multi-device wideband worker (SURVEY.md §5 last row): channelize the
    capture over a (channel x time) device mesh, per-channel PSD, on-device
    `all_gather_spectrum` consensus -- then ONE UDP publish of the full-band
    view (instead of the reference's every-worker-ships-its-PSD socket
    fan-in).  Retune control messages are re-broadcast to every process via
    shard.distributed.broadcast_control before being applied."""
    import jax

    from ofdm_jax.shard import balanced_factors, make_mesh
    from ofdm_jax.shard.distributed import broadcast_control
    from ofdm_jax.shard.wideband import flatten_band, mesh_psd_step_fn
    from ofdm_jax.utils.device_io import maybe_encode, packed_io

    devices = jax.devices()
    n_c, n_t = balanced_factors(len(devices))
    mesh = make_mesh(n_channel=n_c, n_time=n_t)
    n_chan, nb = args.n_chan, args.chan_fft_len
    quantum = n_chan * nb * n_t
    block_size = max(1, args.block_size // quantum) * quantum
    step, C_tail = mesh_psd_step_fn(mesh, n_chan, nb, window=args.window)
    jstep = jax.jit(packed_io(step))

    src = make_source(args, block_size)
    pub = SpectrumPublisher((args.remote_host, args.port))
    center_freq = args.center_freq
    shift = 0.0
    tail = maybe_encode(np.zeros(C_tail, np.complex64))
    max_hold = None
    sent = 0
    t_next = time.time()
    try:
        for i, block in enumerate(src):
            if args.blocks and i >= args.blocks:
                break
            if shift:
                n = np.arange(len(block))
                block = (block * np.exp(-2j * np.pi * shift * n)).astype(
                    np.complex64
                )
            full, tail = jstep(tail, maybe_encode(block))
            now = time.time()
            if now >= t_next:
                flat = flatten_band(np.asarray(to_host(full)))
                max_hold = flat if max_hold is None else np.maximum(
                    max_hold, flat
                )
                pub.publish(center_freq, args.sample_rate, flat, max_hold, 1)
                sent += 1
                t_next = now + 1.0 / args.frame_rate
                ctl = pub.poll_control()
                # every process applies the SAME control stream: process 0's
                # messages win (single-process: identity)
                ctl = broadcast_control(ctl)
                for msg in ctl or []:
                    if msg.get("cmd") == "retune":
                        new = float(msg["freq"])
                        shift += (new - center_freq) / args.sample_rate
                        center_freq = new
                        print(f"retuned to {center_freq/1e6:.3f} MHz",
                              file=sys.stderr)
                    elif msg.get("cmd") == "reset":
                        max_hold = None
    except KeyboardInterrupt:
        pass
    finally:
        pub.close()
    print(
        f"published {sent} consensus frames from a {n_c}x{n_t} mesh "
        f"({n_chan} channels x {nb} bins)",
        file=sys.stderr,
    )
    return 0


def run_remote(args) -> int:
    sub = SpectrumSubscriber(bind_port=args.port)
    if args.retune:
        print("will request retune after first frame", file=sys.stderr)
    rows = []
    got = 0
    try:
        while args.frames == 0 or got < args.frames:
            fr = sub.receive(timeout=args.timeout)
            if fr is None:
                print("timeout waiting for spectrum frames", file=sys.stderr)
                return 1
            got += 1
            if args.retune and got == 1:
                sub.send_control({"cmd": "retune", "freq": args.retune})
            psd = np.roll(fr.avg_db, len(fr.avg_db) // 2)  # center DC
            rows.append(psd)
            rows = rows[-args.depth:]
            line = render_spectrum_line(psd, width=args.width)
            lo = fr.center_freq - fr.sample_rate / 2
            hi = fr.center_freq + fr.sample_rate / 2
            print(
                f"#{fr.seq:6d} {lo/1e6:9.3f}..{hi/1e6:9.3f} MHz "
                f"peak {fr.max_db.max():6.1f} dB |{line}|"
            )
            if args.waterfall and got % args.depth == 0:
                print(render_ascii(np.stack(rows), width=args.width))
    except KeyboardInterrupt:
        pass
    finally:
        sub.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spectrum_analyzer", description=__doc__)
    sp = p.add_subparsers(dest="mode", required=True)

    lp = sp.add_parser("local", help="capture-side worker")
    add_source_args(lp)
    lp.add_argument("--fft-len", type=int, default=1024)
    lp.add_argument("--window", default="blackman_harris")
    lp.add_argument("--block-size", type=int, default=1 << 17)
    lp.add_argument("--remote-host", default="127.0.0.1")
    lp.add_argument("--port", type=int, default=46864)
    lp.add_argument("--center-freq", type=float, default=0.0)
    lp.add_argument("--sample-rate", type=float, default=1e6)
    lp.add_argument("--frame-rate", type=float, default=10.0,
                    help="spectrum updates per second")
    lp.add_argument("--blocks", type=int, default=0,
                    help="stop after N blocks (0 = endless)")

    mp = sp.add_parser("mesh", help="multi-device wideband worker")
    add_source_args(mp)
    mp.add_argument("--n-chan", type=int, default=64,
                    help="channelizer channels (sharded over the mesh)")
    mp.add_argument("--chan-fft-len", type=int, default=64,
                    help="PSD bins per channel")
    mp.add_argument("--window", default="hann")
    mp.add_argument("--block-size", type=int, default=1 << 18,
                    help="wideband samples per step (rounded to a whole "
                         "number of per-channel PSD frames per time shard)")
    mp.add_argument("--remote-host", default="127.0.0.1")
    mp.add_argument("--port", type=int, default=46864)
    mp.add_argument("--center-freq", type=float, default=0.0)
    mp.add_argument("--sample-rate", type=float, default=1e6)
    mp.add_argument("--frame-rate", type=float, default=10.0)
    mp.add_argument("--blocks", type=int, default=0)

    rp = sp.add_parser("remote", help="display-side client")
    rp.add_argument("--port", type=int, default=46864)
    rp.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = endless)")
    rp.add_argument("--timeout", type=float, default=5.0)
    rp.add_argument("--width", type=int, default=80)
    rp.add_argument("--depth", type=int, default=24,
                    help="waterfall rows")
    rp.add_argument("--waterfall", action="store_true")
    rp.add_argument("--retune", type=float, default=None,
                    help="request this center freq from the worker")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "local":
        return run_local(args)
    if args.mode == "mesh":
        return run_mesh(args)
    return run_remote(args)


if __name__ == "__main__":
    run(main)
