"""Run a declarative JSON flowgraph spec: the `grcc + top_block.run()`
analog (SURVEY.md §3.5 GRC app path / §2b "GRC compiler", unverified
upstream paths: grc/core/, generated top-level Python scripts).

Usage:
  python -m ofdm_jax.apps.run_flowgraph graph.json --tone 0.1 --steps 20
  python -m ofdm_jax.apps.run_flowgraph graph.json --file cap.c64 \
      --block-size 65536 --print-output

Feeds the compiled graph from a file or synthetic source, reports
throughput (the probe_rate / perf-counter story), and optionally prints or
saves the last output pytree.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ofdm_jax import grc
from ofdm_jax.apps.common import add_source_args, make_source, run
from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import to_host


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("spec", help="JSON flowgraph spec file")
    add_source_args(p)
    p.add_argument("--block-size", type=int, default=1 << 15)
    p.add_argument("--steps", type=int, default=10,
                   help="time-blocks to run (synthetic sources run forever)")
    p.add_argument("--print-output", action="store_true",
                   help="print the final step's output pytree")
    p.add_argument("--save-output", help="save final output to .npz")
    args = p.parse_args(argv)

    with open(args.spec) as f:
        spec = json.load(f)
    block = grc.build(spec)
    print(f"flowgraph {block.name!r} compiled "
          f"({len(spec.get('blocks', []))} blocks)")

    ex = StreamExecutor(block, args.block_size)
    src = make_source(args, args.block_size)
    # a multi-input graph (e.g. examples/channelizer_waterfall.json) gets
    # the SAME source stream on every declared input, matching the GRC idiom
    # of fanning one source out to parallel chains
    n_in = len(spec.get("inputs", [])) or 1
    last = None
    steps = 0
    for x in src:
        last = ex.push(x if n_in == 1 else (x,) * n_in)
        steps += 1
        if steps >= args.steps:
            break
    if last is None:
        print("source produced no samples", file=sys.stderr)
        return 1
    import jax
    jax.block_until_ready(ex.state)
    out = to_host(last)
    print(f"{steps} steps, {ex.samples_in} samples, "
          f"{ex.samples_per_sec / 1e6:.1f} Msamples/s")
    if args.print_output:
        print(jax.tree.map(
            lambda a: (a.shape, str(np.asarray(a).dtype)), out))
        print(out)
    if args.save_output:
        flat, _ = jax.tree.flatten(out)
        np.savez(args.save_output,
                 **{f"out_{i}": np.asarray(a) for i, a in enumerate(flat)})
        print(f"saved {args.save_output}")
    return 0


if __name__ == "__main__":
    run(main)
