"""Checkpoint/resume for streaming-executor state.

The reference has NO checkpointing (SURVEY.md §5: nearest thing is raw
file_sink captures) -- a stopped flowgraph loses sync state, equalizer
taps, filter history, and its position in the stream.  Here the executor's
whole carry is an explicit pytree, so persisting it is trivial: a restarted
process resumes mid-stream with frame sync, channel estimates, and sample
counters intact (also the recovery path for multi-host elastic restarts,
SURVEY.md §5 "Failure detection").

Format: the host-side numpy leaves in one .npz file (np.savez, loaded with
allow_pickle=False) plus a meta.json; leaves are plain arrays, so a
checkpoint restores on any backend.
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import numpy as np

from ofdm_jax.stream.executor import StreamExecutor
from ofdm_jax.utils.device_io import maybe_encode, to_host


def save_state(path: str, executor: StreamExecutor, meta: dict | None = None):
    """Persist an executor's carry + counters to `path` (a directory)."""
    path = os.path.abspath(path)
    host_state = to_host(executor.state)
    leaves, treedef = jax.tree.flatten(host_state)
    os.makedirs(path, exist_ok=True)
    np.savez(
        os.path.join(path, "state.npz"),
        **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)},
    )
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(
            {
                "samples_in": executor.samples_in,
                "block_size": executor.block_size,
                "block_name": executor.block.name,
                "n_leaves": len(leaves),
                **(meta or {}),
            },
            f,
        )


def load_state(path: str, executor: StreamExecutor) -> dict:
    """Restore a checkpoint into `executor` (must wrap the same Block
    configuration).  Returns the checkpoint metadata."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["block_size"] != executor.block_size:
        raise ValueError(
            f"checkpoint block_size {meta['block_size']} != executor "
            f"{executor.block_size}"
        )
    with np.load(os.path.join(path, "state.npz"),
                 allow_pickle=False) as restored:
        leaves = [restored[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    template = maybe_encode(executor.block.init())
    treedef = jax.tree.structure(template)
    if treedef.num_leaves != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, block expects "
            f"{treedef.num_leaves} -- config mismatch?"
        )
    state = jax.tree.unflatten(treedef, leaves)
    # shapes must match the block's own init exactly (np.savez round-trips
    # exact dtypes, but guard against hand-edited checkpoints)
    for a, b in zip(jax.tree.leaves(template), leaves):
        if np.asarray(a).shape != np.asarray(b).shape:
            raise ValueError(
                f"leaf shape mismatch {np.asarray(b).shape} vs "
                f"{np.asarray(a).shape}"
            )
    executor.state = state
    executor.samples_in = meta["samples_in"]
    return meta


def resume_step(meta: dict) -> int:
    """Stream step index to continue from (samples_in / block_size)."""
    return meta["samples_in"] // meta["block_size"]
