"""Timing utilities for the per-kernel microbenchmarks.

Every timed region ends with one batched device_get of scalars, amortized
over many queued dispatches, and each op is repeated inside one program
with a data dependency between iterations, so per-dispatch overhead does
not dominate small ops; see bench().
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Callable

# the golden model (tests/golden) is imported as `golden`, as the tests do
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import jax
import jax.numpy as jnp

from ofdm_jax.utils.device_io import maybe_encode, packed_io


def _reduce_leaves(out) -> jnp.ndarray:
    acc = jnp.float32(0)
    for leaf in jax.tree.leaves(out):
        leaf = jnp.asarray(leaf)
        if jnp.issubdtype(leaf.dtype, jnp.complexfloating):
            acc = acc + jnp.sum(jnp.real(leaf)) + jnp.sum(jnp.imag(leaf))
        else:
            acc = acc + jnp.sum(leaf).astype(jnp.float32)
    return acc


def bench(fn: Callable, args: tuple, reps: int = 24, n_iter: int = 4,
          trials: int = 3) -> float:
    """Seconds per evaluation of `fn` (a plain function over device-safe
    pytrees).

    The op is repeated `reps` times INSIDE one program via lax.fori_loop.  Each
    iteration's reduced output perturbs the first argument by s*1e-30
    (a runtime value XLA cannot fold away, numerically a no-op in f32):
    this serializes iterations and defeats loop-invariant code motion.
    """

    def repeated(*a):
        def perturb(leaf, s):
            leaf = jnp.asarray(leaf)
            if jnp.issubdtype(leaf.dtype, jnp.inexact):
                return leaf + (s * 1e-30).astype(leaf.dtype)
            return leaf

        def body(i, carry):
            x, acc = carry
            s = _reduce_leaves(fn(x, *a[1:]))
            return jax.tree.map(lambda l: perturb(l, s), x), acc + s

        _, acc = jax.lax.fori_loop(
            0, reps, body, (a[0], jnp.float32(0)))
        return acc

    jfn = jax.jit(packed_io(repeated))
    dargs = jax.device_put(maybe_encode(args))
    jax.device_get(jfn(*dargs))  # compile + warm

    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        scalars = [jfn(*dargs) for _ in range(n_iter)]
        jax.device_get(scalars)
        best = min(best, (time.perf_counter() - t0) / (n_iter * reps))
    return best


class Report:
    """Collects rows, prints a table + one JSON line each, saves to disk."""

    def __init__(self, name: str):
        self.name = name
        self.rows: list[dict[str, Any]] = []

    def add(self, **row):
        self.rows.append(row)
        print(json.dumps({k: _round(v) for k, v in row.items()}))

    def save(self, path: str | None = None):
        path = path or f"bench/results_{self.name}_{jax.default_backend()}.json"
        with open(path, "w") as f:
            json.dump(
                {
                    "suite": self.name,
                    "backend": jax.default_backend(),
                    "device": str(jax.devices()[0]),
                    "rows": self.rows,
                },
                f,
                indent=1,
            )
        print(f"# saved {path}")


def _round(v):
    return round(v, 4) if isinstance(v, float) else v
