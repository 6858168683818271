"""Host<->device boundary shim: optionally carry complex (and bool) as
f32 (and int32) across jit boundaries.

`packed_io(fn)` wraps a function for jit so that, when packing is on, every
complex leaf crosses the boundary as a PackedComplex pytree node (two
float32 arrays) and every bool leaf as int32; inside the program the
wrapper reassembles native complex64/bool so op code stays idiomatic.
Packing is off unless set_packing(True) forces it (the tests of the
machinery itself do), so by default every wrapper here is a pass-through
and programs take and return native complex.  PackedComplex also serves as
the planar (re, im) f32 form that detection and the slot gathers read.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class PackedComplex:
    """A complex array split into (re, im) float32 leaves (pytree node)."""

    re: Any
    im: Any

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim


def _is_packed(x) -> bool:
    return isinstance(x, PackedComplex)


_FORCE_PACKING: bool | None = None


def set_packing(value: bool | None) -> None:
    """Force packing on/off (None = the default, off).  Test hook."""
    global _FORCE_PACKING
    _FORCE_PACKING = value


def needs_packing() -> bool:
    return bool(_FORCE_PACKING)


def encode(x):
    """Host or device: complex -> PackedComplex, bool -> int32."""
    if isinstance(x, PackedComplex):
        return x
    dt = getattr(x, "dtype", None)
    if dt is not None and jnp.issubdtype(dt, jnp.complexfloating):
        if isinstance(x, np.ndarray):
            return PackedComplex(
                np.ascontiguousarray(x.real, dtype=np.float32),
                np.ascontiguousarray(x.imag, dtype=np.float32),
            )
        return PackedComplex(
            jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
        )
    if dt is not None and dt == jnp.bool_:
        return x.astype(np.int32 if isinstance(x, np.ndarray) else jnp.int32)
    return x


def decode(x):
    """PackedComplex -> complex (jnp on device, np on host)."""
    if isinstance(x, PackedComplex):
        if isinstance(x.re, np.ndarray):
            return (x.re + 1j * x.im).astype(np.complex64)
        return (x.re + 1j * x.im).astype(jnp.complex64)
    return x


def encode_tree(tree):
    return jax.tree.map(encode, tree)


def decode_tree(tree):
    return jax.tree.map(decode, tree, is_leaf=_is_packed)


def packed_io(fn):
    """Wrap `fn` so complex/bool never cross the jit boundary when packing
    is on (an identity wrapper otherwise).

    The wrapped function accepts encoded args (complex leaves as
    PackedComplex, bools as int32) and returns encoded outputs; inside,
    `fn` sees native dtypes.
    """

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        if not needs_packing():
            return fn(*args, **kwargs)
        args = decode_tree(args)
        kwargs = decode_tree(kwargs)
        out = fn(*args, **kwargs)
        return encode_tree(out)

    return inner


def maybe_encode(tree):
    """Host-side: encode a pytree iff packing is on."""
    return encode_tree(tree) if needs_packing() else tree


def jit_safe(fn, **jit_kwargs):
    """jit(fn) with complex/bool-safe boundaries.  The returned callable
    accepts and returns native complex/bool arrays (decoded host-side)."""
    jitted = jax.jit(packed_io(fn), **jit_kwargs)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not needs_packing():
            return jitted(*args, **kwargs)
        out = jitted(*encode_tree(args), **encode_tree(kwargs))
        return to_host(out)

    return call


def to_host(tree):
    """Fetch a device pytree to numpy.  Accepts encoded or plain trees;
    complex leaves come back as numpy complex64.  Uses one batched
    jax.device_get for the whole tree rather than one readback per leaf."""
    flat, treedef = jax.tree.flatten(tree, is_leaf=_is_packed)
    raw = []
    for x in flat:  # expand PackedComplex into its leaves for one device_get
        if _is_packed(x):
            raw.extend((x.re, x.im))
        else:
            raw.append(x)
    fetched = jax.device_get(raw)
    host, i = [], 0
    for x in flat:
        if _is_packed(x):
            host.append(decode(PackedComplex(fetched[i], fetched[i + 1])))
            i += 2
        else:
            host.append(np.asarray(fetched[i]))
            i += 1
    return jax.tree.unflatten(treedef, host)
