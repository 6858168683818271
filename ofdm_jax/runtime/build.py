"""Build the native runtime library (g++ -> _native.so).

Invoked automatically on first import of ofdm_jax.runtime (cached by mtime),
or manually:  python -m ofdm_jax.runtime.build
"""

from __future__ import annotations

import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = [
    os.path.join(_HERE, "native", f)
    for f in ("ringbuf.cc", "convert.cc", "reader.cc")
]
SO_PATH = os.path.join(_HERE, "_native.so")


def needs_build() -> bool:
    if not os.path.exists(SO_PATH):
        return True
    so_m = os.path.getmtime(SO_PATH)
    return any(os.path.getmtime(s) > so_m for s in _SRC)


def build(verbose: bool = False) -> str:
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-Wall", "-o", SO_PATH, *_SRC, "-lpthread",
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed:\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr, file=sys.stderr)
    return SO_PATH


def ensure_built() -> str | None:
    """Build if stale; returns the .so path or None if no toolchain."""
    try:
        if needs_build():
            build()
        return SO_PATH
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    print(build(verbose=True))
