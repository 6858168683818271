"""Multi-host distributed runtime: process init, control plane, aggregation.

JAX replacement for the reference's inter-host socket layer -- the
UDP/TCP channel between the local spectrum worker and the remote client
(SURVEY.md §2c "Distributed comm backend" + §5 last row; gr-ofdm_tools
python/local_worker.py / remote_client.py, unverified paths).  Where the
reference ships packed PSD vectors and control PMTs over Python sockets,
here:

  * `initialize()` brings up `jax.distributed` (the DCN control plane); the
    global mesh then spans every process's chips and XLA collectives ride
    ICI within a slice / DCN across hosts.
  * `broadcast_control()` replaces the analyzer's UDP control channel
    (retune / gain / reconfig messages): an arbitrary pmt-serializable
    value broadcast from process 0 via multihost_utils.
  * `LinkCounters` + `psum_counters()` aggregate link metrics over the
    whole mesh with ONE psum (the reference mails per-host numbers around).
  * `all_gather_spectrum()` produces the global wideband PSD consensus on
    every device from channel-sharded rows.
  * `MeshHeartbeat` is the multi-host failure detector: every process
    publishes a monotonic progress counter; one all-gather per beat lets
    every host see every other host's progress (SURVEY.md §5 "Failure
    detection": heartbeat via jax.distributed).

Everything here runs unchanged on a single-process multi-device mesh (the
CI story: 8 virtual CPU devices) -- collectives don't care where the mesh's
devices live.  Host-side helpers degrade to no-ops at process_count()==1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ofdm_jax.shard.mesh import CHANNEL_AXIS, TIME_AXIS, make_mesh

try:  # JAX >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


# ---------------------------------------------------------------------------
# Process bring-up (the jax.distributed entry)
# ---------------------------------------------------------------------------


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kw,
) -> None:
    """Bring up the multi-process runtime (jax.distributed.initialize).

    Call once per process before any JAX computation.  With no arguments,
    initialization is attempted from the environment (cluster metadata or
    JAX_COORDINATOR_ADDRESS et al.); a single-process run without any such
    environment is detected and left alone -- so apps can call this
    unconditionally.
    """
    # must not touch the backend (jax.devices/process_count) before
    # jax.distributed.initialize -- probe the distributed state directly
    try:
        from jax._src import distributed as _dist

        if _dist.global_state.client is not None:
            return  # already initialized
    except Exception:  # pragma: no cover - private API drift
        pass
    import os

    has_env = any(
        v in os.environ
        for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    )
    if coordinator_address is None and num_processes is None and not has_env:
        return  # single-process run, nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def global_mesh(n_channel: int | None = None, n_time: int = 1):
    """A (channel, time) mesh over ALL devices of ALL processes.

    After initialize(), jax.devices() enumerates every chip in the slice;
    the mesh layout puts the channel axis outermost so channel-DP
    collectives stay within a host where possible (ICI before DCN).
    """
    return make_mesh(n_channel=n_channel, n_time=n_time)


# ---------------------------------------------------------------------------
# Host control plane (replaces the analyzer's UDP control channel)
# ---------------------------------------------------------------------------

_CTRL_CAPACITY = 4096


def broadcast_control(msg: Any = None, capacity: int = _CTRL_CAPACITY) -> Any:
    """Broadcast a control message (any pmt-serializable value: dict of
    retune/gain/config, etc.) from process 0 to all processes.

    Non-source processes pass msg=None and receive process 0's value.
    Single-process: returns msg unchanged.  The wire format is the io.pmt
    typed serialization, padded to `capacity` bytes (broadcast needs a
    static shape across processes).
    """
    from ofdm_jax.io import pmt

    if jax.process_count() == 1:
        return msg
    from jax.experimental import multihost_utils

    if jax.process_index() == 0:
        wire = pmt.dumps(msg)
        if len(wire) + 4 > capacity:
            raise ValueError(
                f"control message {len(wire)}B exceeds capacity {capacity}"
            )
        buf = np.zeros(capacity, dtype=np.uint8)
        buf[:4] = np.frombuffer(
            len(wire).to_bytes(4, "little"), dtype=np.uint8
        )
        buf[4 : 4 + len(wire)] = np.frombuffer(wire, dtype=np.uint8)
    else:
        buf = np.zeros(capacity, dtype=np.uint8)
    out = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    n = int.from_bytes(out[:4].tobytes(), "little")
    return pmt.loads(out[4 : 4 + n].tobytes())


def barrier(name: str = "ofdm_jax") -> None:
    """Synchronize all processes (start-of-capture alignment)."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


# ---------------------------------------------------------------------------
# Mesh-wide metric aggregation (psum) -- SURVEY.md §5 "Metrics"
# ---------------------------------------------------------------------------


class LinkCounters(NamedTuple):
    """Device-side link counters, psum-able over the mesh.  The on-device
    shadow of utils.metrics.LinkMetrics' additive fields."""

    frames_detected: jnp.ndarray  # () f32
    frames_ok: jnp.ndarray        # () f32
    frames_crc_fail: jnp.ndarray  # () f32
    bytes_ok: jnp.ndarray         # () f32
    evm_sum: jnp.ndarray          # () f32 (over crc-ok frames)
    samples: jnp.ndarray          # () f32

    @staticmethod
    def zeros() -> "LinkCounters":
        z = jnp.zeros((), jnp.float32)
        return LinkCounters(z, z, z, z, z, z)


def counters_from_rx(res, n_samples: int) -> LinkCounters:
    """LinkCounters from an RxBlockResult (device-side, maskable)."""
    valid = res.valid
    ok = valid & res.frames.crc_ok
    f32 = lambda x: jnp.sum(x.astype(jnp.float32))
    return LinkCounters(
        frames_detected=f32(valid),
        frames_ok=f32(ok),
        frames_crc_fail=f32(valid & ~res.frames.crc_ok),
        bytes_ok=f32(jnp.where(ok, res.frames.payload_len, 0)),
        evm_sum=f32(jnp.where(ok, res.frames.evm, 0.0)),
        samples=jnp.float32(n_samples),
    )


def psum_tree(tree: Any, mesh) -> Any:
    """Sum a per-device pytree over the ENTIRE mesh with one psum.

    Each leaf must have leading dim == mesh.devices.size (one row per
    device, e.g. stacked per-shard counters); returns the global totals,
    replicated.  This is the LinkMetrics/heartbeat aggregation path: on a
    pod slice the psum rides ICI/DCN; the reference needed per-host UDP.
    """
    axes = tuple(mesh.axis_names)
    n = int(np.prod([mesh.shape[a] for a in axes]))

    def body(t):
        return jax.tree.map(
            lambda a: jax.lax.psum(jnp.sum(a, axis=0), axes), t
        )

    flat = jax.tree.map(
        lambda a: jnp.reshape(a, (n, *jnp.shape(a)[1:])), tree
    )
    return shard_map(
        body,
        mesh=mesh,
        in_specs=P(axes),
        out_specs=P(),
        check_vma=False,
    )(flat)


def metrics_from_counters(c: LinkCounters) -> dict:
    """Host-side summary dict from (aggregated) LinkCounters."""
    g = lambda x: float(np.asarray(x))
    det, ok = g(c.frames_detected), g(c.frames_ok)
    return {
        "frames_detected": int(det),
        "frames_ok": int(ok),
        "frames_crc_fail": int(g(c.frames_crc_fail)),
        "frame_error_rate": round(g(c.frames_crc_fail) / max(det, 1), 4),
        "bytes_ok": int(g(c.bytes_ok)),
        "mean_evm": round(g(c.evm_sum) / max(ok, 1), 5),
        "samples": int(g(c.samples)),
    }


# ---------------------------------------------------------------------------
# Spectrum consensus (all_gather over the channel axis)
# ---------------------------------------------------------------------------


def all_gather_spectrum(psd, mesh, tiled: bool = True):
    """Channel-sharded PSD rows (C, nbins) -> globally replicated (C, nbins).

    The multi-device analyzer's "full band view": each channel shard holds
    the PSD of its own channels; one all_gather along the channel axis gives
    every device (and thus every host) the whole band -- replacing the
    reference's ship-every-PSD-to-the-client-socket design.  Time axis
    shards average (PSD segments of the same band over time).
    """

    def body(x):
        g = jax.lax.all_gather(x, CHANNEL_AXIS, axis=0, tiled=tiled)
        nt = jax.lax.axis_size(TIME_AXIS)
        if nt > 1:
            g = jax.lax.pmean(g, TIME_AXIS)
        return g

    return shard_map(
        body,
        mesh=mesh,
        in_specs=P(CHANNEL_AXIS, None),
        out_specs=P(),
        check_vma=False,
    )(psd)


# ---------------------------------------------------------------------------
# Multi-host failure detection (heartbeat)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshHeartbeat:
    """Every process publishes a monotonic progress counter; each `beat()`
    all-gathers them so every host sees every other host's progress.  A
    process whose counter hasn't advanced between beats is reported stalled
    (SURVEY.md §5 "Failure detection / elastic recovery").

    Single-process: degrades to watching the one local counter (the
    utils.faults.Watchdog can wrap progress() for wall-clock timeouts)."""

    mesh: Any = None
    _last: np.ndarray | None = None

    def beat(self, local_progress: int) -> np.ndarray:
        """Publish local progress; returns every process's counter."""
        if jax.process_count() == 1:
            counts = np.asarray([local_progress], dtype=np.int64)
        else:
            from jax.experimental import multihost_utils

            counts = np.asarray(
                multihost_utils.process_allgather(
                    np.asarray(local_progress, dtype=np.int64)
                )
            ).reshape(-1)
        stalled = (
            np.nonzero(counts <= self._last)[0].tolist()
            if self._last is not None
            else []
        )
        self._last = counts.copy()
        self.stalled = stalled
        return counts


# ---------------------------------------------------------------------------
# Sharded device_put helper
# ---------------------------------------------------------------------------


def shard_capture(samples, mesh, spec=P(CHANNEL_AXIS, TIME_AXIS)):
    """Place a host capture array onto the mesh with the given partitioning
    (encoded when complex packing is on -- see utils.device_io).

    Multi-process: every process must hold the SAME global array (or at
    least correct data at its addressable shards); each leaf is built via
    make_array_from_callback so only addressable shards are materialized.
    """
    from ofdm_jax.utils.device_io import maybe_encode

    enc = maybe_encode(samples)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(enc, sharding)

    def put(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, sharding, lambda idx: a[idx]
        )

    return jax.tree.map(put, enc)
