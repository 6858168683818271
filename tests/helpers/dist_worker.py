"""Multi-process distributed-runtime worker (spawned by test_distributed).

Each process: 2 virtual CPU devices; global mesh 2x2 (channel x time) over
2 processes.  Exercises the full SURVEY.md §2c/§5 multi-host surface:
initialize -> global mesh -> broadcast_control -> sharded RX capture ->
psum metric aggregation -> all_gather spectrum -> heartbeat.  Prints
"WORKER_OK <pid>" on success; any assert kills the exit code.

Usage: dist_worker.py <process_id> <num_processes> <coordinator_port>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    .replace("--xla_force_host_platform_device_count=8", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

from ofdm_jax.shard import distributed as D  # noqa: E402

D.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc

# --- global mesh across processes: channel x time = 2 x nproc -------------
mesh = D.global_mesh(n_channel=2, n_time=nproc)

# --- control plane: process 0 broadcasts a retune message ------------------
msg = {"cmd": "retune", "freq": 146.52e6, "gain": 20} if pid == 0 else None
got = D.broadcast_control(msg)
assert got == {"cmd": "retune", "freq": 146.52e6, "gain": 20}, got

# --- sharded RX capture across processes ------------------------------------
from ofdm_jax.config import OfdmConfig  # noqa: E402
from ofdm_jax.modem.tx import pack_stream, tx_frames  # noqa: E402
from ofdm_jax.modem.rx_stream import history_len  # noqa: E402
from ofdm_jax.shard.rx import (  # noqa: E402
    collect_sharded_frames,
    sharded_rx_capture_fn,
)

cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk", max_payload_bytes=32)
spec = cfg.spec
S = 4096
T = nproc
C = 2
payload = np.frombuffer(b"hello-dist-world", dtype=np.uint8)
fr = tx_frames(
    spec,
    np.tile(payload, (2, 1)),
    np.array([len(payload)] * 2, np.int32),
    np.array([7, 8], np.int32),
)
sig = np.asarray(pack_stream(fr, gap=256))
stream = np.zeros((C, T * S), dtype=np.complex64)
# channel 0: frame well inside shard 0; channel 1: frame straddling the
# shard boundary (starts before t=1*S, ends after) -- halo must cover it
stream[0, 100 : 100 + len(sig)] = sig
bpos = S - spec.max_frame_len // 2
stream[1, bpos : bpos + len(sig)] = sig
rng = np.random.RandomState(0)
stream += (rng.randn(*stream.shape) + 1j * rng.randn(*stream.shape)).astype(
    np.complex64
) * 0.01

fn = jax.jit(sharded_rx_capture_fn(spec, mesh, S, max_frames_per_shard=4))
res = fn(D.shard_capture(stream, mesh))
# globally-sharded outputs: every process holds only its shards; one
# process_allgather replicates the whole tree host-side
from jax.experimental import multihost_utils  # noqa: E402

res = jax.tree.map(
    np.asarray, multihost_utils.process_allgather(res, tiled=True)
)
frames = collect_sharded_frames(res, S, spec, n_time=T)
ok = [f for f in frames if f["crc_ok"]]
assert len(ok) >= 3, (len(ok), frames)
assert all(f["payload"] == payload.tobytes() for f in ok)
chans = {f["channel"] for f in ok}
assert chans == {0, 1}, chans

# --- psum metric aggregation over the whole mesh ----------------------------
from ofdm_jax.shard.distributed import LinkCounters  # noqa: E402

n_dev = len(jax.devices())
ones = np.ones(n_dev, np.float32)
stacked = LinkCounters(*(ones * (i + 1) for i in range(6)))
tot = D.psum_tree(stacked, mesh)
tot = jax.tree.map(lambda a: np.asarray(jax.device_get(a)), tot)
assert float(tot.frames_detected) == n_dev * 1.0
assert float(tot.samples) == n_dev * 6.0
summary = D.metrics_from_counters(tot)
assert summary["frames_detected"] == n_dev

# --- all_gather spectrum consensus ------------------------------------------
nbins = 64
psd = np.zeros((2, nbins), np.float32)
psd[0] = 1.0 + np.arange(nbins)
psd[1] = 100.0 + np.arange(nbins)
g = D.all_gather_spectrum(psd, mesh)
g = np.asarray(jax.device_get(g))
assert g.shape == (2, nbins), g.shape
np.testing.assert_allclose(g, psd, rtol=1e-6)

# --- heartbeat: see all processes' counters ---------------------------------
hb = D.MeshHeartbeat(mesh)
counts = hb.beat(1000 + pid)
assert counts.tolist() == [1000 + i for i in range(nproc)], counts
counts = hb.beat(2000 + pid)  # all advanced -> none stalled
assert hb.stalled == [], hb.stalled

D.barrier("done")
print(f"WORKER_OK {pid}")
