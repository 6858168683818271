"""Distributed runtime tests (SURVEY.md §2c "Distributed comm backend").

Two layers:
  * single-process, 8 virtual CPU devices: psum metric aggregation,
    all_gather spectrum consensus, heartbeat, control-plane no-op path;
  * true MULTI-PROCESS: two jax.distributed processes (Gloo over
    localhost), 2 devices each, running the full surface -- init, global
    mesh spanning processes, broadcast_one_to_all control plane, sharded
    RX capture with a frame straddling the process boundary, psum,
    all_gather, heartbeat (tests/helpers/dist_worker.py).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from ofdm_jax.shard import distributed as D
from ofdm_jax.shard.mesh import make_mesh


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(n_channel=4, n_time=2)


def test_initialize_noop_single_process():
    D.initialize()  # no env, no args -> must not raise or spin
    assert jax.process_count() == 1


def test_broadcast_control_single_process_identity():
    msg = {"cmd": "retune", "freq": 100e6}
    assert D.broadcast_control(msg) == msg


def test_psum_tree_totals(mesh8):
    n = 8
    # per-device rows: device i contributes i+1 to every counter
    rows = np.arange(1, n + 1, dtype=np.float32)
    c = D.LinkCounters(*(rows * k for k in range(1, 7)))
    tot = D.psum_tree(c, mesh8)
    tot = jax.tree.map(lambda a: np.asarray(a), tot)
    s = rows.sum()
    assert float(tot.frames_detected) == s
    assert float(tot.samples) == 6 * s
    m = D.metrics_from_counters(tot)
    assert m["frames_detected"] == int(s)
    # crc_fail counters were rows*3 -> global rate = 3s / s = 3.0
    assert m["frame_error_rate"] == 3.0


def test_counters_from_rx_roundtrip():
    from ofdm_jax.config import OfdmConfig
    from ofdm_jax.modem.rx import rx_block
    from ofdm_jax.modem.tx import pack_stream, tx_frames

    cfg = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                     max_payload_bytes=32)
    spec = cfg.spec
    payload = np.frombuffer(b"counters!", dtype=np.uint8)
    fr = tx_frames(spec, payload[None, :],
                   np.array([len(payload)], np.int32),
                   np.array([1], np.int32))
    sig = np.asarray(pack_stream(fr, gap=400))
    buf = np.zeros(8192, np.complex64)
    buf[500 : 500 + len(sig)] = sig
    res = rx_block(spec, buf, max_frames=4)
    c = D.counters_from_rx(res, buf.size)
    assert float(c.frames_detected) == 1.0
    assert float(c.frames_ok) == 1.0
    assert float(c.bytes_ok) == len(payload)
    assert float(c.samples) == buf.size


def test_all_gather_spectrum_replicates(mesh8):
    nbins = 32
    psd = (np.arange(8, dtype=np.float32)[:, None] * 10.0
           + np.arange(nbins, dtype=np.float32))
    g = np.asarray(D.all_gather_spectrum(psd, mesh8))
    # time axis (2 shards) sees identical rows -> pmean is identity here
    np.testing.assert_allclose(g, psd, rtol=1e-6)


def test_heartbeat_single_process():
    hb = D.MeshHeartbeat()
    c = hb.beat(5)
    assert c.tolist() == [5]
    hb.beat(6)
    assert hb.stalled == []
    hb.beat(6)  # no progress
    assert hb.stalled == [0]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_multiprocess_end_to_end():
    """Spawn 2 real jax.distributed processes; see dist_worker.py."""
    worker = os.path.join(os.path.dirname(__file__), "helpers",
                          "dist_worker.py")
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(__file__))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=repo_root,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {i}" in out, out[-3000:]
