"""Observability: perf counters + link metrics (SURVEY.md §5)."""

import time

from ofdm_jax.utils.metrics import Ewma, LinkMetrics, PerfCounters


def test_ewma():
    e = Ewma(alpha=0.5)
    assert e.update(10) == 10
    assert e.update(20) == 15


def test_perf_counters():
    pc = PerfCounters()
    for _ in range(3):
        with pc.stage("work", items=1000):
            time.sleep(0.01)
    r = pc.report()
    assert r["work"]["calls"] == 3
    assert 5 < r["work"]["ewma_ms"] < 100
    assert r["work"]["ewma_items_per_s"] > 1000
    assert "work" in pc.report_json()


def test_link_metrics():
    m = LinkMetrics()
    m.update_from_frames([
        {"crc_ok": True, "payload_len": 10, "evm": 0.1, "fine_cfo": 0.05},
        {"crc_ok": True, "payload_len": 20, "evm": 0.3, "fine_cfo": 0.06},
        {"crc_ok": False, "payload_len": 0, "evm": 1.0},
    ])
    m.add_samples(100000)
    s = m.summary()
    assert s["frames_ok"] == 2 and s["frames_crc_fail"] == 1
    assert abs(s["frame_error_rate"] - 1 / 3) < 1e-3
    assert s["bytes_ok"] == 30
    assert abs(s["mean_evm"] - 0.2) < 1e-6
    assert s["cfo_last"] == 0.06
    assert s["samples_per_sec"] > 0
