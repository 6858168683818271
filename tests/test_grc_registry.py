"""Round-trip coverage of EVERY grc.REGISTRY entry (VERDICT r1 weak item 7).

For each registered block type: compile a minimal one-block spec through
grc.build (the grcc analog), run two streaming steps, and sanity-check the
output.  A guard test asserts the case table covers the registry EXACTLY,
so registering a new block type without a round-trip case fails CI.

The full TX -> channel -> RX loopback spec (examples/ofdm_loopback.json,
using NamedTuple-field named ports) is exercised end-to-end under the
StreamExecutor, mirroring the reference's generated top_block running a
complete .grc (SURVEY.md §2b "GRC compiler").
"""

import json
import os

import numpy as np
import pytest

from ofdm_jax import grc
from ofdm_jax.config import OfdmConfig
from ofdm_jax.modem.rx_stream import collect_frames, history_len
from ofdm_jax.modem.tx_stream import empty_tx_in, queue_tx_in
from ofdm_jax.stream.executor import StreamExecutor

BS = 4096  # stream block size used by every case

_OFDM = {"block_size": BS, "max_frames_per_block": 4,
         "modulation": "qpsk", "max_payload_bytes": 64}
_LP = {"design": "low_pass", "gain": 1.0, "fs": 1.0, "cutoff": 0.2,
       "transition_width": 0.1}


def _c64(seed=0, n=BS):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _f32(seed=0, n=BS):
    return np.abs(np.random.RandomState(seed).randn(n)).astype(np.float32) + 0.1


def _tx_in():
    spec = OfdmConfig(**{k: v for k, v in _OFDM.items()
                         if k not in ("block_size", "max_frames_per_block")}).spec
    ti, _ = queue_tx_in(spec, 4, [b"registry round trip"])
    return ti


# type -> (params, input factory).  Keys must cover grc.REGISTRY exactly.
CASES = {
    "multiply_const": ({"k": 2.0}, _c64),
    "add_const": ({"k": 1.0 + 0j}, _c64),
    "complex_to_mag_squared": ({}, _c64),
    "nlog10": ({}, _f32),
    "stream_to_vector": ({"vlen": 64}, _c64),
    "vector_to_stream": ({}, lambda: _c64().reshape(-1, 64)),
    "delay": ({"n": 17}, _c64),
    "moving_average": ({"n": 8}, _f32),
    "single_pole_iir": ({"alpha": 0.1}, _f32),
    "fir_filter": ({"taps": _LP}, _c64),
    "freq_xlating_fir": ({"taps": _LP, "center_freq_rel": 0.1}, _c64),
    "interpolating_fir": ({"taps": _LP, "interp": 2}, _c64),
    "rational_resampler": ({"taps": _LP, "interp": 2, "decim": 4}, _c64),
    "head": ({"n": 100}, _c64),
    "probe_rate": ({}, _c64),
    "pfb_channelizer": ({"n_chan": 8}, _c64),
    "log_pwr_fft": ({"fft_len": 64, "avg_alpha": 0.5}, _c64),
    "spectrum_probe": ({"fft_len": 64}, _c64),
    "waterfall": ({"fft_len": 64, "depth": 8}, _c64),
    "ofdm_rx_stream": (dict(_OFDM), _c64),
    "ofdm_tx_stream": (dict(_OFDM), _tx_in),
    "wideband_rx": (dict(_OFDM, n_chan=8, block_size=1 << 15),
                    lambda: _c64(n=1 << 15)),
    "channel_model": ({"seed": 3, "snr_db": 20.0, "cfo": 0.1,
                       "taps": [1.0, 0.1]}, _c64),
    "ofdm_radio": (dict(_OFDM),
                   lambda: (tuple(_tx_in()), 0.01 * _c64())),
}


def test_cases_cover_registry_exactly():
    assert set(CASES) == set(grc.REGISTRY), (
        "every registered block type needs a round-trip case here; "
        f"missing={sorted(set(grc.REGISTRY) - set(CASES))} "
        f"stale={sorted(set(CASES) - set(grc.REGISTRY))}"
    )


@pytest.mark.parametrize("btype", sorted(CASES))
def test_registry_round_trip(btype):
    """spec dict -> grc.build -> two apply steps; leaves must be finite."""
    params, make_in = CASES[btype]
    blk = grc.build({
        "name": f"rt_{btype}",
        "blocks": [{"id": "b", "type": btype, "params": params}],
        "connections": [],
        "inputs": ["b"],
        "outputs": ["b"],
    })
    import jax

    state = blk.init()
    for step in (0, 1):
        state, y = jax.jit(blk.apply)(state, make_in())
        for leaf in jax.tree.leaves(y):
            arr = np.asarray(leaf)
            if np.issubdtype(arr.dtype, np.inexact):
                assert np.isfinite(arr).all(), f"{btype} step {step}"


def test_registry_descriptors_expose_params():
    """Every descriptor introspects at least its declared param names
    (the GRC XML <param> analog used by UIs)."""
    for name, desc in grc.REGISTRY.items():
        assert isinstance(desc.params, dict)
        params, _ = CASES[name]
        fixed = set(desc.params)
        for p in params:
            assert desc.open_ended or p in fixed, (name, p)


def test_loopback_example_end_to_end():
    """examples/ofdm_loopback.json: PDUs -> TX -> channel -> RX recovers
    every payload through the executor (named-port spec round trip)."""
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "ofdm_loopback.json")
    with open(path) as f:
        spec_json = json.load(f)
    radio = grc.build(spec_json)
    assert radio.stream_input is False  # inherited from the PDU-fed TX

    ofdm = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    msgs = [b"grc loopback pdu %d" % i for i in range(5)]
    b0, rest = queue_tx_in(ofdm.spec, 4, msgs, frame_num0=0)
    b1, rest = queue_tx_in(ofdm.spec, 4, rest, frame_num0=4)
    assert not rest

    ex = StreamExecutor(radio, 4096)
    outs, accepted = [], []
    feeds = [b0, b1] + [empty_tx_in(ofdm.spec, 4)] * 6
    for ti in feeds:
        rx_out, acc = ex.push(ti)
        outs.append(rx_out)
        accepted.append(np.asarray(acc))
    assert accepted[0].all() and accepted[1][0]

    frames = collect_frames(outs, 4096, history_len(ofdm.spec))
    assert len(frames) == len(msgs)
    for i, f in enumerate(sorted(frames, key=lambda f: f["frame_num"])):
        assert f["crc_ok"]
        assert f["payload"] == msgs[i]
        assert f["frame_num"] == i
