"""EVM-vs-SNR / BER-vs-SNR measurement harness (BASELINE configs 1-3).

The reference publishes no curves (BASELINE.md); the correctness bound is
"demodulated symbols + bits match the reference chain within its EVM/SNR
bound" with the frozen numpy golden model as oracle (SURVEY.md §4).  This
harness runs the SAME impaired captures through the framework RX and the
golden RX and records, per SNR point: mean payload EVM, payload BER over
detected frames, frame error rate (missed detection or CRC fail), and the
golden model's EVM on identical captures.

Used two ways:
  * python bench/curves.py           -> bench/results_curves.json + a
    markdown table for BASELINE.md (runs on whatever backend is default)
  * tests/test_curves.py             -> asserts monotonicity, threshold
    SNRs, and EVM parity vs golden on a reduced grid (CPU)
"""

from __future__ import annotations

import json
import pathlib
import sys
from dataclasses import dataclass

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tests"))

import numpy as np

import jax
import jax.numpy as jnp

from ofdm_jax.config import OfdmConfig
from ofdm_jax.modem.rx import rx_block
from ofdm_jax.modem.tx import tx_frame
from ofdm_jax.ops.channel import channel_model
from ofdm_jax.utils.device_io import jit_safe, to_host


@dataclass(frozen=True)
class CurveConfig:
    name: str
    cfg: OfdmConfig
    cfo: float = 0.0
    taps: tuple[complex, ...] | None = None
    output: str = "hard"


def baseline_configs() -> list[CurveConfig]:
    """BASELINE.json configs 1-3 as measurable channel setups."""
    return [
        CurveConfig(
            "config1_bpsk64_awgn",
            OfdmConfig(fft_len=64, cp_len=16, modulation="bpsk",
                       max_payload_bytes=64),
        ),
        CurveConfig(
            "config2_qpsk256_cfo",
            OfdmConfig(fft_len=256, cp_len=64, modulation="qpsk",
                       max_payload_bytes=256),
            cfo=1.3,
        ),
        CurveConfig(
            "config3_qam16_multipath_soft",
            OfdmConfig(fft_len=64, cp_len=16, modulation="qam16",
                       max_payload_bytes=64),
            taps=(1.0, 0.0, 0.35 + 0.2j, 0.0, 0.1j),
            output="soft",
        ),
    ]


def measure_point(cc: CurveConfig, snr_db: float, n_trials: int,
                  payload: bytes, rx_fn=None, golden: bool = True):
    """One SNR point: returns dict with evm/ber/fer (+ golden_evm)."""
    from golden import golden_ofdm as G

    spec = cc.cfg.spec
    cap = cc.cfg.max_payload_bytes - 4
    buf = np.zeros(cap, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    txr = jit_safe(lambda p, l: tx_frame(spec, p, l, 1))(
        jnp.asarray(buf), len(payload)
    )
    txr = to_host(txr)
    n_tx = int(np.asarray(txr.n_samples))
    # tail pad must cover a full max_frame_len gather window from the
    # detected start, or rx_block's clamp drags the window off the frame
    clean = np.concatenate(
        [np.zeros(256, np.complex64),
         np.asarray(txr.samples)[:n_tx],
         np.zeros(spec.max_frame_len + 64, np.complex64)]
    )
    taps = (jnp.asarray(np.asarray(cc.taps), jnp.complex64)
            if cc.taps is not None else None)
    if rx_fn is None:
        rx_fn = jit_safe(
            lambda s: rx_block(spec, s, max_frames=4, output=cc.output)
        )
    gp = G.GoldenOfdmParams(fft_len=cc.cfg.fft_len, cp_len=cc.cfg.cp_len,
                            modulation=cc.cfg.modulation)
    want_bits = np.unpackbits(np.frombuffer(payload, np.uint8))

    evms, gevms = [], []
    bit_err = bit_tot = 0
    frame_err = 0
    for seed in range(n_trials):
        rx = np.asarray(channel_model(
            jax.random.PRNGKey(seed), jnp.asarray(clean), snr_db=snr_db,
            cfo=cc.cfo, taps=taps, fft_len=cc.cfg.fft_len,
        ))
        res = to_host(rx_fn(jnp.asarray(rx)))
        v = np.asarray(res.valid)
        ok = False
        if v.sum() >= 1:
            i = int(np.argmax(v))
            f = jax.tree.map(lambda a: np.asarray(a)[i], res.frames)
            got = np.unpackbits(f.payload[: len(payload)])
            bit_err += int((got != want_bits).sum())
            bit_tot += len(want_bits)
            evms.append(float(f.evm))
            ok = bool(f.crc_ok) and int(f.payload_len) == len(payload)
        frame_err += not ok
        if golden:
            g = G.rx_frame(gp, rx.astype(np.complex128))
            if g is not None:
                gevms.append(float(g["evm"]))
    out = {
        "snr_db": snr_db,
        "evm": float(np.mean(evms)) if evms else None,
        "ber": bit_err / bit_tot if bit_tot else None,
        "fer": frame_err / n_trials,
        "n_trials": n_trials,
    }
    if golden:
        out["golden_evm"] = float(np.mean(gevms)) if gevms else None
    return out


def run_curves(snrs=None, n_trials: int = 8, golden: bool = True):
    payload = b"evm/ber curve measurement payload 0123456789"
    rows = {}
    for cc in baseline_configs():
        grid = snrs or ([6, 10, 15, 20, 30] if cc.cfg.modulation != "qam16"
                        else [10, 15, 20, 25, 35])
        rx_fn = jit_safe(
            lambda s, _spec=cc.cfg.spec, _o=cc.output: rx_block(
                _spec, s, max_frames=4, output=_o
            )
        )
        rows[cc.name] = [
            measure_point(cc, s, n_trials, payload, rx_fn=rx_fn,
                          golden=golden)
            for s in grid
        ]
    return rows


def to_markdown(rows: dict) -> str:
    lines = []
    for name, pts in rows.items():
        lines.append(f"\n**{name}** (n={pts[0]['n_trials']} trials/point)\n")
        lines.append("| SNR (dB) | EVM | golden EVM | BER | FER |")
        lines.append("|---|---|---|---|---|")
        for p in pts:
            fmt = lambda v, d="-": d if v is None else f"{v:.4g}"
            lines.append(
                f"| {p['snr_db']} | {fmt(p['evm'])} | "
                f"{fmt(p.get('golden_evm'))} | {fmt(p['ber'])} | "
                f"{p['fer']:.3f} |"
            )
    return "\n".join(lines) + "\n"


def main():
    import pathlib

    # EVM/BER curves are a correctness measurement: they run on whatever
    # backend is default (JAX_PLATFORMS=cpu for the committed artifact)
    rows = run_curves(n_trials=16)
    out = {"suite": "evm_ber_curves", "backend": jax.default_backend(),
           "rows": rows}
    path = pathlib.Path(__file__).parent / "results_curves.json"
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    print(to_markdown(rows))


if __name__ == "__main__":
    main()
