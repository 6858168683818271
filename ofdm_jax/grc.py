"""Declarative flowgraph specs: the GRC-compiler analog.

The reference stack authors flowgraphs as .grc descriptor files compiled to
Python by grcc (SURVEY.md §2b "GRC compiler", grc/core/, and §2a "GRC
descriptors", grc/ofdm_tools_*.xml, unverified paths).  Here the same role
is played by a JSON spec + a block REGISTRY:

  * each registry entry is a block descriptor (the XML-file analog): a type
    name, a factory, and its parameter names/defaults introspected from the
    factory signature;
  * `build(spec)` is the grcc analog: it turns a spec dict into a
    stream.graph.Flowgraph and returns the flattened executable Block;
  * `load(path)` reads the spec from a JSON file (the .grc analog).

Spec format:

    {
      "name": "psd_probe",
      "blocks": [
        {"id": "lp",  "type": "fir_filter",
         "params": {"taps": {"design": "low_pass", "gain": 1.0, "fs": 1.0,
                             "cutoff": 0.2, "transition_width": 0.05}}},
        {"id": "psd", "type": "log_pwr_fft", "params": {"fft_len": 256}}
      ],
      "connections": [["lp", "psd"]],
      "inputs":  ["lp"],
      "outputs": ["psd"]
    }

Filter-tap parameters accept either an explicit list of taps or a
{"design": <firdes function>, ...kwargs} dict resolved through ops.firdes
(the GRC firdes-expression idiom).
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Callable

import numpy as np

from ofdm_jax.ops import firdes
from ofdm_jax.spectrum.channelizer import channelizer_block, lowpass_taps
from ofdm_jax.spectrum.probe import spectrum_probe_block
from ofdm_jax.spectrum.psd import log_pwr_fft_block
from ofdm_jax.spectrum.waterfall import waterfall_block
from ofdm_jax.stream import block as B
from ofdm_jax.stream.block import Block
from ofdm_jax.stream.graph import Flowgraph, FlowgraphError

REGISTRY: dict[str, "BlockDesc"] = {}


class BlockDesc:
    """A registered block type (cf. one grc/*.xml descriptor)."""

    def __init__(self, name: str, factory: Callable[..., Block]):
        self.name = name
        self.factory = factory
        self.open_ended = False  # factory takes **kwargs (e.g. OFDM params)
        try:
            sig = inspect.signature(factory)
            self.params = {
                p.name: (None if p.default is inspect.Parameter.empty
                         else p.default)
                for p in sig.parameters.values()
                if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            }
            self.open_ended = any(
                p.kind == p.VAR_KEYWORD for p in sig.parameters.values()
            )
        except (TypeError, ValueError):
            self.params = {}

    def make(self, params: dict[str, Any]) -> Block:
        unknown = (set(params) - set(self.params)
                   if self.params and not self.open_ended else set())
        if unknown:
            raise FlowgraphError(
                f"block type {self.name!r}: unknown params {sorted(unknown)}; "
                f"accepts {sorted(self.params)}"
            )
        try:
            return self.factory(**params)
        except TypeError as e:
            # Open-ended factories (**kwargs forwarded to e.g. OfdmConfig)
            # can't be validated up front; surface a typo'd param with the
            # same FlowgraphError UX as the static check above.
            raise FlowgraphError(
                f"block type {self.name!r}: bad params ({e}); fixed params "
                f"{sorted(self.params)}"
                + (", plus open-ended OFDM/config kwargs forwarded to the "
                   "factory" if self.open_ended else "")
            ) from e


def register(name: str, factory: Callable[..., Block] | None = None):
    """Register a block type; usable as a decorator for user extensions.

    REGISTRY is process-global (mirroring GRC's global block tree), so a
    user registration is visible to every subsequent build().  Callers that
    register temporary/experimental types (tests, notebooks) should pair
    register() with unregister() to avoid leaking entries into unrelated
    flowgraphs.
    """
    def _do(f):
        REGISTRY[name] = BlockDesc(name, f)
        return f
    return _do(factory) if factory is not None else _do


def unregister(name: str) -> None:
    """Remove a user-registered block type (no-op if absent)."""
    REGISTRY.pop(name, None)


def _resolve_taps(v):
    """Taps param: list -> array; {'design': 'low_pass', ...} -> firdes."""
    if isinstance(v, dict):
        kind = v.get("design")
        fn = getattr(firdes, kind, None)
        if fn is None and kind == "pfb_lowpass":
            fn = lowpass_taps
        if fn is None:
            raise FlowgraphError(f"unknown tap design {kind!r}")
        kw = {k: w for k, w in v.items() if k != "design"}
        return fn(**kw)
    return np.asarray(v)


def _taps_factory(base: Callable[..., Block]) -> Callable[..., Block]:
    def make(taps, **kw):
        return base(_resolve_taps(taps), **kw)
    make.__signature__ = inspect.signature(base)
    return make


# --- built-in registry (the grc/*.xml set) ---------------------------------
register("multiply_const", B.multiply_const)
register("add_const", B.add_const)
register("complex_to_mag_squared", B.complex_to_mag_squared)
register("nlog10", B.nlog10)
register("stream_to_vector", B.stream_to_vector)
register("vector_to_stream", B.vector_to_stream)
register("delay", lambda n: B.delay(n))
register("moving_average", lambda n, scale=None: B.moving_average(n, scale=scale))
register("single_pole_iir", lambda alpha: B.single_pole_iir(alpha))
register("fir_filter", _taps_factory(B.fir_filter))
register("freq_xlating_fir", _taps_factory(B.freq_xlating_fir))
register("interpolating_fir", _taps_factory(B.interpolating_fir))
register("rational_resampler", _taps_factory(B.rational_resampler))
register("head", B.head)
register("probe_rate", B.probe_rate)
register("pfb_channelizer",
         lambda n_chan, taps=None: channelizer_block(
             n_chan, None if taps is None else _resolve_taps(taps)))
register("log_pwr_fft", log_pwr_fft_block)
register("spectrum_probe", spectrum_probe_block)
register("waterfall", waterfall_block)


def _stream_cfg(block_size, max_frames_per_block):
    from ofdm_jax.config import StreamConfig

    return StreamConfig(block_size=block_size,
                        max_frames_per_block=max_frames_per_block)


def _ofdm_rx_stream(block_size: int = 1 << 15, max_frames_per_block: int = 8,
                    **ofdm_params) -> Block:
    from ofdm_jax.config import OfdmConfig
    from ofdm_jax.modem.rx_stream import rx_stream_block

    cfg = OfdmConfig(**ofdm_params)
    return rx_stream_block(
        cfg.spec, _stream_cfg(block_size, max_frames_per_block))


def _ofdm_tx_stream(block_size: int = 1 << 15, max_frames_per_block: int = 8,
                    gap: int | None = None, **ofdm_params) -> Block:
    from ofdm_jax.config import OfdmConfig
    from ofdm_jax.modem.tx_stream import tx_stream_block

    cfg = OfdmConfig(**ofdm_params)
    return tx_stream_block(
        cfg.spec, _stream_cfg(block_size, max_frames_per_block), gap=gap)


def _wideband_rx(n_chan: int, block_size: int = 1 << 18,
                 max_frames_per_block: int = 8, taps=None,
                 equalizer: str = "pilot_phase", **ofdm_params) -> Block:
    from ofdm_jax.config import OfdmConfig
    from ofdm_jax.modem.wideband import wideband_rx_block

    cfg = OfdmConfig(**ofdm_params)
    return wideband_rx_block(
        cfg.spec, n_chan, _stream_cfg(block_size, max_frames_per_block),
        taps=None if taps is None else _resolve_taps(taps),
        equalizer=equalizer)


def _channel_model(**kw) -> Block:
    from ofdm_jax.ops.channel import channel_block

    if kw.get("taps") is not None:
        kw["taps"] = _resolve_taps(kw["taps"])
    return channel_block(**kw)


def _ofdm_radio(block_size: int = 1 << 15, max_frames_per_block: int = 8,
                equalizer: str = "pilot_phase", output: str = "hard",
                tx_gap: int | None = None, **ofdm_params) -> Block:
    """Full-duplex modem hier block (the reference's ofdm_radio_hier,
    SURVEY.md §2a row 1): one step runs TX and RX together.  Input per step
    is (TxStreamIn, rx_samples); drive it from an executor, not a sample
    connection (stream_input=False)."""
    from ofdm_jax.config import OfdmConfig
    from ofdm_jax.modem.radio import ofdm_radio

    cfg = OfdmConfig(**ofdm_params)
    return ofdm_radio(cfg.spec,
                      _stream_cfg(block_size, max_frames_per_block),
                      equalizer=equalizer, output=output, tx_gap=tx_gap)


register("ofdm_rx_stream", _ofdm_rx_stream)
register("ofdm_tx_stream", _ofdm_tx_stream)
register("wideband_rx", _wideband_rx)
register("channel_model", _channel_model)
register("ofdm_radio", _ofdm_radio)


# --- the grcc analog --------------------------------------------------------
def build(spec: dict) -> Block:
    """Compile a spec dict into an executable Block (cf. grcc: .grc ->
    generated top_block Python)."""
    fg = Flowgraph(spec.get("name", "flowgraph"))
    for b in spec.get("blocks", []):
        btype = b["type"]
        if btype not in REGISTRY:
            raise FlowgraphError(
                f"unknown block type {btype!r}; registered: {sorted(REGISTRY)}"
            )
        fg.add(b["id"], REGISTRY[btype].make(b.get("params", {})))
    for c in spec.get("connections", []):
        src, dst = c
        fg.connect(tuple(src) if isinstance(src, list) else src,
                   tuple(dst) if isinstance(dst, list) else dst)
    for i in spec.get("inputs", []):
        fg.add_input(tuple(i) if isinstance(i, list) else i)
    outs = spec.get("outputs", [])
    fg.set_outputs(*[tuple(o) if isinstance(o, list) else o for o in outs])
    return fg.build()


def load(path: str) -> Block:
    """Read a JSON flowgraph spec file (the .grc analog) and compile it."""
    with open(path) as f:
        return build(json.load(f))
