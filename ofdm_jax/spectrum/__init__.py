"""Spectrum tools: PSD probe, max/avg hold, waterfall, polyphase channelizer.

JAX rebuild of gr-ofdm_tools' analyzer capabilities (SURVEY.md §2a)
on top of the streaming executor.
"""

from ofdm_jax.spectrum.channelizer import (  # noqa: F401
    channelize,
    channelizer_block,
    lowpass_taps,
    polyphase_decompose,
)
from ofdm_jax.spectrum.probe import SpectrumSummary, spectrum_probe_block  # noqa: F401
from ofdm_jax.spectrum.psd import (  # noqa: F401
    iir_average,
    log_pwr_fft,
    log_pwr_fft_block,
    psd_frames,
)
from ofdm_jax.spectrum.waterfall import (  # noqa: F401
    render_ascii,
    render_spectrum_line,
    waterfall_block,
)
