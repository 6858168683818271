"""Host-side IO: sources/sinks, device feed, PDU queues, UDP transports.

The host boundary of the framework (SURVEY.md §2a/§2b IO blocks and the
distributed-analyzer socket path)."""

from ofdm_jax.io.feed import DeviceFeed  # noqa: F401
from ofdm_jax.io import pmt  # noqa: F401
from ofdm_jax.io.pdu import Pdu, PduQueue, UdpPduLink, UdpSampleLink  # noqa: F401
from ofdm_jax.io.sources import (  # noqa: F401
    file_sink,
    file_size_samples,
    file_source,
    head,
    noise_source,
    sig_source,
    vector_source,
)
from ofdm_jax.io.transport import (  # noqa: F401
    SpectrumFrame,
    SpectrumPublisher,
    SpectrumSubscriber,
    pack_spectrum,
    unpack_spectrum,
)
