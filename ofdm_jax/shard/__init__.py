"""Mesh construction, halo exchange, and sharded pipelines (SURVEY.md §2c).

Replaces the reference's scaling substrate -- one thread per block within a
host (tpb scheduler) and UDP sockets between hosts (local_worker/
remote_client) -- with jax.sharding meshes + XLA collectives.
"""

from ofdm_jax.shard.halo import (  # noqa: F401
    extend_with_left_halo,
    halo_from_left,
    halo_from_right,
)
from ofdm_jax.shard.mesh import (  # noqa: F401
    CHANNEL_AXIS,
    TIME_AXIS,
    balanced_factors,
    make_mesh,
    single_device_mesh,
)
from ofdm_jax.shard.rx import (  # noqa: F401
    collect_sharded_frames,
    collect_sharded_stream_frames,
    sharded_rx_capture_fn,
    sharded_rx_stream_block,
)
from ofdm_jax.shard.distributed import (  # noqa: F401
    LinkCounters,
    MeshHeartbeat,
    all_gather_spectrum,
    barrier,
    broadcast_control,
    counters_from_rx,
    global_mesh,
    initialize,
    metrics_from_counters,
    psum_tree,
    shard_capture,
)
from ofdm_jax.shard.wideband import (  # noqa: F401
    mesh_psd_step_fn,
    sharded_wideband_capture_fn,
    sharded_wideband_stream_block,
)
