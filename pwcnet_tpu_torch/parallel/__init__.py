"""The port's (data, spatial, model) grid of processes over
``torch.distributed``: data parallelism and spatial (image-H) sharding."""

from pwcnet_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    SPATIAL_AXIS,
    GridMesh,
    MeshConfig,
    initialize_distributed,
    local_batch_size,
    make_mesh,
    shard_batch,
)
from pwcnet_tpu_torch.parallel.halo import (  # noqa: F401
    exchange_halo,
    exchange_rows,
    warp_corr_spatial,
    warp_corr_spatial_local,
)
from pwcnet_tpu_torch.parallel.spatial import (  # noqa: F401
    pad_for_spatial,
    predict_flow_spatial,
    required_divisor,
    spatial_forward,
)
