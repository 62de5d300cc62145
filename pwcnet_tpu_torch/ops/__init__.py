"""Tensor ops of the port: resize, warp, correlation, SAME-padded conv."""

from pwcnet_tpu_torch.ops.conv import conv_same, leaky_relu  # noqa: F401
from pwcnet_tpu_torch.ops.cost_volume import (  # noqa: F401
    cost_volume,
    cost_volume_ref,
)
from pwcnet_tpu_torch.ops.resize import (  # noqa: F401
    downsample_bilinear,
    resize_bilinear,
)
from pwcnet_tpu_torch.ops.warp import warp_bilinear  # noqa: F401
