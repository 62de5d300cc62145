"""PWC-Net modules of the port."""

from pwcnet_tpu_torch.models.pwcnet import (  # noqa: F401
    ContextNetwork,
    FeaturePyramidExtractor,
    OpticalFlowEstimator,
    PWCNet,
)
