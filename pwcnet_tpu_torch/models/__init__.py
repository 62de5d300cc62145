"""The port's models: PWC-Net and RAFT."""

from pwcnet_tpu_torch.models.pwcnet import (  # noqa: F401
    ContextNetwork,
    FeaturePyramidExtractor,
    OpticalFlowEstimator,
    PWCNet,
)
from pwcnet_tpu_torch.models.raft import RAFT  # noqa: F401
