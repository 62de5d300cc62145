"""The port's models: PWC-Net, RAFT, published RAFT (all-pairs), GMA and
GMFlow with refinement."""

from pwcnet_tpu_torch.models.pwcnet import (  # noqa: F401
    ContextNetwork,
    FeaturePyramidExtractor,
    OpticalFlowEstimator,
    PWCNet,
)
from pwcnet_tpu_torch.models.raft import RAFT  # noqa: F401
from pwcnet_tpu_torch.models.raft_allpairs import RAFTAllPairs  # noqa: F401
from pwcnet_tpu_torch.models.gma import GMA  # noqa: F401
from pwcnet_tpu_torch.models.gmflow import GMFlow  # noqa: F401
