"""pwcnet_tpu_torch: the PyTorch and CUDA port of ``pwcnet_tpu``.

The PWC-Net inference forward and train step on an NVIDIA H100, with
hand-written CUDA kernels for the correlation, the fused pyramid stem
(forward and backward) and the fused warp + correlation
(``pwcnet_tpu_torch/csrc``); the trainer is
``pwcnet_tpu_torch.train.loop.train`` and the command line
``python -m pwcnet_tpu_torch.cli``. Public layouts are the JAX package's (NHWC
images, features and flows); entry points run on the GPU unless the caller
passes ``device="cpu"``. The package imports nothing of JAX or of
``pwcnet_tpu``.
"""

__version__ = "0.1.0"

from pwcnet_tpu_torch.models.pwcnet import PWCNet  # noqa: F401
from pwcnet_tpu_torch.train.evaluate import predict_flow  # noqa: F401
