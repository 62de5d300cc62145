"""Bridges from other frameworks' checkpoints into the port."""

from pwcnet_tpu_torch.compat.flax_weights import (  # noqa: F401
    load_flax_params, read_flax_npz)
from pwcnet_tpu_torch.compat.torch_import import (  # noqa: F401
    import_torch_checkpoint, import_torch_state_dict)
