"""Bridges from other frameworks' checkpoints into the port."""

from pwcnet_tpu_torch.compat.flax_weights import load_flax_params  # noqa: F401
