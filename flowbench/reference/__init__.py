"""The plain float32 PyTorch reference of each configuration.

Nothing here imports ``jax``, ``pwcnet_tpu`` or ``pwcnet_tpu_torch``: the
models, losses and synthetic renderer are
written out again in plain ``torch`` and ``numpy`` (frozen copies where
the arithmetic must match the program's bit for bit, such as random draws).
Every function takes a ``Precision``: float32 for the reference, an fp8
quantize-dequantize of every conv and correlation input for the control.
"""
