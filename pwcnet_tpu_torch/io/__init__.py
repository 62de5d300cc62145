"""Flow file formats (numpy only)."""

from pwcnet_tpu_torch.io.flow_io import (  # noqa: F401
    load_flow,
    read_flo,
    save_flow,
    write_flo,
)
