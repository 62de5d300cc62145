"""Flow and image file formats and flow visualization (numpy only)."""

from pwcnet_tpu_torch.io.flow_io import (  # noqa: F401
    load_flow,
    read_flo,
    read_kitti_png,
    read_pfm,
    save_flow,
    write_flo,
    write_kitti_png,
    write_pfm,
)
from pwcnet_tpu_torch.io.png import (read_png, read_ppm, write_png,  # noqa: F401
                                     write_ppm)
from pwcnet_tpu_torch.io.vis import flow_to_rgb, make_color_wheel  # noqa: F401
