"""NumPy conformance oracle (host side): the CLI's --oracle-check and the
tests' reference."""
from .np_oracle import (
    np_pixel_gaussians,
    np_project_gaussians,
    np_rasterize_backward,
    np_rasterize_forward,
    np_sh_forward,
)
