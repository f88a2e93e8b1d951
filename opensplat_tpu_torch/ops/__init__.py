from .projection import ProjectedGaussians, project_gaussians
from .sh import num_sh_bases, rgb_to_sh, spherical_harmonics
from .tensor_math import quat_to_rotmat, random_quat
