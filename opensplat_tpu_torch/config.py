"""Training configuration, mirroring the reference CLI flag for flag
(opensplat.cpp:19-51 defaults). A copy of opensplat_tpu/config.py, field
for field, so the port needs nothing of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # reference flags (names/defaults 1:1 with opensplat.cpp:20-51)
    input: str = ""
    output: str = "splat.ply"
    save_every: int = -1
    resume: str = ""
    val: bool = False
    val_image: str = "random"
    val_render: str = ""
    keep_crs: bool = False
    cpu: bool = False
    num_iters: int = 30000
    downscale_factor: float = 1.0
    num_downscales: int = 2
    resolution_schedule: int = 3000
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    ssim_weight: float = 0.2
    refine_every: int = 100
    warmup_length: int = 500
    reset_alpha_every: int = 30
    densify_grad_thresh: float = 0.0002
    densify_size_thresh: float = 0.01
    stop_screen_size_at: int = 4000
    split_screen_size: float = 0.05
    colmap_image_path: str = ""

    # derived (model.hpp:30)
    @property
    def stop_split_at(self) -> int:
        return self.num_iters // 2

    # learning rates (model.cpp:61-68)
    lr_means: float = 0.00016
    lr_means_final: float = 0.0000016
    lr_scales: float = 0.005
    lr_quats: float = 0.001
    lr_features_dc: float = 0.0025
    lr_features_rest: float = 0.000125
    lr_opacities: float = 0.05

    # densification internals (model.cpp:343,357,372,435-436)
    cull_alpha_thresh: float = 0.1
    n_split_samples: int = 2
    split_size_fac: float = 1.6
    cull_scale_thresh: float = 0.5
    cull_screen_size: float = 0.15

    # knobs of the JAX package, kept field for field
    capacity: Optional[int] = None  # fixed Gaussian capacity; None = auto
    capacity_mult: float = 1.5  # initial capacity = mult * n_points
    capacity_round: int = 4096  # capacities rounded to a multiple of this
    renderer: str = "auto"  # the CLI's --renderer (cli.pick_renderer)
    seed: int = 42
    checkpoint_every: int = -1  # native (orbax-style) checkpoints
    ckpt_dir: str = ""
    # device-resident GT image cache budget (MiB; 0 disables): each
    # (camera, factor) image is kept on the card after first use,
    # LRU-evicted under this budget
    gt_cache_mb: int = 1024
