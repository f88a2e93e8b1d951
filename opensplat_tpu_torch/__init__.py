"""opensplat_tpu_torch — the PyTorch + CUDA port of opensplat_tpu.

Same layout and module names as the JAX package, so every counterpart is
easy to find:

  train.py ............. Trainer, train_step (one optimisation step)
  models/ .............. GaussianParams/TrainState, render_forward,
                         render_depth, stats
  optim/adam.py ........ masked Adam
  ops/ ................. camera, projection, SH, binning, SSIM, and the
                         conformance renderers (rasterize.py dense,
                         rasterize_tiled.py tiled)
  ops/kernels/ ......... the hand-written Hopper kernels (csrc/*.cu) with
                         their plain PyTorch versions and launch counters
  gsplat_compat.py ..... the reference's 11 gsplat entry points
  parallel/ ............ one process per rank (torch.distributed): camera
                         DP (dp_trainer.py), Gaussian-shard MP and the
                         hybrid (gaussian_shard.py), multi-scene
                         (multi_scene.py), the rank grid and its
                         collectives (mesh.py), the bootstrap
                         (distributed.py) and a launcher (launch.py)
  cli.py, multi_scene_cli.py, simple_trainer.py, tools/, data/, io/,
  oracle/, utils/

Entry points default to device="cuda" and raise when CUDA is missing;
pass device="cpu" to run the plain PyTorch versions of the kernels. The
package imports torch, numpy and scipy only.
"""

__version__ = "0.1.0"
