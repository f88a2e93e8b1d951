"""opensplat_tpu_torch — the PyTorch + CUDA port of opensplat_tpu.

Same layout and module names as the JAX package, so every counterpart is
easy to find:

  train.py ............. Trainer, train_step (one optimisation step)
  models/ .............. GaussianParams/TrainState, render_forward, stats
  optim/adam.py ........ masked Adam
  ops/ ................. camera, projection, SH, binning, SSIM
  ops/kernels/ ......... the hand-written Hopper kernels (csrc/*.cu) with
                         their plain PyTorch versions and launch counters

Entry points default to device="cuda" and raise when CUDA is missing;
pass device="cpu" to run the plain PyTorch versions of the kernels. The
package imports torch, numpy and scipy only.
"""

__version__ = "0.1.0"
