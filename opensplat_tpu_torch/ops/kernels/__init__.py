"""The port's hand-written Hopper kernels (sources in csrc/), each beside
its plain PyTorch version and launch counter:

  expand.expand ........................ candidate expansion + cull
  raster.rasterize_forward ............. tile compositing, forward
  raster.rasterize_backward ............ tile replay, per-record gradients
  segsum.segment_sum ................... per-Gaussian gradient sums
  ssim.ssim_forward, ssim.ssim_backward  SSIM and its gradient in the
                                         rendered image (11-tap stencil)
  raster_variants.rasterize_variant .... the forward with pieces ablated
                                         (the ablation bench's kernel)
"""
