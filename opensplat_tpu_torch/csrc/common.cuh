// Shared constants and helpers of the port's Hopper kernels.
//
// Every kernel is exported through a plain C entry (OSK_API) that takes
// raw device pointers and a cudaStream_t, launches on that stream, does
// not synchronise and returns cudaGetLastError(). The Python wrappers
// (opensplat_tpu_torch/ops/kernels/*.py) allocate every buffer.
//
// The library is compiled with --fmad=false: each float operation rounds
// on its own, as in the plain PyTorch versions, so the expansion's cull
// decisions are bit-identical to them and the forward and backward
// rasterizers make identical alpha-threshold decisions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define OSK_API extern "C" __attribute__((visibility("default")))

namespace osk {

constexpr int BLOCK_X = 16;
constexpr int BLOCK_Y = 16;
constexpr int PIX = BLOCK_X * BLOCK_Y;  // pixels (threads) per tile

// float32(1/255): the same constant the JAX package compares against
constexpr float ALPHA_THRESH = 0.003921568859368563f;
constexpr float T_EPS = 1e-4f;
constexpr float FWD_ALPHA_CLAMP = 0.999f;
constexpr float BWD_ALPHA_CLAMP = 0.99f;
// final_idx of a pixel that never reached the T <= T_EPS stop
constexpr int STOP_SENTINEL = 1 << 30;

// Gaussian exponent at pixel offset (dx, dy) = (x - px, y - py).
__device__ __forceinline__ float sigma_at(float A, float B, float C,
                                          float dx, float dy) {
  return 0.5f * (A * dx * dx + C * dy * dy) + B * dx * dy;
}

}  // namespace osk
