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

// cp.async copies from global to shared memory (sm_80+): issued without
// waiting, grouped by cp_commit, completed by cp_wait_all (or
// cp_wait_group) in the issuing thread, and visible to the other threads
// after a barrier that follows the wait.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src) : "memory");
}

// 16 bytes, bypassing L1; `src_bytes` (0..16) of them are read from
// `src` and the rest of the 16 are zero-filled. Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What the CUDA runtime reports of a kernel's build at `threads` threads
// and `dyn_smem` bytes of dynamic shared memory: o[0] registers per
// thread, o[1] shared memory per CTA (static + dynamic, bytes), o[2]
// resident CTAs per SM. Returns the CUDA error code.
template <typename Kernel>
inline int kernel_info(Kernel kernel, int threads, int dyn_smem, int* o) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                    dyn_smem);
  o[0] = attr.numRegs;
  o[1] = dyn_smem + static_cast<int>(attr.sharedSizeBytes);
  o[2] = ctas;
  return static_cast<int>(e);
}

}  // namespace osk
