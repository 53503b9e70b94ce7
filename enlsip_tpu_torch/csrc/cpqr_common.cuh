// Helpers shared by the two routes of B1, column-pivoted QR of one
// matrix on an NVIDIA Hopper card: csrc/cpqr.cu (the resident route) and
// csrc/cpqr_panels.cu (the panel route).  Both are persistent cooperative
// launches that sum every column in one warp, compare pivot candidates by
// (value, position) and meet at a grid-wide barrier of their own.

#pragma once

#include <cuda_runtime.h>

namespace cpqr_common {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Does candidate (v2, i2) beat (v1, i1)?  Larger value, then lower index.
template <typename T>
__device__ __forceinline__ bool beats(T v2, int i2, T v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier on a counter that only grows, split in two.  One
// thread of each block arrives after a __syncthreads() that follows the
// block's last global write (the fence is cumulative over what the
// barrier ordered before it); the same thread later waits for the n-th
// round's target n * gridDim.x, and a second __syncthreads() releases
// the block.  Needs every block co-resident: a cooperative launch.
__device__ __forceinline__ void grid_arrive(int* counter) {
  __threadfence();
  atomicAdd(counter, 1);
}

__device__ __forceinline__ void grid_wait(const int* counter, int target) {
  while (load_acquire(counter) < target) {
  }
}

// The step count of a launch: *nsteps_p clamped to [0, min(rows, cols)].
// It lives in device memory so that a count the solver computed on the
// card is never read back, and a captured graph replays with the count of
// the replay.
__device__ __forceinline__ int step_count(const int* nsteps_p, int rows,
                                          int cols) {
  const int kmax = rows < cols ? rows : cols;
  const int n = *nsteps_p;
  return n < 0 ? 0 : (n > kmax ? kmax : n);
}

// Launch checks shared by the routes: the opt-in shared memory, and every
// block co-resident (a cooperative launch of at most one block an SM).
template <typename Kernel>
cudaError_t cooperative_fit(Kernel kernel, int threads, size_t smem,
                            int blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace cpqr_common
