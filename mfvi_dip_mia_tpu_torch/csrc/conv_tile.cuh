// Deterministic warp reductions and the block size of the fused block's
// CUDA-core passes (csrc/fused_block.cu: the forward's BN passes and
// fused_block_bwd_dc; csrc/radon_dense.cu's row sums). The conv tiles, on
// the tensor cores, are in conv_mma.cuh.

#pragma once

#include <cuda_runtime.h>

namespace conv_tile {

constexpr int kThreads = 256;

// The sum of v over the warp, the same in every lane: a fixed shuffle tree,
// then lane 0's result broadcast (the butterfly's lanes add in different
// orders, so only one lane's bits are taken).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// sum_{t < n} v[t * stride] by one warp in a fixed order, the same in every
// lane. v may have been written earlier in the same kernel (plain loads).
__device__ __forceinline__ float warp_sum_strided(const float* v, int n,
                                                  int stride) {
  float s = 0.f;
  for (int t = threadIdx.x & 31; t < n; t += 32) s += v[(size_t)t * stride];
  return warp_sum(s);
}

}  // namespace conv_tile
