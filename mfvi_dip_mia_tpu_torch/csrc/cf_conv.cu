// Channels-first VALID convolution (batch 1, stride 1), its input gradient
// and its all-tap weight gradient for Hopper (sm_90a), f32 or bf16 storage
// with f32 accumulation.
//
// Replaces the two Pallas TPU kernels of mfvi_dip_mia_tpu/ops/pallas/cf_conv.py:
//   * conv_fwd  <- _conv_call (the forward of every conv site, and the dx of
//                  its custom VJP: a full correlation of the zero-padded
//                  cotangent with the flipped, I/O-transposed kernel);
//   * conv_dw   <- _dw_call (sum over row tiles of patches @ g^T).
//
// What bounds them on the card: at the U-Net's widths (1-132 channels, 1-3
// taps) the arithmetic intensity of a direct conv is far above the H100's
// bytes-per-FLOP balance, so the work is bound by the tensor cores' rate; at
// the deep sites (8^2-32^2 outputs) it is bound by how few blocks the output
// tiles make.
//   * conv_fwd: the tensor-core implicit GEMM of conv_mma.cuh (M = pixels, N =
//     output channels, K = I * k^2; bf16 mma.sync, f32 as 3xTF32), its input
//     slab staged channels-last in shared memory, two stages. Each launch
//     takes the tile and the split of K that ops/kernels/cf_conv.py::
//     tile_plan picks from the shapes: where the output tiles are too few to
//     fill 132 SMs, a thread block cluster of up to 8 blocks splits K and its
//     leader sums the partial tiles through distributed shared memory in rank
//     order (deterministic, one launch). The dx is the same kernel with
//     FULL = true: the unpadded cotangent with a virtual zero halo and the
//     forward weight flipped and transposed by indexing, so nothing is padded
//     or copied before it.
//   * conv_dw: the H*W reduction is split across blocks (blocks run in no
//     order, unlike the TPU's sequential grid), each block writes its partial
//     (O, I*kh*kw) tile to an f32 scratch, and a second kernel sums the splits
//     in a fixed order: deterministic, no atomics. FFMA, on conv_tile.cuh's
//     dw tile, shared with csrc/fused_block.cu.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_mma.cuh"
#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

// out[o, y, x] = sum_{i, ky, kx} wt[o, i, ky, kx] * x[i, y + ky - pad, x + kx - pad]
// (conv_mma.cuh's tile; FULL: pad = K - 1 and wt the flipped, transposed w)
template <typename T, int WM, int WN, int NF, bool FULL>
__global__ void __launch_bounds__(32 * WM * WN)
conv_fwd_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int I, int Hs, int Ws, int O, int K,
                    int Hout, int Wout) {
  conv_mma::conv_tile_mma<T, conv_mma::Tile<WM, WN, NF>, 1, FULL>(
      x, w, nullptr, out, nullptr, I, Hs, Ws, O, K, Hout, Wout);
}

// partial[s, o, k] = sum over split s's pixels of g[o, pix] * patch[k, pix],
// k = (i * K + ky) * K + kx, patch[k, (y, x)] = xp[i, y + ky, x + kx].
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_partial_kernel(const T* __restrict__ xp, const T* __restrict__ g,
                       float* __restrict__ partial, int I, int Hp, int Wp,
                       int O, int K, int H, int W, int pix_per_split) {
  const int Kt = I * K * K;
  const int s = blockIdx.x;
  const int k0 = blockIdx.y * kDwT;
  const int o0 = blockIdx.z * kDwT;
  const int p_begin = s * pix_per_split;
  const int p_end = min(H * W, p_begin + pix_per_split);
  float acc[2][2];
  dw_tile<T>(xp, g, I, Hp, Wp, O, K, p_begin, p_end, k0, o0, acc);

  const int to = threadIdx.x / 16, tk = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int oc = o0 + to * 2 + a;
    if (oc >= O) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int kc = k0 + tk * 2 + b;
      if (kc < Kt) partial[((size_t)s * O + oc) * Kt + kc] = acc[a][b];
    }
  }
}

// out[j] = sum_s partial[s, j] in split order (deterministic).
__global__ void __launch_bounds__(kThreads)
conv_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                      int n, int n_split) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += partial[(size_t)k * n + j];
  out[j] = s;
}

template <typename T, bool FULL>
int launch_fwd(const void* x, const void* w, void* out, int I, int Hs, int Ws,
               int O, int K, int tile, int split, cudaStream_t st) {
  const int Hout = FULL ? Hs + K - 1 : Hs - K + 1;
  const int Wout = FULL ? Ws + K - 1 : Ws - K + 1;
  return conv_mma::with_tile(tile, [&](auto tl) {
    using TL = decltype(tl);
    const dim3 grid(split,
                    ((Hout + TL::TH - 1) / TL::TH) *
                        ((Wout + conv_mma::kTW - 1) / conv_mma::kTW),
                    (O + TL::BN - 1) / TL::BN);
    return conv_mma::launch(
        conv_fwd_mma_kernel<T, TL::WM, TL::WN, TL::NF, FULL>, TL::kThreads,
        conv_mma::smem_bytes<T, TL>(K, 1, split), grid, split, st,
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), I, Hs, Ws, O, K, Hout, Wout);
  });
}

template <typename T>
int launch_fwd_full(const void* x, const void* w, void* out, int I, int Hs,
                    int Ws, int O, int K, int full, int tile, int split,
                    cudaStream_t st) {
  return full ? launch_fwd<T, true>(x, w, out, I, Hs, Ws, O, K, tile, split, st)
              : launch_fwd<T, false>(x, w, out, I, Hs, Ws, O, K, tile, split, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). full = 0: x
// (I, Hs, Ws), w (O, I, K, K), out (O, Hs-K+1, Ws-K+1); full = 1: x the
// cotangent (I, Hs, Ws), w the forward weight (I, O, K, K), out the input
// gradient (O, Hs+K-1, Ws+K-1). tile: conv_mma::with_tile's index; split:
// the blocks of a cluster that share one output tile (1-8, at most the
// input-channel chunks).
int cf_conv_fwd(const void* x, const void* w, void* out, int dtype, int I,
                int Hs, int Ws, int O, int K, int full, int tile, int split,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 5 || split < 1 || split > conv_mma::kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const int chunk = dtype == 0 ? 8 : 16;
  if (split > (I + chunk - 1) / chunk) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fwd_full<float>(x, w, out, I, Hs, Ws, O, K, full, tile,
                                  split, st);
  if (dtype == 1)
    return launch_fwd_full<__nv_bfloat16>(x, w, out, I, Hs, Ws, O, K, full,
                                          tile, split, st);
  return (int)cudaErrorInvalidValue;
}

// xp (I, Hp, Wp) and g (O, Hp-K+1, Wp-K+1) in dtype; partial (n_split, O,
// I*K*K) f32 scratch; out (O, I*K*K) f32.
int cf_conv_dw(const void* xp, const void* g, float* partial, float* out,
               int dtype, int I, int Hp, int Wp, int O, int K, int n_split,
               int pix_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = Hp - K + 1, W = Wp - K + 1;
  const int Kt = I * K * K;
  dim3 grid(n_split, (Kt + kDwT - 1) / kDwT, (O + kDwT - 1) / kDwT);
  if (dtype == 0) {
    conv_dw_partial_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(xp), static_cast<const float*>(g), partial,
        I, Hp, Wp, O, K, H, W, pix_per_split);
  } else if (dtype == 1) {
    conv_dw_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(g),
        partial, I, Hp, Wp, O, K, H, W, pix_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = O * Kt;
  conv_dw_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partial, out, n, n_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
