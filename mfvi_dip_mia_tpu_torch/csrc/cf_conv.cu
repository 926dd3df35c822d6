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
//   * conv_dw: the tensor-core GEMM of conv_mma.cuh's dw tile (M = output
//     channels, N = input channels x taps, the reduction over pixels), on
//     the forward's channels-last slab: each tap's B operand is the slab
//     shifted by the tap. The pixel reduction is split across blocks
//     (blocks run in no order, unlike the TPU's sequential grid): a cluster
//     of up to 8 is summed by its leader through distributed shared memory,
//     and where more splits are needed the last leader to arrive sums the
//     clusters' partial tiles, each in a fixed order; one launch,
//     deterministic, no float atomics. ops/kernels/cf_conv.py::dw_plan picks
//     the tile and the split per launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_mma.cuh"

namespace {

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

// dw[o, i, ky, kx] = sum_{y, x} g[o, y, x] * xp[i, y + ky, x + kx]
// (conv_mma.cuh's dw tile): xp (I, Hp, Wp), g (O, Hp-K+1, Wp-K+1), dw
// (O, I, K, K) f32
template <typename T, int WM, int WN, int WK, int K, int KYB>
__global__ void __launch_bounds__(32 * WM * WN * WK)
conv_dw_mma_kernel(const T* __restrict__ xp, const T* __restrict__ g,
                   float* __restrict__ dw, float* __restrict__ partial,
                   int* __restrict__ ticket, int I, int Hp, int Wp, int O,
                   int cluster, int vec) {
  conv_mma::dw_tile_mma<T, conv_mma::DwTile<WM, WN, WK>, K, KYB>(
      xp, g, dw, partial, ticket, I, Hp, Wp, O, cluster, vec != 0);
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

template <typename T, int K, int KYB>
int launch_dw(const void* xp, const void* g, float* partial, int* ticket,
              float* out, int I, int Hp, int Wp, int O, int tile, int cluster,
              int groups, cudaStream_t st) {
  const int W = Wp - K + 1;
  const int vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                  (W * (int)sizeof(T)) % 16 == 0;
  return conv_mma::with_dw_tile<K == 5>(tile, [&](auto tl) {
    using TL = decltype(tl);
    const int tiles = ((O + TL::BO - 1) / TL::BO) *
                      ((I + TL::BC - 1) / TL::BC) * (K / KYB);
    return conv_mma::launch(
        conv_dw_mma_kernel<T, TL::WM, TL::WN, TL::WK, K, KYB>, TL::kThreads,
        conv_mma::dw_smem_bytes<T, TL>(K, KYB, cluster),
        dim3(cluster * groups, tiles, 1), cluster, st,
        static_cast<const T*>(xp), static_cast<const T*>(g), out, partial,
        ticket, I, Hp, Wp, O, cluster, vec);
  });
}

template <typename T>
int launch_dw_k(const void* xp, const void* g, float* partial, int* ticket,
                float* out, int I, int Hp, int Wp, int O, int K, int tile,
                int cluster, int groups, cudaStream_t st) {
  switch (K) {
    case 1: return launch_dw<T, 1, 1>(xp, g, partial, ticket, out, I, Hp, Wp,
                                      O, tile, cluster, groups, st);
    case 2: return launch_dw<T, 2, 2>(xp, g, partial, ticket, out, I, Hp, Wp,
                                      O, tile, cluster, groups, st);
    case 3: return launch_dw<T, 3, 3>(xp, g, partial, ticket, out, I, Hp, Wp,
                                      O, tile, cluster, groups, st);
    case 5: return launch_dw<T, 5, 1>(xp, g, partial, ticket, out, I, Hp, Wp,
                                      O, tile, cluster, groups, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// xp (I, Hp, Wp) and g (O, Hp-K+1, Wp-K+1) in dtype -> out (O, I, K, K)
// f32, K in {1, 2, 3, 5}. tile: conv_mma::with_dw_tile's index (0 for K = 5);
// the pixel tiles split over cluster * groups blocks per output tile
// (cluster 1-8). partial: groups * (output tiles) * BO * BC * K * K floats
// of scratch (unread when groups == 1); ticket: one int per output tile,
// zero, and left zero.
int cf_conv_dw(const void* xp, const void* g, float* partial, int* ticket,
               float* out, int dtype, int I, int Hp, int Wp, int O, int K,
               int tile, int cluster, int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster < 1 || cluster > conv_mma::kMaxSplit || groups < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dw_k<float>(xp, g, partial, ticket, out, I, Hp, Wp, O, K,
                              tile, cluster, groups, st);
  if (dtype == 1)
    return launch_dw_k<__nv_bfloat16>(xp, g, partial, ticket, out, I, Hp, Wp,
                                      O, K, tile, cluster, groups, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
