// The local-reparameterization (LRT) double convolution for Hopper (sm_90a):
// from one VALID stride-1 input stream, batch 1,
//   act_mu[o, y, x]  = sum_{i, ky, kx} w_mu[o, i, ky, kx]  * xp[i, y + ky, x + kx]
//   act_var[o, y, x] = sum_{i, ky, kx} w_var[o, i, ky, kx] * xp[i, y + ky, x + kx]^2
// f32 or bf16 storage (xp, both weights and both outputs share it), f32
// accumulation: x^2 is formed in f32 from the stored value, as the TPU kernel
// squares the f32-cast slab.
//
// Replaces the Pallas TPU kernel mfvi_dip_mia_tpu/ops/pallas/lrt_conv_pallas.py
// _double_conv_fwd (its pallas_call, via lrt_double_conv_pallas). The TPU
// kernel's point is kept: each input slab is read once, squared in registers
// and feeds both contractions, with none of the structural zeros of the
// block-diagonal conv that XLA runs otherwise (lrt_conv.py::_fused_double_conv).
//
// What bounds it on the card: the tensor cores' rate where the output tiles
// fill the card, and the number of blocks at the deep sites (8^2-32^2
// outputs). The kernel is conv_mma.cuh's implicit GEMM with two B operands:
// each channel chunk's halo'd input slab is staged once, channels-last in
// shared memory, beside a w_mu and a w_var tile, and each k-step runs the
// A fragment against w_mu and its square against w_var (x^2 formed in f32
// from the staged value; rounded to bf16 for the bf16 MMA). f32 runs as
// 3xTF32 (6 MMAs per k-step), bf16 as 2. The tile and the cluster split of
// K come from ops/kernels/cf_conv.py::tile_plan, as for cf_conv_fwd. Stride-2
// sites run on parity planes prepared in Python (ops/kernels/cf_conv.py::
// s2_planes), so the kernel needs no stride. The backward runs on the VALID
// conv's dx and dw kernels (csrc/cf_conv.cu).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_mma.cuh"

namespace {

// act_mu = conv(xp, w_mu), act_var = conv(xp^2, w_var): xp (I, Hp, Wp),
// w_mu / w_var (O, I, K, K), act_mu / act_var (O, H, W), H = Hp-K+1,
// W = Wp-K+1
template <typename T, int WM, int WN, int NF>
__global__ void __launch_bounds__(32 * WM * WN)
lrt_conv_fwd_mma_kernel(const T* __restrict__ xp, const T* __restrict__ w_mu,
                        const T* __restrict__ w_var, T* __restrict__ act_mu,
                        T* __restrict__ act_var, int I, int Hp, int Wp, int O,
                        int K, int H, int W) {
  conv_mma::conv_tile_mma<T, conv_mma::Tile<WM, WN, NF>, 2, false>(
      xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, K, H, W);
}

template <typename T>
int launch(const void* xp, const void* w_mu, const void* w_var, void* act_mu,
           void* act_var, int I, int Hp, int Wp, int O, int K, int tile,
           int split, cudaStream_t st) {
  const int H = Hp - K + 1, W = Wp - K + 1;
  return conv_mma::with_tile(tile, [&](auto tl) {
    using TL = decltype(tl);
    const dim3 grid(split,
                    ((H + TL::TH - 1) / TL::TH) *
                        ((W + conv_mma::kTW - 1) / conv_mma::kTW),
                    (O + TL::BN - 1) / TL::BN);
    return conv_mma::launch(
        lrt_conv_fwd_mma_kernel<T, TL::WM, TL::WN, TL::NF>, TL::kThreads,
        conv_mma::smem_bytes<T, TL>(K, 2, split), grid, split, st,
        static_cast<const T*>(xp), static_cast<const T*>(w_mu),
        static_cast<const T*>(w_var), static_cast<T*>(act_mu),
        static_cast<T*>(act_var), I, Hp, Wp, O, K, H, W);
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xp, w_mu, w_var, act_mu and act_var share
// it). xp (I, Hp, Wp); w_mu, w_var (O, I, K, K); act_mu, act_var (O, Hp-K+1,
// Wp-K+1). tile and split as cf_conv_fwd's.
int lrt_conv_fwd(const void* xp, const void* w_mu, const void* w_var, void* act_mu,
                 void* act_var, int dtype, int I, int Hp, int Wp, int O, int K,
                 int tile, int split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 3 || split < 1 || split > conv_mma::kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const int chunk = dtype == 0 ? 8 : 16;
  if (split > (I + chunk - 1) / chunk) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, K,
                         tile, split, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp,
                                 O, K, tile, split, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
