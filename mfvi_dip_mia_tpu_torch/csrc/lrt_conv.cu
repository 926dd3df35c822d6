// The local-reparameterization (LRT) double convolution for Hopper (sm_90a):
// from one VALID stride-1 input stream, batch 1,
//   act_mu[o, y, x]  = sum_{i, ky, kx} w_mu[o, i, ky, kx]  * xp[i, y + ky, x + kx]
//   act_var[o, y, x] = sum_{i, ky, kx} w_var[o, i, ky, kx] * xp[i, y + ky, x + kx]^2
// f32 or bf16 storage (xp, both weights and both outputs share it), f32
// arithmetic: x^2 is formed in f32 from the stored value, as the TPU kernel
// squares the f32-cast slab.
//
// Replaces the Pallas TPU kernel mfvi_dip_mia_tpu/ops/pallas/lrt_conv_pallas.py
// _double_conv_fwd (its pallas_call, via lrt_double_conv_pallas). The TPU
// kernel's point is kept: each input slab is read once, squared in registers
// and feeds both contractions, with none of the structural zeros of the
// block-diagonal conv that XLA runs otherwise (lrt_conv.py::_fused_double_conv).
//
// What bounds it on the card: arithmetic. Two contractions of the U-Net's
// conv sites (16-132 channels, 3x3 taps) are far above the H100's
// bytes-per-FLOP balance. This first version runs on the CUDA cores (FFMA, f32
// accumulate) with the conv tile of conv_tile.cuh: each block owns an
// (output-channel tile) x (row tile of 32 columns) output tile, stages the
// halo'd input slab of 8 input channels once with conv_tile's loader beside
// a w_mu and a w_var tile, and each thread keeps two 8-channel x 4-pixel
// register tiles (64 accumulators; x^2 is formed at the point of use, so the
// slab is not staged twice). Stride-2 sites run on parity planes prepared in
// Python (ops/kernels/cf_conv.py::s2_planes), so the kernel needs no stride.
// The backward runs on the VALID conv's dx and dw kernels (csrc/cf_conv.cu).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

// xp (I, Hp, Wp), w_mu / w_var (O, I, K, K), act_mu / act_var (O, H, W) with
// H = Hp-K+1, W = Wp-K+1; one (OG * 8 channels) x (32 / OG rows) x (32
// columns) tile per block.
template <typename T, int K, int OG>
__global__ void __launch_bounds__(kThreads)
lrt_conv_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ w_mu,
                    const T* __restrict__ w_var, T* __restrict__ act_mu,
                    T* __restrict__ act_var, int I, int Hp, int Wp, int O, int H,
                    int W) {
  constexpr int TH = Geom<OG>::TH;
  constexpr int OT = Geom<OG>::OT;
  constexpr int KK = K * K;
  __shared__ __align__(16) float slab[kIC][TH + K - 1][kTW + K - 1];
  __shared__ __align__(16) float wmu[kIC][KK][OT];
  __shared__ __align__(16) float wvar[kIC][KK][OT];

  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * TH;
  const int o0 = blockIdx.z * OT;
  const Lane<OG> ln;
  float am[kOPT][kPX], av[kOPT][kPX];
#pragma unroll
  for (int o = 0; o < kOPT; ++o)
#pragma unroll
    for (int p = 0; p < kPX; ++p) am[o][p] = av[o][p] = 0.f;

  for (int i0 = 0; i0 < I; i0 += kIC) {
    __syncthreads();
    load_slab<T, K, OG, false>(xp, I, Hp, Wp, i0, x0, y0, slab);
    load_weights<T, K, OG, false>(w_mu, I, O, i0, o0, wmu);
    load_weights<T, K, OG, false>(w_var, I, O, i0, o0, wvar);
    __syncthreads();
    for (int ic = 0; ic < kIC; ++ic) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float xv[kPX], x2[kPX];
#pragma unroll
          for (int p = 0; p < kPX; ++p) {
            xv[p] = slab[ic][ln.ty + ky][ln.tx * kPX + kx + p];
            x2[p] = xv[p] * xv[p];
          }
          const float* wm = &wmu[ic][ky * K + kx][ln.og * kOPT];
          const float* wv = &wvar[ic][ky * K + kx][ln.og * kOPT];
#pragma unroll
          for (int o = 0; o < kOPT; ++o) {
            const float m = wm[o], v = wv[o];
#pragma unroll
            for (int p = 0; p < kPX; ++p) {
              am[o][p] = fmaf(m, xv[p], am[o][p]);
              av[o][p] = fmaf(v, x2[p], av[o][p]);
            }
          }
        }
      }
    }
  }

  const int y = y0 + ln.ty;
  if (y >= H) return;
#pragma unroll
  for (int o = 0; o < kOPT; ++o) {
    const int oc = o0 + ln.og * kOPT + o;
    if (oc >= O) break;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int xx = x0 + ln.tx * kPX + p;
      if (xx < W) {
        const size_t at = ((size_t)oc * H + y) * W + xx;
        act_mu[at] = from_f<T>(am[o][p]);
        act_var[at] = from_f<T>(av[o][p]);
      }
    }
  }
}

template <typename T, int K, int OG>
void launch_og(const void* xp, const void* w_mu, const void* w_var, void* act_mu,
               void* act_var, int I, int Hp, int Wp, int O, cudaStream_t st) {
  const int H = Hp - K + 1, W = Wp - K + 1;
  constexpr int TH = Geom<OG>::TH;
  constexpr int OT = Geom<OG>::OT;
  dim3 grid((W + kTW - 1) / kTW, (H + TH - 1) / TH, (O + OT - 1) / OT);
  lrt_conv_fwd_kernel<T, K, OG><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w_mu),
      static_cast<const T*>(w_var), static_cast<T*>(act_mu), static_cast<T*>(act_var),
      I, Hp, Wp, O, H, W);
}

template <typename T, int K>
void launch_k(const void* xp, const void* w_mu, const void* w_var, void* act_mu,
              void* act_var, int I, int Hp, int Wp, int O, cudaStream_t st) {
  if (O <= kOPT)
    launch_og<T, K, 1>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, st);
  else if (O <= 2 * kOPT)
    launch_og<T, K, 2>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, st);
  else
    launch_og<T, K, 4>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, st);
}

template <typename T>
int launch(const void* xp, const void* w_mu, const void* w_var, void* act_mu,
           void* act_var, int I, int Hp, int Wp, int O, int K, cudaStream_t st) {
  switch (K) {
    case 1: launch_k<T, 1>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, st); break;
    case 2: launch_k<T, 2>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, st); break;
    case 3: launch_k<T, 3>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xp, w_mu, w_var, act_mu and act_var share
// it). xp (I, Hp, Wp); w_mu, w_var (O, I, K, K); act_mu, act_var (O, Hp-K+1,
// Wp-K+1).
int lrt_conv_fwd(const void* xp, const void* w_mu, const void* w_var, void* act_mu,
                 void* act_var, int dtype, int I, int Hp, int Wp, int O, int K,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, K, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, w_mu, w_var, act_mu, act_var, I, Hp, Wp, O, K, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
