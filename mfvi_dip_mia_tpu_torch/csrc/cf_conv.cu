// Channels-first VALID convolution (batch 1, stride 1) and its all-tap weight
// gradient for Hopper (sm_90a), f32 or bf16 storage with f32 accumulation.
//
// Replaces the two Pallas TPU kernels of mfvi_dip_mia_tpu/ops/pallas/cf_conv.py:
//   * conv_fwd  <- _conv_call (the forward of every conv site, and the dx of
//                  its custom VJP: a full correlation of the zero-padded
//                  cotangent with the flipped, I/O-transposed kernel);
//   * conv_dw   <- _dw_call (sum over row tiles of patches @ g^T).
//
// What bounds them on the card: at the U-Net's widths (16-132 channels, 3x3
// taps) the arithmetic intensity of a direct conv is far above the H100's
// bytes-per-FLOP balance, so both are bound by arithmetic. This first version
// runs on the CUDA cores (FFMA, f32 accumulate) rather than the tensor cores:
//   * conv_fwd: each block owns an (output-channel tile) x (row tile of
//     32 columns) output tile, stages a halo'd input slab and the weight tile
//     of 8 input channels at a time in shared memory, and each thread keeps an
//     8-channel x 4-pixel register tile (32 FMAs per 12 shared loads).
//   * conv_dw: the H*W reduction is split across blocks (blocks run in no
//     order, unlike the TPU's sequential grid), each block writes its partial
//     (O, I*kh*kw) tile to an f32 scratch, and a second kernel sums the splits
//     in a fixed order: deterministic, no atomics.
// Both tiles live in conv_tile.cuh, shared with csrc/fused_block.cu.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

// out[o, y, x] = sum_{i, ky, kx} w[o, i, ky, kx] * x[i, y + ky, x + kx]
// x (I, Hp, Wp), w (O, I, K, K), out (O, H, W) with H = Hp-K+1, W = Wp-K+1;
// one (OG * 8 channels) x (32 / OG rows) x (32 columns) tile per block.
template <typename T, int K, int OG>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int I, int Hp, int Wp, int O, int H, int W) {
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * Geom<OG>::TH;
  const int o0 = blockIdx.z * Geom<OG>::OT;
  float acc[kOPT][kPX];
  accumulate<T, K, OG, false>(x, w, I, Hp, Wp, O, x0, y0, o0, acc);

  const Lane<OG> ln;
  const int y = y0 + ln.ty;
  if (y >= H) return;
#pragma unroll
  for (int o = 0; o < kOPT; ++o) {
    const int oc = o0 + ln.og * kOPT + o;
    if (oc >= O) break;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int xx = x0 + ln.tx * kPX + p;
      if (xx < W) out[((size_t)oc * H + y) * W + xx] = from_f<T>(acc[o][p]);
    }
  }
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

template <typename T, int K>
void launch_fwd_k(const void* x, const void* w, void* out, int I, int Hp, int Wp,
                  int O, cudaStream_t st) {
  const int H = Hp - K + 1, W = Wp - K + 1;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const int gx = (W + kTW - 1) / kTW;
  if (O <= kOPT) {
    constexpr int TH = kThreads / 1 / kRowThreads;
    dim3 grid(gx, (H + TH - 1) / TH, (O + kOPT - 1) / kOPT);
    conv_fwd_kernel<T, K, 1><<<grid, kThreads, 0, st>>>(xt, wt, ot, I, Hp, Wp, O, H, W);
  } else if (O <= 2 * kOPT) {
    constexpr int TH = kThreads / 2 / kRowThreads;
    dim3 grid(gx, (H + TH - 1) / TH, (O + 2 * kOPT - 1) / (2 * kOPT));
    conv_fwd_kernel<T, K, 2><<<grid, kThreads, 0, st>>>(xt, wt, ot, I, Hp, Wp, O, H, W);
  } else {
    constexpr int TH = kThreads / 4 / kRowThreads;
    dim3 grid(gx, (H + TH - 1) / TH, (O + 4 * kOPT - 1) / (4 * kOPT));
    conv_fwd_kernel<T, K, 4><<<grid, kThreads, 0, st>>>(xt, wt, ot, I, Hp, Wp, O, H, W);
  }
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* out, int I, int Hp, int Wp,
               int O, int K, cudaStream_t st) {
  switch (K) {
    case 1: launch_fwd_k<T, 1>(x, w, out, I, Hp, Wp, O, st); break;
    case 2: launch_fwd_k<T, 2>(x, w, out, I, Hp, Wp, O, st); break;
    case 3: launch_fwd_k<T, 3>(x, w, out, I, Hp, Wp, O, st); break;
    case 5: launch_fwd_k<T, 5>(x, w, out, I, Hp, Wp, O, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).
int cf_conv_fwd(const void* x, const void* w, void* out, int dtype, int I,
                int Hp, int Wp, int O, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, w, out, I, Hp, Wp, O, K, st);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, w, out, I, Hp, Wp, O, K, st);
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
