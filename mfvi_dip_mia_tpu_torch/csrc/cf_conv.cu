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

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

constexpr int kThreads = 256;
constexpr int kIC = 8;   // input channels staged per pass
constexpr int kTW = 32;  // output columns per block
constexpr int kPX = 4;   // output columns per thread
constexpr int kOPT = 8;  // output channels per thread
constexpr int kRowThreads = kTW / kPX;

// out[o, y, x] = sum_{i, ky, kx} w[o, i, ky, kx] * x[i, y + ky, x + kx]
// x (I, Hp, Wp), w (O, I, K, K), out (O, H, W) with H = Hp-K+1, W = Wp-K+1.
// OG groups of kOPT output channels split the 256 threads; within a group,
// 8 threads cover a row's 32 columns, so the block covers 32 / OG rows.
template <typename T, int K, int OG>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int I, int Hp, int Wp, int O, int H, int W) {
  constexpr int PT = kThreads / OG;  // threads per output-channel group
  constexpr int TH = PT / kRowThreads;
  constexpr int SH = TH + K - 1;
  constexpr int SW = kTW + K - 1;
  constexpr int OT = OG * kOPT;
  constexpr int KK = K * K;
  __shared__ __align__(16) float slab[kIC][SH][SW];
  __shared__ __align__(16) float wsm[kIC][KK][OT];

  const int tid = threadIdx.x;
  const int og = tid / PT;
  const int pt = tid % PT;
  const int ty = pt / kRowThreads;
  const int tx = pt % kRowThreads;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * TH;
  const int o0 = blockIdx.z * OT;

  float acc[kOPT][kPX];
#pragma unroll
  for (int o = 0; o < kOPT; ++o)
#pragma unroll
    for (int p = 0; p < kPX; ++p) acc[o][p] = 0.f;

  for (int i0 = 0; i0 < I; i0 += kIC) {
    __syncthreads();
    for (int idx = tid; idx < kIC * SH * SW; idx += kThreads) {
      const int ic = idx / (SH * SW);
      const int rem = idx - ic * (SH * SW);
      const int sy = rem / SW;
      const int sx = rem - sy * SW;
      const int gi = i0 + ic, gy = y0 + sy, gx = x0 + sx;
      float v = 0.f;
      if (gi < I && gy < Hp && gx < Wp)
        v = to_f<T>(x[((size_t)gi * Hp + gy) * Wp + gx]);
      slab[ic][sy][sx] = v;
    }
    // global w is (O, I, K, K): consecutive idx walk taps, then channels
    for (int idx = tid; idx < OT * kIC * KK; idx += kThreads) {
      const int oo = idx / (kIC * KK);
      const int rem = idx - oo * (kIC * KK);
      const int ic = rem / KK;
      const int tap = rem - ic * KK;
      const int oc = o0 + oo, gi = i0 + ic;
      float v = 0.f;
      if (oc < O && gi < I) v = to_f<T>(w[((size_t)oc * I + gi) * KK + tap]);
      wsm[ic][tap][oo] = v;
    }
    __syncthreads();
    for (int ic = 0; ic < kIC; ++ic) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float xv[kPX];
#pragma unroll
          for (int p = 0; p < kPX; ++p) xv[p] = slab[ic][ty + ky][tx * kPX + kx + p];
          const float* wr = &wsm[ic][ky * K + kx][og * kOPT];
#pragma unroll
          for (int o = 0; o < kOPT; ++o) {
            const float wv = wr[o];
#pragma unroll
            for (int p = 0; p < kPX; ++p) acc[o][p] = fmaf(wv, xv[p], acc[o][p]);
          }
        }
      }
    }
  }

  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int o = 0; o < kOPT; ++o) {
    const int oc = o0 + og * kOPT + o;
    if (oc >= O) break;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int xx = x0 + tx * kPX + p;
      if (xx < W) out[((size_t)oc * H + y) * W + xx] = from_f<T>(acc[o][p]);
    }
  }
}

constexpr int kDwT = 32;  // output-channel and patch-row tile of conv_dw
constexpr int kDwP = 64;  // pixels staged per pass

// partial[s, o, k] = sum over split s's pixels of g[o, pix] * patch[k, pix],
// k = (i * K + ky) * K + kx, patch[k, (y, x)] = xp[i, y + ky, x + kx].
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_partial_kernel(const T* __restrict__ xp, const T* __restrict__ g,
                       float* __restrict__ partial, int I, int Hp, int Wp,
                       int O, int K, int H, int W, int pix_per_split) {
  const int KK = K * K;
  const int Kt = I * KK;
  const int HW = H * W;
  const int s = blockIdx.x;
  const int k0 = blockIdx.y * kDwT;
  const int o0 = blockIdx.z * kDwT;
  __shared__ float gs[kDwP][kDwT + 1];
  __shared__ float ps[kDwP][kDwT + 1];

  const int tid = threadIdx.x;
  const int to = tid / 16;  // 2 output channels per thread
  const int tk = tid % 16;  // 2 patch rows per thread
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  const int p_begin = s * pix_per_split;
  const int p_end = min(HW, p_begin + pix_per_split);
  for (int pb = p_begin; pb < p_end; pb += kDwP) {
    __syncthreads();
    for (int idx = tid; idx < kDwP * kDwT; idx += kThreads) {
      const int r = idx / kDwP;
      const int c = idx - r * kDwP;
      const int pix = pb + c;
      float gv = 0.f, pv = 0.f;
      if (pix < p_end) {
        const int oc = o0 + r;
        if (oc < O) gv = to_f<T>(g[(size_t)oc * HW + pix]);
        const int kc = k0 + r;
        if (kc < Kt) {
          const int i = kc / KK;
          const int t = kc - i * KK;
          const int ky = t / K, kx = t - (t / K) * K;
          const int yy = pix / W, xx = pix - (pix / W) * W;
          pv = to_f<T>(xp[((size_t)i * Hp + yy + ky) * Wp + xx + kx]);
        }
      }
      gs[c][r] = gv;
      ps[c][r] = pv;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDwP; ++c) {
      const float g0 = gs[c][to * 2], g1 = gs[c][to * 2 + 1];
      const float p0 = ps[c][tk * 2], p1 = ps[c][tk * 2 + 1];
      acc[0][0] = fmaf(g0, p0, acc[0][0]);
      acc[0][1] = fmaf(g0, p1, acc[0][1]);
      acc[1][0] = fmaf(g1, p0, acc[1][0]);
      acc[1][1] = fmaf(g1, p1, acc[1][1]);
    }
  }

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
