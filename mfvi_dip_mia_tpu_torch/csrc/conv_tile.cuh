// Device code of the fused block's FFMA kernels (csrc/fused_block.cu): the
// register-tiled FFMA tile of a VALID stride-1 conv (its dx), the
// split-reduction tile of its weight gradient, and deterministic warp
// reductions (also its forward's). The tensor-core tiles are in
// conv_mma.cuh. See fused_block.cu's source notes for what bounds the
// kernels built from these tiles.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace conv_tile {

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
constexpr int kTW = 32;  // output columns per tile
constexpr int kPX = 4;   // output columns per thread
constexpr int kOPT = 8;  // output channels per thread
constexpr int kRowThreads = kTW / kPX;

// A tile of OT = OG * kOPT output channels x TH rows x kTW columns: OG groups
// of kOPT output channels split the 256 threads; within a group, 8 threads
// cover a row's 32 columns, so the tile covers TH = 32 / OG rows.
template <int OG>
struct Geom {
  static constexpr int PT = kThreads / OG;  // threads per output-channel group
  static constexpr int TH = PT / kRowThreads;
  static constexpr int OT = OG * kOPT;
};

// This thread's place in the tile: output-channel group, row, column group.
template <int OG>
struct Lane {
  int og, ty, tx;
  __device__ __forceinline__ Lane() {
    const int pt = threadIdx.x % Geom<OG>::PT;
    og = threadIdx.x / Geom<OG>::PT;
    ty = pt / kRowThreads;
    tx = pt % kRowThreads;
  }
};

// The shared-memory operands of one pass over kIC input channels from i0:
// slab[ic][sy][sx] = src[i0 + ic][y0 + sy - pad][x0 + sx - pad] (zero outside
// x (I, Hs, Ws); pad = K - 1 with FULL, else 0) and wsm[ic][tap][oo] = wt of
// output channel o0 + oo (zero outside), wt as ``accumulate`` defines it.
template <typename T, int K, int OG, bool FULL>
__device__ __forceinline__ void load_slab(
    const T* __restrict__ x, int I, int Hs, int Ws, int i0, int x0, int y0,
    float (&slab)[kIC][Geom<OG>::TH + K - 1][kTW + K - 1]) {
  constexpr int SH = Geom<OG>::TH + K - 1;
  constexpr int SW = kTW + K - 1;
  constexpr int pad = FULL ? K - 1 : 0;
  for (int idx = threadIdx.x; idx < kIC * SH * SW; idx += kThreads) {
    const int ic = idx / (SH * SW);
    const int rem = idx - ic * (SH * SW);
    const int sy = rem / SW;
    const int sx = rem - sy * SW;
    const int gi = i0 + ic, gy = y0 + sy - pad, gx = x0 + sx - pad;
    float v = 0.f;
    if (gi < I && gy < Hs && gx < Ws && (!FULL || (gy >= 0 && gx >= 0)))
      v = to_f<T>(x[((size_t)gi * Hs + gy) * Ws + gx]);
    slab[ic][sy][sx] = v;
  }
}

template <typename T, int K, int OG, bool FULL>
__device__ __forceinline__ void load_weights(
    const T* __restrict__ w, int I, int O, int i0, int o0,
    float (&wsm)[kIC][K * K][Geom<OG>::OT]) {
  constexpr int OT = Geom<OG>::OT;
  constexpr int KK = K * K;
  // consecutive idx walk taps, then channels
  for (int idx = threadIdx.x; idx < OT * kIC * KK; idx += kThreads) {
    const int oo = idx / (kIC * KK);
    const int rem = idx - oo * (kIC * KK);
    const int ic = rem / KK;
    const int tap = rem - ic * KK;
    const int oc = o0 + oo, gi = i0 + ic;
    float v = 0.f;
    if (oc < O && gi < I)
      v = FULL ? to_f<T>(w[((size_t)gi * O + oc) * KK + (KK - 1 - tap)])
               : to_f<T>(w[((size_t)oc * I + gi) * KK + tap]);
    wsm[ic][tap][oo] = v;
  }
}

// acc[o][p] = sum_{i, ky, kx} wt[oc][i][ky][kx] * src[i][y + ky - pad][x + kx - pad]
// for oc = o0 + og * kOPT + o, y = y0 + ty, x = x0 + tx * kPX + p, where src
// is x (I, Hs, Ws), zero outside it, and wt is w (O, I, K, K) as it is. With
// FULL the correlation is the full one of the input gradient: a virtual zero
// halo of pad = K - 1 around x, and wt the flipped, I/O-transposed kernel of
// w (I, O, K, K): wt[oc][i][ky][kx] = w[i][oc][K-1-ky][K-1-kx].
// Every thread of the block must call it (it synchronises the block).
template <typename T, int K, int OG, bool FULL>
__device__ __forceinline__ void accumulate(const T* __restrict__ x,
                                           const T* __restrict__ w, int I,
                                           int Hs, int Ws, int O, int x0,
                                           int y0, int o0,
                                           float (&acc)[kOPT][kPX]) {
  constexpr int TH = Geom<OG>::TH;
  constexpr int SH = TH + K - 1;
  constexpr int SW = kTW + K - 1;
  constexpr int OT = Geom<OG>::OT;
  constexpr int KK = K * K;
  __shared__ __align__(16) float slab[kIC][SH][SW];
  __shared__ __align__(16) float wsm[kIC][KK][OT];

  const Lane<OG> ln;
#pragma unroll
  for (int o = 0; o < kOPT; ++o)
#pragma unroll
    for (int p = 0; p < kPX; ++p) acc[o][p] = 0.f;

  for (int i0 = 0; i0 < I; i0 += kIC) {
    __syncthreads();
    load_slab<T, K, OG, FULL>(x, I, Hs, Ws, i0, x0, y0, slab);
    load_weights<T, K, OG, FULL>(w, I, O, i0, o0, wsm);
    __syncthreads();
    for (int ic = 0; ic < kIC; ++ic) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float xv[kPX];
#pragma unroll
          for (int p = 0; p < kPX; ++p)
            xv[p] = slab[ic][ln.ty + ky][ln.tx * kPX + kx + p];
          const float* wr = &wsm[ic][ky * K + kx][ln.og * kOPT];
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
}

constexpr int kDwT = 32;  // output-channel and patch-row tile of the dw tile
constexpr int kDwP = 64;  // pixels staged per pass

// One (patch-row tile k0, output-channel tile o0) block of the weight
// gradient over pixels [p_begin, p_end):
//   acc[a][b] = sum_pix g[o0 + to*2 + a, pix] * patch[k0 + tk*2 + b, pix],
// patch[(i * K + ky) * K + kx, (y, x)] = xp[i, y + ky, x + kx], xp (I, Hp, Wp),
// g (O, H, W) with H = Hp-K+1, W = Wp-K+1; to = tid / 16, tk = tid % 16.
// Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void dw_tile(const T* __restrict__ xp,
                                        const T* __restrict__ g, int I, int Hp,
                                        int Wp, int O, int K, int p_begin,
                                        int p_end, int k0, int o0,
                                        float (&acc)[2][2]) {
  const int KK = K * K;
  const int Kt = I * KK;
  const int W = Wp - K + 1;
  const int HW = (Hp - K + 1) * W;
  __shared__ float gs[kDwP][kDwT + 1];
  __shared__ float ps[kDwP][kDwT + 1];

  const int tid = threadIdx.x;
  const int to = tid / 16;
  const int tk = tid % 16;
  acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.f;
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
}

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
