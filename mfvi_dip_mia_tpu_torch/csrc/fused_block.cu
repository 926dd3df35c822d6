// Fused 'same' conv (k in {1, 3}) + train-mode BatchNorm + LeakyReLU and its
// three backward kernels for Hopper (sm_90a), f32 only, as the TPU block is.
//
// Replaces the four Pallas TPU kernels of
// mfvi_dip_mia_tpu/ops/pallas/fused_block.py:
//   * fused_block_fwd    <- _fwd_call    (:127)
//   * fused_block_bwd_dc <- _bwd_dc_call (:212)
//   * fused_block_bwd_dw <- _bwd_dw_call (:280)
//   * fused_block_bwd_dx <- _bwd_dx_call (:326)
//
// What does not carry over from the TPU: its forward keeps the whole
// (Co, H, W) conv output in VMEM across three sequential loops (conv + sum,
// centred sum of squares, normalize). No Hopper block holds 4 MB, and blocks
// run in no order. So the forward and the dc kernel are each ONE cooperative
// launch (cudaLaunchCooperativeKernel, grid <= the co-resident blocks) whose
// blocks walk (row tile x channel tile) work items and meet at grid.sync()
// between passes: per-item per-channel partial sums go to an f32 scratch,
// and every block that needs a channel's statistic sums that channel's
// partials itself, in one fixed order, so all blocks see the same bits. The
// conv output is written once and re-read from the 50 MB L2 (4 MB at most
// here). No float atomics: every reduction is deterministic.
//
// What bounds them on the card: the conv (forward, dw, dx) is arithmetic;
// the BN and LeakyReLU passes move (Co, H, W) f32 a few times and are bound
// by bytes. This first version runs the conv on the CUDA cores (FFMA), with
// the register tile of csrc/cf_conv.cu (conv_tile.cuh). One launch per
// site and pass matters more than kernel time at these sizes: the training
// step is bound by the host's launch rate.
//   * fwd: exact two-pass biased variance over H*W (not the shifted one-pass
//     moments of the unfused chain), stats = [mu, inv] per channel.
//   * bwd_dc: xhat recomputed from the block OUTPUT (LeakyReLU inverted by
//     sign, a safe reciprocal of gamma), two passes with one grid.sync().
//   * bwd_dw: split reduction over pixels into f32 partials, grid.sync(), and
//     a fixed-order sum of the splits, in one cooperative launch.
//   * bwd_dx: the full correlation of dconv with the flipped, I/O-transposed
//     kernel; the (k-1) zero halo is applied by bounds on the unpadded dconv
//     and the flip by indexing, so nothing is padded or copied first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "conv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace conv_tile;

constexpr int kWarps = kThreads / 32;

// (row tile x column tile x channel tile) work items of a conv tile
template <int OG>
struct Items {
  int tiles_x, n_sp, n_items;
  __device__ __forceinline__ Items(int H, int W, int O) {
    tiles_x = (W + kTW - 1) / kTW;
    n_sp = tiles_x * ((H + Geom<OG>::TH - 1) / Geom<OG>::TH);
    n_items = n_sp * ((O + Geom<OG>::OT - 1) / Geom<OG>::OT);
  }
  __device__ __forceinline__ void decode(int item, int& sp, int& x0, int& y0,
                                         int& o0) const {
    sp = item % n_sp;
    o0 = (item / n_sp) * Geom<OG>::OT;
    x0 = (sp % tiles_x) * kTW;
    y0 = (sp / tiles_x) * Geom<OG>::TH;
  }
};

// The tile's per-channel sum of v (this thread's kOPT channels) to
// part[sp * O + oc], in a fixed order: a warp shuffle tree, then the group's
// warps in order.
template <int OG>
__device__ __forceinline__ void tile_channel_sum(const float (&v)[kOPT],
                                                 float* part, int sp, int o0,
                                                 int O) {
  constexpr int WPG = Geom<OG>::PT / 32;  // warps per output-channel group
  __shared__ float red[kWarps][kOPT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 0; o < kOPT; ++o) {
    const float s = warp_sum(v[o]);
    if (lane == 0) red[warp][o] = s;
  }
  __syncthreads();
  if (threadIdx.x < Geom<OG>::OT) {
    const int grp = threadIdx.x / kOPT, o = threadIdx.x % kOPT;
    float s = 0.f;
    for (int k = 0; k < WPG; ++k) s += red[grp * WPG + k][o];
    const int oc = o0 + threadIdx.x;
    if (oc < O) part[(size_t)sp * O + oc] = s;
  }
  __syncthreads();
}

// dst[c] = sum over the n_sp spatial tiles of part[t * O + o0 + c] for the
// tile's OT channels (warp w takes channels w, w + 8, ...).
template <int OG>
__device__ __forceinline__ void channel_totals(const float* part, float* dst,
                                               int n_sp, int o0, int O) {
  const int warp = threadIdx.x >> 5;
  for (int c = warp; c < Geom<OG>::OT; c += kWarps) {
    float s = 0.f;
    if (o0 + c < O) s = warp_sum_strided(part + o0 + c, n_sp, O);
    if ((threadIdx.x & 31) == 0) dst[c] = s;
  }
  __syncthreads();
}

// out (O, H, W) <- lrelu(bn(conv(xp, w))), stats (O, 2) <- [mu, inv];
// xp (I, H+K-1, W+K-1) the padded input, w (O, I, K, K); part_sum / part_sq
// scratch of n_sp * O floats each.
template <int K, int OG>
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* out, float* stats, float* part_sum, float* part_sq,
                 int I, int H, int W, int O, float inv_hw, float slope,
                 float eps) {
  constexpr int OT = Geom<OG>::OT;
  __shared__ float mu_s[OT], inv_s[OT];
  cg::grid_group grid = cg::this_grid();
  const Items<OG> it(H, W, O);
  const Lane<OG> ln;
  int sp, x0, y0, o0;

  // pass 1: the conv tile into out, its per-channel sums into part_sum
  for (int item = blockIdx.x; item < it.n_items; item += gridDim.x) {
    it.decode(item, sp, x0, y0, o0);
    float acc[kOPT][kPX];
    accumulate<float, K, OG, false>(xp, w, I, H + K - 1, W + K - 1, O, x0, y0,
                                    o0, acc);
    const int y = y0 + ln.ty;
    float v[kOPT];
#pragma unroll
    for (int o = 0; o < kOPT; ++o) {
      v[o] = 0.f;
      const int oc = o0 + ln.og * kOPT + o;
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        const int xx = x0 + ln.tx * kPX + p;
        if (oc < O && y < H && xx < W) {
          out[((size_t)oc * H + y) * W + xx] = acc[o][p];
          v[o] += acc[o][p];
        }
      }
    }
    tile_channel_sum<OG>(v, part_sum, sp, o0, O);
  }
  grid.sync();

  // pass 2: the centred sums of squares (exact two-pass variance)
  for (int item = blockIdx.x; item < it.n_items; item += gridDim.x) {
    it.decode(item, sp, x0, y0, o0);
    channel_totals<OG>(part_sum, mu_s, it.n_sp, o0, O);
    const int y = y0 + ln.ty;
    float v[kOPT];
#pragma unroll
    for (int o = 0; o < kOPT; ++o) {
      v[o] = 0.f;
      const int oc = o0 + ln.og * kOPT + o;
      const float mu = mu_s[ln.og * kOPT + o] * inv_hw;
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        const int xx = x0 + ln.tx * kPX + p;
        if (oc < O && y < H && xx < W) {
          const float d = out[((size_t)oc * H + y) * W + xx] - mu;
          v[o] += d * d;
        }
      }
    }
    tile_channel_sum<OG>(v, part_sq, sp, o0, O);
  }
  grid.sync();

  // pass 3: stats, then normalize + LeakyReLU in place
  for (int item = blockIdx.x; item < it.n_items; item += gridDim.x) {
    it.decode(item, sp, x0, y0, o0);
    channel_totals<OG>(part_sum, mu_s, it.n_sp, o0, O);
    channel_totals<OG>(part_sq, inv_s, it.n_sp, o0, O);
    if (threadIdx.x < OT) {
      const float mu = mu_s[threadIdx.x] * inv_hw;
      const float var = inv_s[threadIdx.x] * inv_hw;
      const float inv = 1.f / sqrtf(var + eps);
      mu_s[threadIdx.x] = mu;
      inv_s[threadIdx.x] = inv;
      const int oc = o0 + threadIdx.x;
      if (sp == 0 && oc < O) {
        stats[oc * 2] = mu;
        stats[oc * 2 + 1] = inv;
      }
    }
    __syncthreads();
    const int y = y0 + ln.ty;
#pragma unroll
    for (int o = 0; o < kOPT; ++o) {
      const int oc = o0 + ln.og * kOPT + o;
      if (oc >= O || y >= H) continue;
      const float mu = mu_s[ln.og * kOPT + o], inv = inv_s[ln.og * kOPT + o];
      const float ga = gamma[oc], be = beta[oc];
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        const int xx = x0 + ln.tx * kPX + p;
        if (xx < W) {
          float* q = &out[((size_t)oc * H + y) * W + xx];
          const float yv = (*q - mu) * inv * ga + be;
          *q = yv > 0.f ? yv : slope * yv;
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kDcPix = kThreads * 8;  // pixels of one bwd_dc work item

struct DcLeaf {
  float ga, be, rg;
  __device__ __forceinline__ DcLeaf(const float* gamma, const float* beta,
                                    int c) {
    ga = gamma[c];
    be = beta[c];
    // gamma can be ~0 early in training: a safe reciprocal, as the TPU kernel
    rg = 1.f / (fabsf(ga) < 1e-20f ? 1e-20f : ga);
  }
};

// dconv, dgamma, dbeta from (g, out, stats); part: O * n_chunks * 2 floats
__global__ void __launch_bounds__(kThreads)
fused_bwd_dc_kernel(const float* __restrict__ g, const float* __restrict__ out,
                    const float* __restrict__ stats,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* dc, float* dgamma,
                    float* dbeta, float* part, int O, int HW, float inv_hw,
                    float slope, float inv_slope) {
  __shared__ float red[2][kWarps];
  __shared__ float tot[2];
  cg::grid_group grid = cg::this_grid();
  const int n_chunks = (HW + kDcPix - 1) / kDcPix;
  const int n_items = O * n_chunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // pass 1: per-chunk sums of gp and gp * xhat
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item / n_chunks, ch = item % n_chunks;
    const DcLeaf lf(gamma, beta, c);
    const int p_end = min(HW, (ch + 1) * kDcPix);
    float s1 = 0.f, s2 = 0.f;
    for (int p = ch * kDcPix + threadIdx.x; p < p_end; p += kThreads) {
      const size_t q = (size_t)c * HW + p;
      const float o = out[q], gt = g[q];
      const bool m = o > 0.f;
      const float xh = ((m ? o : o * inv_slope) - lf.be) * lf.rg;
      const float gp = m ? gt : slope * gt;
      s1 += gp;
      s2 += gp * xh;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      float s = 0.f;
      for (int k = 0; k < kWarps; ++k) s += red[threadIdx.x][k];
      part[(size_t)item * 2 + threadIdx.x] = s;
    }
    __syncthreads();
  }
  grid.sync();

  // pass 2: the channel totals, then dconv elementwise
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item / n_chunks, ch = item % n_chunks;
    if (warp < 2) {
      const float s = warp_sum_strided(part + (size_t)c * n_chunks * 2 + warp,
                                       n_chunks, 2);
      if (lane == 0) tot[warp] = s;
    }
    __syncthreads();
    const float s1 = tot[0], s2 = tot[1];
    if (ch == 0 && threadIdx.x == 0) {
      dgamma[c] = s2;
      dbeta[c] = s1;
    }
    const DcLeaf lf(gamma, beta, c);
    const float m1 = s1 * inv_hw, m2 = s2 * inv_hw;
    const float scale = stats[c * 2 + 1] * lf.ga;
    const int p_end = min(HW, (ch + 1) * kDcPix);
    for (int p = ch * kDcPix + threadIdx.x; p < p_end; p += kThreads) {
      const size_t q = (size_t)c * HW + p;
      const float o = out[q], gt = g[q];
      const bool m = o > 0.f;
      const float xh = ((m ? o : o * inv_slope) - lf.be) * lf.rg;
      const float gp = m ? gt : slope * gt;
      dc[q] = scale * (gp - m1 - xh * m2);
    }
    __syncthreads();
  }
}

// dw (O, I*K*K) = sum over pixels of dc (O, H, W) x patches of xp
// (I, H+K-1, W+K-1); items (split, patch-row tile, channel tile) write
// partials (n_split, O, I*K*K), summed over splits in order after grid.sync.
__global__ void __launch_bounds__(kThreads)
fused_bwd_dw_kernel(const float* __restrict__ xp, const float* __restrict__ dc,
                    float* part, float* dw, int I, int H, int W, int O, int K,
                    int n_split, int pix_per_split) {
  cg::grid_group grid = cg::this_grid();
  const int Kt = I * K * K;
  const int k_tiles = (Kt + kDwT - 1) / kDwT;
  const int o_tiles = (O + kDwT - 1) / kDwT;
  const int n_items = n_split * k_tiles * o_tiles;
  const int to = threadIdx.x / 16, tk = threadIdx.x % 16;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int s = item % n_split;
    const int k0 = ((item / n_split) % k_tiles) * kDwT;
    const int o0 = (item / (n_split * k_tiles)) * kDwT;
    const int p_begin = s * pix_per_split;
    const int p_end = min(H * W, p_begin + pix_per_split);
    float acc[2][2];
    dw_tile<float>(xp, dc, I, H + K - 1, W + K - 1, O, K, p_begin, p_end, k0,
                   o0, acc);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int oc = o0 + to * 2 + a;
      if (oc >= O) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int kc = k0 + tk * 2 + b;
        if (kc < Kt) part[((size_t)s * O + oc) * Kt + kc] = acc[a][b];
      }
    }
  }
  grid.sync();

  const int n = O * Kt;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < n;
       j += gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) s += part[(size_t)k * n + j];
    dw[j] = s;
  }
}

// dx (I, H+K-1, W+K-1) of the padded input from dc (O, H, W) and w
// (O, I, K, K): dx[i, y, x] = sum_{o, ky, kx} dc[o, y-K+1+ky, x-K+1+kx] *
// w[o, i, K-1-ky, K-1-kx], dc zero outside its extent.
template <int K, int OG>
__global__ void __launch_bounds__(kThreads)
fused_bwd_dx_kernel(const float* __restrict__ dc, const float* __restrict__ w,
                    float* __restrict__ dx, int O, int H, int W, int I) {
  const int Ho = H + K - 1, Wo = W + K - 1;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * Geom<OG>::TH;
  const int i0 = blockIdx.z * Geom<OG>::OT;
  float acc[kOPT][kPX];
  accumulate<float, K, OG, true>(dc, w, O, H, W, I, x0, y0, i0, acc);

  const Lane<OG> ln;
  const int y = y0 + ln.ty;
  if (y >= Ho) return;
#pragma unroll
  for (int o = 0; o < kOPT; ++o) {
    const int ic = i0 + ln.og * kOPT + o;
    if (ic >= I) break;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int xx = x0 + ln.tx * kPX + p;
      if (xx < Wo) dx[((size_t)ic * Ho + y) * Wo + xx] = acc[o][p];
    }
  }
}

// The co-resident block count of a cooperative kernel on the current device,
// cached per kernel (the kernels of one signature share a pointer type, so
// the cache is keyed by the pointer).
int max_coop_blocks(const void* kern) {
  static const void* keys[32];
  static int vals[32];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (keys[i] == kern) return vals[i];
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (n < 32) {
    keys[n] = kern;
    vals[n++] = per_sm * sms;
  }
  return per_sm * sms;
}

// A cooperative launch on min(items, co-resident blocks) blocks.
template <typename Kern>
int launch_coop(Kern kern, int n_items, void** args, cudaStream_t st) {
  const int max_blocks = max_coop_blocks(reinterpret_cast<const void*>(kern));
  if (max_blocks <= 0 || n_items <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = n_items < max_blocks ? n_items : max_blocks;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(blocks), dim3(kThreads), args, 0,
      st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int K, int OG>
int fwd_k(const float* xp, const float* w, const float* gamma,
          const float* beta, float* out, float* stats, float* part_sum,
          float* part_sq, int I, int H, int W, int O, float inv_hw, float slope,
          float eps, cudaStream_t st) {
  const int tiles = ((W + kTW - 1) / kTW) * ((H + Geom<OG>::TH - 1) / Geom<OG>::TH);
  const int n_items = tiles * ((O + Geom<OG>::OT - 1) / Geom<OG>::OT);
  void* args[] = {&xp, &w, &gamma, &beta, &out, &stats, &part_sum, &part_sq,
                  &I, &H, &W, &O, &inv_hw, &slope, &eps};
  return launch_coop(fused_fwd_kernel<K, OG>, n_items, args, st);
}

template <int K>
int fwd_og(const float* xp, const float* w, const float* gamma,
           const float* beta, float* out, float* stats, float* part_sum,
           float* part_sq, int I, int H, int W, int O, float inv_hw,
           float slope, float eps, cudaStream_t st) {
  if (O <= kOPT)
    return fwd_k<K, 1>(xp, w, gamma, beta, out, stats, part_sum, part_sq, I, H,
                       W, O, inv_hw, slope, eps, st);
  if (O <= 2 * kOPT)
    return fwd_k<K, 2>(xp, w, gamma, beta, out, stats, part_sum, part_sq, I, H,
                       W, O, inv_hw, slope, eps, st);
  return fwd_k<K, 4>(xp, w, gamma, beta, out, stats, part_sum, part_sq, I, H,
                     W, O, inv_hw, slope, eps, st);
}

template <int K, int OG>
int dx_k(const float* dc, const float* w, float* dx, int O, int H, int W,
         int I, cudaStream_t st) {
  const int Ho = H + K - 1, Wo = W + K - 1;
  dim3 grid((Wo + kTW - 1) / kTW, (Ho + Geom<OG>::TH - 1) / Geom<OG>::TH,
            (I + Geom<OG>::OT - 1) / Geom<OG>::OT);
  fused_bwd_dx_kernel<K, OG><<<grid, kThreads, 0, st>>>(dc, w, dx, O, H, W, I);
  return (int)cudaGetLastError();
}

template <int K>
int dx_og(const float* dc, const float* w, float* dx, int O, int H, int W,
          int I, cudaStream_t st) {
  if (I <= kOPT) return dx_k<K, 1>(dc, w, dx, O, H, W, I, st);
  if (I <= 2 * kOPT) return dx_k<K, 2>(dc, w, dx, O, H, W, I, st);
  return dx_k<K, 4>(dc, w, dx, O, H, W, I, st);
}

}  // namespace

extern "C" {

// xp (I, H+K-1, W+K-1), w (O, I, K, K), gamma / beta (O,) -> out (O, H, W),
// stats (O, 2); part_sum / part_sq: >= n_sp * O floats each, n_sp the
// number of (row, column) tiles, at most ceil(H/8) * ceil(W/32).
int fused_block_fwd(const float* xp, const float* w, const float* gamma,
                    const float* beta, float* out, float* stats,
                    float* part_sum, float* part_sq, int I, int H, int W,
                    int O, int K, float inv_hw, float slope, float eps,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 1)
    return fwd_og<1>(xp, w, gamma, beta, out, stats, part_sum, part_sq, I, H,
                     W, O, inv_hw, slope, eps, st);
  if (K == 3)
    return fwd_og<3>(xp, w, gamma, beta, out, stats, part_sum, part_sq, I, H,
                     W, O, inv_hw, slope, eps, st);
  return (int)cudaErrorInvalidValue;
}

// g, out (O, H*W), stats (O, 2), gamma / beta (O,) -> dc (O, H*W), dgamma,
// dbeta (O,); part: O * ceil(H*W / 2048) * 2 floats.
int fused_block_bwd_dc(const float* g, const float* out, const float* stats,
                       const float* gamma, const float* beta, float* dc,
                       float* dgamma, float* dbeta, float* part, int O, int HW,
                       float inv_hw, float slope, float inv_slope,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_items = O * ((HW + kDcPix - 1) / kDcPix);
  void* args[] = {&g, &out, &stats, &gamma, &beta, &dc, &dgamma, &dbeta, &part,
                  &O, &HW, &inv_hw, &slope, &inv_slope};
  return launch_coop(fused_bwd_dc_kernel, n_items, args, st);
}

// xp (I, H+K-1, W+K-1), dc (O, H, W) -> dw (O, I*K*K); part: n_split * O *
// I*K*K floats, split s covering pixels [s * pix_per_split, ...).
int fused_block_bwd_dw(const float* xp, const float* dc, float* part, float* dw,
                       int I, int H, int W, int O, int K, int n_split,
                       int pix_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_items = n_split * ((I * K * K + kDwT - 1) / kDwT) *
                      ((O + kDwT - 1) / kDwT);
  void* args[] = {&xp, &dc, &part, &dw, &I, &H, &W, &O, &K, &n_split,
                  &pix_per_split};
  return launch_coop(fused_bwd_dw_kernel, n_items, args, st);
}

// dc (O, H, W), w (O, I, K, K) -> dx (I, H+K-1, W+K-1)
int fused_block_bwd_dx(const float* dc, const float* w, float* dx, int O, int H,
                       int W, int I, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 1) return dx_og<1>(dc, w, dx, O, H, W, I, st);
  if (K == 3) return dx_og<3>(dc, w, dx, O, H, W, I, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
