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
// run in no order. So the forward is ONE cooperative launch
// (cudaLaunchCooperativeKernel, grid <= the co-resident blocks) whose blocks
// walk (row tile x channel tile) work items and meet at grid.sync() between
// passes: per-item per-channel partial sums go to an f32 scratch, and every
// block that needs a channel's statistic sums that channel's partials
// itself, in one fixed order, so all blocks see the same bits. The conv
// output is written once and re-read from the 50 MB L2 (4 MB at most
// here). No float atomics: every reduction is deterministic.
//
// What bounds them on the card: the conv (forward, dw, dx) is arithmetic,
// and all three run on conv_mma.cuh's tensor-core tiles in 3xTF32; the BN
// and LeakyReLU passes move (Co, H, W) f32 a few times and are bound by
// bytes. One launch per site and pass matters more than kernel time at
// these sizes: the training step is bound by the host's launch rate.
//   * fwd: pass 1 runs the conv on the tensor cores, on conv_mma.cuh's
//     implicit-GEMM tile in 3xTF32 (the 128 x 16 tile of ops/kernels/
//     fused_block.py::FWD_TILE, no split of K: the cooperative grid walks
//     the tiles), its epilogue storing the tile and summing it per channel
//     in a fixed order. The deep sites (8^2-32^2) have few tiles, each
//     walking all of K = Ci * k^2 in order: they take the most time.
//     Each channel chunk's MMAs start from zero and the chunk's sum is
//     added in f32 (conv_mma.cuh's PROMOTE): a chain of MMAs over all of K
//     drifted the deep sites' batch means by ~1e-5 of their largest value.
//     Passes 2 and 3 walk (channel, 2048-pixel chunk) items: the exact
//     two-pass biased variance over H*W (not the shifted one-pass moments of
//     the unfused chain), stats = [mu, inv] per channel, then normalize +
//     LeakyReLU in place. The launch is sized to the co-resident blocks at
//     the tile's real dynamic shared memory.
//   * bwd_dc (replaces _bwd_dc_call): bound by bytes, g and out read once
//     and dconv written once (3 x Co*H*W f32: 0.0174 ms per 256^2 den step
//     at 3.35 TB/s), and at 14 of the den net's 20 sites, whose bound is
//     under 1 us, by the cost of a launch itself. The TPU kernel walks a
//     channel's rows twice from VMEM; a Hopper block holds at most 227 KB,
//     but a channel of the widest site (16 x 256^2: 512 KB of g and out)
//     fits in the shared memory of a cluster of 8 blocks. So each channel
//     goes to a cluster (1-8 blocks, a contiguous pixel slice each), or, at
//     the deep sites, several channels to one block (a warp or more each);
//     ops/kernels/fused_block.py::dc_plan picks it from the shape alone,
//     filling the card in about one wave. A block bulk-copies its slices of
//     g and out into shared memory (cp.async.bulk on mbarriers, up to four
//     pieces, so summing starts before the last piece lands), sums gp and
//     gp * xhat in a fixed order (xhat recomputed from the block output:
//     LeakyReLU inverted by sign, a safe reciprocal of gamma), meets the
//     other ranks through distributed shared memory in rank order (one
//     cluster barrier after the pushes), and writes dconv from shared
//     memory. One ordinary cluster launch: no
//     grid barrier, no scratch, no second read of g or out from device
//     memory where the slice is resident (every 256^2 den site; past 227 KB
//     a slice keeps what fits and re-reads the rest, in the same order).
//   * bwd_dw: conv_mma.cuh's dw tile (M = output channels, N = input
//     channels x taps, the reduction over pixels on xp's channels-last
//     slab), the pixels split over a cluster summed through distributed
//     shared memory in rank order, then over groups of clusters summed by
//     the last leader to arrive; the tile and split of ops/kernels/
//     cf_conv.py::dw_plan. One ordinary launch, deterministic, no scratch
//     unless there are groups.
//   * bwd_dx: conv_mma.cuh's FULL tile, the full correlation of dconv with
//     the flipped, I/O-transposed kernel; the (k-1) zero halo is applied by
//     bounds on the unpadded dconv and the flip by indexing, so nothing is
//     padded or copied first. A cluster of `split` blocks splits K where
//     the output tiles are few; the tile and split of ops/kernels/
//     cf_conv.py::tile_plan. Its own kernel name, not cf_conv_fwd's, so its
//     launches and its profile rows are its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "conv_mma.cuh"
#include "conv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace conv_tile;

constexpr int kWarps = kThreads / 32;

constexpr int kFwdPix = 2048;  // pixels of one BN work item of the forward

// out (O, H, W) <- lrelu(bn(conv(xp, w))), stats (O, 2) <- [mu, inv];
// xp (I, H+K-1, W+K-1) the padded input, w (O, I, K, K); part_sum: m_tiles
// * O floats, part_sq: O * ceil(H*W / kFwdPix) floats of scratch.
template <class TL>
__global__ void __launch_bounds__(TL::kThreads)
fused_fwd_mma_kernel(const float* __restrict__ xp,
                     const float* __restrict__ w,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* out, float* stats,
                     float* part_sum, float* part_sq, int I, int H, int W,
                     int O, int K, float inv_hw, float slope, float eps) {
  constexpr int THREADS = TL::kThreads, NWARP = THREADS / 32;
  __shared__ float red[TL::WM][TL::BN];
  __shared__ float wsum[NWARP];
  __shared__ float tot[2];
  cg::grid_group grid = cg::this_grid();
  const int m_tiles = ((H + TL::TH - 1) / TL::TH) *
                      ((W + conv_mma::kTW - 1) / conv_mma::kTW);
  const int n_items = m_tiles * ((O + TL::BN - 1) / TL::BN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // pass 1: the conv tile (3xTF32 on the tensor cores) into out, its
  // per-channel sums into part_sum[my * O + oc]: each thread's pixels in
  // (mf, column half) order, the 8 lanes of a channel pair by a shuffle
  // tree (lane g = 0's result), then the tile's WM warp rows in order
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int my = item % m_tiles, nz = item / m_tiles;
    conv_mma::conv_tile_mma_at<float, TL, 1, false, true>(
        xp, w, nullptr, I, H + K - 1, W + K - 1, O, K, H, W,
        conv_mma::AtTile{(unsigned)my, (unsigned)nz},
        [&](const float (&acc)[1][conv_mma::kMF][TL::NF][4], int y0, int x0,
            int n0, int warp_m, int warp_n, int ln) {
          const int g = ln >> 2, t = ln & 3;
#pragma unroll
          for (int nf = 0; nf < TL::NF; ++nf)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              const int n = warp_n * TL::NF * 8 + nf * 8 + 2 * t + c2;
              const int oc = n0 + n;
              float v = 0.f;
#pragma unroll
              for (int mf = 0; mf < conv_mma::kMF; ++mf) {
                const int y = y0 + conv_mma::kMF * warp_m + mf;
#pragma unroll
                for (int eh = 0; eh < 2; ++eh) {
                  const int xx = x0 + g + eh * 8;
                  if (oc < O && y < H && xx < W) {
                    const float a = acc[0][mf][nf][eh * 2 + c2];
                    out[((size_t)oc * H + y) * W + xx] = a;
                    v += a;
                  }
                }
              }
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
              if (g == 0) red[warp_m][n] = v;
            }
          __syncthreads();
          if (threadIdx.x < TL::BN && n0 + threadIdx.x < O) {
            float v = 0.f;
            for (int r = 0; r < TL::WM; ++r) v += red[r][threadIdx.x];
            part_sum[(size_t)my * O + n0 + threadIdx.x] = v;
          }
          __syncthreads();
        });
  }
  grid.sync();

  // BN work items: (channel c, chunk of kFwdPix pixels); a channel's mean
  // is the sum of its m_tiles tile sums in one fixed order (warp 0), the
  // same bits in every block
  const int HW = H * W;
  const int n_chunks = (HW + kFwdPix - 1) / kFwdPix;
  const int n_bn = O * n_chunks;
  auto totals = [&](int c, bool with_var) {
    if (warp == 0) {
      const float s = warp_sum_strided(part_sum + c, m_tiles, O);
      if (lane == 0) tot[0] = s;
    } else if (warp == 1 && with_var) {
      const float s = warp_sum_strided(part_sq + (size_t)c * n_chunks,
                                       n_chunks, 1);
      if (lane == 0) tot[1] = s;
    }
    __syncthreads();
  };

  // pass 2: the centred sums of squares (exact two-pass variance), per
  // chunk: the threads' strided sums, the warp trees, the warps in order
  for (int item = blockIdx.x; item < n_bn; item += gridDim.x) {
    const int c = item / n_chunks, ch = item % n_chunks;
    totals(c, false);
    const float mu = tot[0] * inv_hw;
    const int p_end = min(HW, (ch + 1) * kFwdPix);
    float v = 0.f;
    for (int p = ch * kFwdPix + threadIdx.x; p < p_end; p += THREADS) {
      const float d = out[(size_t)c * HW + p] - mu;
      v += d * d;
    }
    v = warp_sum(v);
    if (lane == 0) wsum[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int k = 0; k < NWARP; ++k) s += wsum[k];
      part_sq[(size_t)c * n_chunks + ch] = s;
    }
    __syncthreads();
  }
  grid.sync();

  // pass 3: stats, then normalize + LeakyReLU in place
  for (int item = blockIdx.x; item < n_bn; item += gridDim.x) {
    const int c = item / n_chunks, ch = item % n_chunks;
    totals(c, true);
    const float mu = tot[0] * inv_hw;
    const float var = tot[1] * inv_hw;
    const float inv = 1.f / sqrtf(var + eps);
    if (ch == 0 && threadIdx.x == 0) {
      stats[c * 2] = mu;
      stats[c * 2 + 1] = inv;
    }
    const float ga = gamma[c], be = beta[c];
    const int p_end = min(HW, (ch + 1) * kFwdPix);
    for (int p = ch * kFwdPix + threadIdx.x; p < p_end; p += THREADS) {
      float* q = &out[(size_t)c * HW + p];
      const float yv = (*q - mu) * inv * ga + be;
      *q = yv > 0.f ? yv : slope * yv;
    }
    __syncthreads();
  }
}

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

constexpr int kDcMaxChunks = 4;  // bulk copies (and mbarriers) per slice
constexpr int kDcMaxCpb = 8;     // channels per block at most: a warp each
// the plan's dynamic shared memory at most (ops/kernels/fused_block.py::
// DC_SMEM), below the 227 KB a block may opt in to
constexpr int kDcSmemMax = 224 * 1024;

// The end of bulk chunk k of `chunks` of a resident slice of n pixels
// (n % 4 == 0): 16-byte boundaries, the last chunk ending at n.
__device__ __forceinline__ int dc_chunk_end(int n, int k, int chunks) {
  return k + 1 == chunks ? n : (n * (k + 1) / chunks) & ~3;
}

// The cluster barrier in its two halves (PTX barrier.cluster): every
// thread of every block of the cluster arrives, then waits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// dconv, dgamma, dbeta from (g, out, stats) in one pass over g and out.
// Grid: ceil(O / cpb) * cluster blocks in clusters of `cluster`. Cluster
// blocks share one channel (cpb == 1), rank r taking pixels [r * len,
// (r + 1) * len); or a block takes cpb whole channels (cluster == 1), a
// group of 256 / cpb threads each. The first `res` pixels of each of a
// block's slices stay in dynamic shared memory (cpb * 2 * res floats: g,
// then out, per channel). Where `bulk` (H*W % 4 == 0; g, out and dc
// 16-byte aligned) they arrive by 1-D bulk copies in `chunks` pieces, each
// on its own mbarrier, and are read and written as float4; else each
// thread loads its own pixels and keeps them. Pixels past `res` are read
// from global memory again in the second step.
// The order of the sums, the same on both paths: a thread takes the groups
// of four pixels u = t, t + 256 / cpb, ..., each group's pixels in order;
// then the warp's shuffle tree, the group's warps in index order, and the
// cluster's ranks in rank order. Each rank pushes its partials into every
// rank's shared memory (distributed shared memory) between two cluster
// barriers, the first of which only proves that every rank has started,
// so every rank sums the same values in the same order: the bits depend
// on the shape alone. No grid barrier, no scratch, no atomics.
__global__ void __launch_bounds__(kThreads)
fused_bwd_dc_cluster_kernel(const float* __restrict__ g,
                            const float* __restrict__ out,
                            const float* __restrict__ stats,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            float* __restrict__ dc, float* __restrict__ dgamma,
                            float* __restrict__ dbeta, int O, int HW,
                            int cluster, int cpb, int len, int res,
                            int chunks, int bulk, float inv_hw, float slope,
                            float inv_slope) {
  extern __shared__ __align__(128) float dsm[];
  __shared__ __align__(8) uint64_t bars[kDcMaxCpb * kDcMaxChunks];
  __shared__ float red[2][kWarps];
  __shared__ float part[kDcMaxCpb][2];
  __shared__ float ranks[conv_mma::kMaxSplit][2];  // every rank's partials
  if (cluster > 1) cluster_arrive_relaxed();        // this rank has started
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gt = kThreads / cpb;  // threads per channel
  const int j = threadIdx.x / gt, t = threadIdx.x % gt;
  const int rank = blockIdx.x % cluster;
  const int c = (blockIdx.x / cluster) * cpb + j;
  const int p0 = rank * len;
  const int n = c < O ? max(0, min(len, HW - p0)) : 0;  // this slice's pixels
  const int nr = min(n, res);                            // resident
  const size_t base = (size_t)c * HW + p0;
  float* sg = dsm + (size_t)2 * j * res;
  float* so = sg + res;
  const uint32_t bar = bulk_copy::smem_u32(bars + j * kDcMaxChunks);
  const DcLeaf lf(gamma, beta, min(c, O - 1));
  const float scale = stats[min(c, O - 1) * 2 + 1] * lf.ga;

  if (bulk) {
    if (threadIdx.x == 0) {
      for (int q = 0; q < cpb * kDcMaxChunks; ++q)
        bulk_copy::bar_init(bulk_copy::smem_u32(bars + q), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
      const uint64_t pol = bulk_copy::l2_evict_normal();
      for (int k = 0, lo = 0; k < chunks; ++k) {
        const int hi = dc_chunk_end(nr, k, chunks);
        const uint32_t bytes = (uint32_t)(hi - lo) * 4;
        bulk_copy::bar_expect_tx(bar + 8 * k, 2 * bytes);
        if (bytes) {
          bulk_copy::bulk_load(bulk_copy::smem_u32(sg + lo), g + base + lo,
                               bytes, bar + 8 * k, pol);
          bulk_copy::bulk_load(bulk_copy::smem_u32(so + lo), out + base + lo,
                               bytes, bar + 8 * k, pol);
        }
        lo = hi;
      }
    }
  }

  // xhat from the block output (LeakyReLU inverted by sign) and gp, the
  // same f32 operations as bwd_dc_plain (__fmul_rn: no contraction into an
  // FMA)
  auto leaf = [&](float o, float gv, float& xh, float& gp) {
    const bool m = o > 0.f;
    xh = ((m ? o : __fmul_rn(o, inv_slope)) - lf.be) * lf.rg;
    gp = m ? gv : __fmul_rn(slope, gv);
  };
  float s1 = 0.f, s2 = 0.f;
  auto add = [&](float o, float gv) {
    float xh, gp;
    leaf(o, gv, xh, gp);
    s1 += gp;
    s2 += __fmul_rn(gp, xh);
  };
  const float4* sg4 = reinterpret_cast<const float4*>(sg);
  const float4* so4 = reinterpret_cast<const float4*>(so);
  const float4* g4 = reinterpret_cast<const float4*>(g + base);
  const float4* o4 = reinterpret_cast<const float4*>(out + base);
  // step 1: this thread's groups, in order, wherever they are
  int u = t;
  if (bulk) {
    for (int k = 0; k < chunks; ++k) {
      const int hi = dc_chunk_end(nr, k, chunks) >> 2;
      if (u >= hi) continue;
      bulk_copy::bar_wait(bar + 8 * k, 0);
      for (; u < hi; u += gt) {
        const float4 o = so4[u], v = sg4[u];
        add(o.x, v.x), add(o.y, v.y), add(o.z, v.z), add(o.w, v.w);
      }
    }
    for (; u < n >> 2; u += gt) {
      const float4 o = __ldg(o4 + u), v = __ldg(g4 + u);
      add(o.x, v.x), add(o.y, v.y), add(o.z, v.z), add(o.w, v.w);
    }
  } else {
    for (; 4 * u < n; u += gt)
      for (int p = 4 * u; p < min(4 * u + 4, n); ++p) {
        const float o = out[base + p], gv = g[base + p];
        if (p < nr) {  // read back by this thread alone in step 2
          so[p] = o;
          sg[p] = gv;
        }
        add(o, gv);
      }
  }

  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (t < 2) {
    const int wpc = kWarps / cpb;
    float s = 0.f;
    for (int w = 0; w < wpc; ++w) s += red[t][j * wpc + w];
    part[j][t] = s;
  }
  float tot1, tot2;
  if (cluster > 1) {
    // push this rank's partials to every rank, then sum them in rank order
    cluster_wait();  // every rank has started: its shared memory exists
    __syncthreads();
    if (threadIdx.x < 2 * cluster) {
      float* dst = cg::this_cluster().map_shared_rank(&ranks[0][0],
                                                      threadIdx.x >> 1);
      dst[rank * 2 + (threadIdx.x & 1)] = part[0][threadIdx.x & 1];
    }
    cluster_arrive();
    cluster_wait();  // every push has landed; none follows
    tot1 = 0.f;
    tot2 = 0.f;
    for (int r = 0; r < cluster; ++r) {
      tot1 += ranks[r][0];
      tot2 += ranks[r][1];
    }
  } else {
    __syncthreads();
    tot1 = part[j][0];
    tot2 = part[j][1];
  }
  if (rank == 0 && t == 0 && c < O) {
    dgamma[c] = tot2;
    dbeta[c] = tot1;
  }

  // step 2: dconv from the resident slice (the rest from global memory)
  const float m1 = tot1 * inv_hw, m2 = tot2 * inv_hw;
  auto dconv = [&](float o, float gv) {
    float xh, gp;
    leaf(o, gv, xh, gp);
    return scale * ((gp - m1) - __fmul_rn(xh, m2));
  };
  if (bulk) {
    float4* d4 = reinterpret_cast<float4*>(dc + base);
    for (int q = t; q < n >> 2; q += gt) {
      const bool in = q < nr >> 2;
      const float4 o = in ? so4[q] : __ldg(o4 + q);
      const float4 v = in ? sg4[q] : __ldg(g4 + q);
      d4[q] = make_float4(dconv(o.x, v.x), dconv(o.y, v.y), dconv(o.z, v.z),
                          dconv(o.w, v.w));
    }
  } else {
    for (int q = t; 4 * q < n; q += gt)
      for (int p = 4 * q; p < min(4 * q + 4, n); ++p)
        dc[base + p] = p < nr ? dconv(so[p], sg[p])
                              : dconv(out[base + p], g[base + p]);
  }
}

// dw (O, I, K, K) = sum over pixels of dc (O, H, W) x the patches of xp
// (I, H+K-1, W+K-1): conv_mma.cuh's dw tile in 3xTF32, all K rows of taps
// per block. partial / ticket as conv_mma::dw_tile_mma takes them.
template <int WM, int WN, int WK, int K, int KYB>
__global__ void __launch_bounds__(32 * WM * WN * WK)
fused_bwd_dw_mma_kernel(const float* __restrict__ xp,
                        const float* __restrict__ dc, float* __restrict__ dw,
                        float* __restrict__ partial, int* __restrict__ ticket,
                        int I, int Hp, int Wp, int O, int cluster, int vec) {
  conv_mma::dw_tile_mma<float, conv_mma::DwTile<WM, WN, WK>, K, KYB>(
      xp, dc, dw, partial, ticket, I, Hp, Wp, O, cluster, vec != 0);
}

// dx (I, H+K-1, W+K-1) of the padded input from dc (O, H, W) and w
// (O, I, K, K): dx[i, y, x] = sum_{o, ky, kx} dc[o, y-K+1+ky, x-K+1+kx] *
// w[o, i, K-1-ky, K-1-kx], dc zero outside its extent -- conv_mma.cuh's
// FULL tile in 3xTF32 on dc and w as stored.
template <int WM, int WN, int NF>
__global__ void __launch_bounds__(32 * WM * WN)
fused_bwd_dx_mma_kernel(const float* __restrict__ dc,
                        const float* __restrict__ w, float* __restrict__ dx,
                        int O, int H, int W, int I, int K) {
  conv_mma::conv_tile_mma<float, conv_mma::Tile<WM, WN, NF>, 1, true>(
      dc, w, nullptr, dx, nullptr, O, H, W, I, K, H + K - 1, W + K - 1);
}

// The co-resident block count of a cooperative kernel of `threads` threads
// and `smem` bytes of dynamic shared memory on the current device, cached
// per (kernel, smem). The kernel's dynamic shared memory limit is raised to
// `smem` first, as its launch needs.
int max_coop_blocks(const void* kern, int threads, int smem) {
  static const void* keys[64];
  static int smems[64], vals[64];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (keys[i] == kern && smems[i] == smem) return vals[i];
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > conv_mma::kOptInSmem &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem) != cudaSuccess)
    return 0;
  if (n < 64) {
    keys[n] = kern;
    smems[n] = smem;
    vals[n++] = per_sm * sms;
  }
  return per_sm * sms;
}

// A cooperative launch on min(items, co-resident blocks) blocks.
template <typename Kern>
int launch_coop(Kern kern, int n_items, void** args, cudaStream_t st,
                int threads = kThreads, int smem = 0) {
  const void* fn = reinterpret_cast<const void*>(kern);
  const int max_blocks = max_coop_blocks(fn, threads, smem);
  if (max_blocks <= 0 || n_items <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = n_items < max_blocks ? n_items : max_blocks;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the forward on conv_mma's tile `tile` (conv_mma::with_tile's index; the
// grid walks the tiles, so no cluster split)
int fwd_tile(const float* xp, const float* w, const float* gamma,
             const float* beta, float* out, float* stats, float* part_sum,
             float* part_sq, int I, int H, int W, int O, int K, int tile,
             float inv_hw, float slope, float eps, cudaStream_t st) {
  return conv_mma::with_tile(tile, [&](auto tl) {
    using TL = decltype(tl);
    const int m_tiles = ((H + TL::TH - 1) / TL::TH) *
                        ((W + conv_mma::kTW - 1) / conv_mma::kTW);
    const int conv_items = m_tiles * ((O + TL::BN - 1) / TL::BN);
    const int bn_items = O * ((H * W + kFwdPix - 1) / kFwdPix);
    void* args[] = {&xp, &w, &gamma, &beta, &out, &stats, &part_sum,
                    &part_sq, &I, &H, &W, &O, &K, &inv_hw, &slope, &eps};
    return launch_coop(fused_fwd_mma_kernel<TL>,
                       conv_items > bn_items ? conv_items : bn_items, args,
                       st, TL::kThreads,
                       conv_mma::smem_bytes<float, TL>(K, 1, 1));
  });
}

int dx_tile(const float* dc, const float* w, float* dx, int O, int H, int W,
            int I, int K, int tile, int split, cudaStream_t st) {
  const int Hout = H + K - 1, Wout = W + K - 1;
  return conv_mma::with_tile(tile, [&](auto tl) {
    using TL = decltype(tl);
    const dim3 grid(split,
                    ((Hout + TL::TH - 1) / TL::TH) *
                        ((Wout + conv_mma::kTW - 1) / conv_mma::kTW),
                    (I + TL::BN - 1) / TL::BN);
    return conv_mma::launch(
        fused_bwd_dx_mma_kernel<TL::WM, TL::WN, TL::NF>, TL::kThreads,
        conv_mma::smem_bytes<float, TL>(K, 1, split), grid, split, st, dc, w,
        dx, O, H, W, I, K);
  });
}

template <int K>
int dw_k(const float* xp, const float* dc, float* partial, int* ticket,
         float* dw, int I, int H, int W, int O, int tile, int cluster,
         int groups, cudaStream_t st) {
  const int vec = reinterpret_cast<uintptr_t>(dc) % 16 == 0 &&
                  (W * (int)sizeof(float)) % 16 == 0;
  return conv_mma::with_dw_tile<false>(tile, [&](auto tl) {
    using TL = decltype(tl);
    const int tiles = ((O + TL::BO - 1) / TL::BO) * ((I + TL::BC - 1) / TL::BC);
    return conv_mma::launch(
        fused_bwd_dw_mma_kernel<TL::WM, TL::WN, TL::WK, K, K>, TL::kThreads,
        conv_mma::dw_smem_bytes<float, TL>(K, K, cluster),
        dim3(cluster * groups, tiles, 1), cluster, st, xp, dc, dw, partial,
        ticket, I, H + K - 1, W + K - 1, O, cluster, vec);
  });
}

}  // namespace

extern "C" {

// xp (I, H+K-1, W+K-1), w (O, I, K, K), gamma / beta (O,) -> out (O, H, W),
// stats (O, 2); tile: conv_mma::with_tile's index; part_sum: m_tiles * O
// floats (m_tiles the tile's (row, column) tiles of H x W), part_sq: O *
// ceil(H*W / 2048) floats.
int fused_block_fwd(const float* xp, const float* w, const float* gamma,
                    const float* beta, float* out, float* stats,
                    float* part_sum, float* part_sq, int I, int H, int W,
                    int O, int K, int tile, float inv_hw, float slope,
                    float eps, void* stream) {
  if (K != 1 && K != 3) return (int)cudaErrorInvalidValue;
  return fwd_tile(xp, w, gamma, beta, out, stats, part_sum, part_sq, I, H, W,
                  O, K, tile, inv_hw, slope, eps,
                  static_cast<cudaStream_t>(stream));
}

// g, out (O, H*W), stats (O, 2), gamma / beta (O,) -> dc (O, H*W), dgb
// (2, O) = [dgamma; dbeta]. The plan of ops/kernels/fused_block.py::
// dc_plan: cluster (1-8) blocks per channel, or cpb (1, 2, 4, 8) channels
// per block, slices of len pixels, res of them resident (both multiples of
// 4), loaded in `chunks` (1-4) bulk copies; one ordinary cluster launch.
// The bulk copies are taken where H*W % 4 == 0 and g, out and dc are
// 16-byte aligned (checked here).
int fused_block_bwd_dc(const float* g, const float* out, const float* stats,
                       const float* gamma, const float* beta, float* dc,
                       float* dgb, int O, int HW, int cluster, int cpb,
                       int len, int res, int chunks, float inv_hw,
                       float slope, float inv_slope, void* stream) {
  static bool allowed = false;
  const int smem = cpb * 2 * res * (int)sizeof(float);
  if (O < 1 || HW < 1 || cluster < 1 || cluster > conv_mma::kMaxSplit ||
      (cpb != 1 && cpb != 2 && cpb != 4 && cpb != kDcMaxCpb) ||
      (cpb > 1 && (cluster > 1 || len < HW)) || len % 4 || res % 4 ||
      res < 4 || (long long)len * cluster < HW || smem > kDcSmemMax ||
      chunks < 1 || chunks > kDcMaxChunks)
    return (int)cudaErrorInvalidValue;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_bwd_dc_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kDcSmemMax);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int bulk = HW % 4 == 0 && (reinterpret_cast<uintptr_t>(g) |
                                   reinterpret_cast<uintptr_t>(out) |
                                   reinterpret_cast<uintptr_t>(dc)) %
                                          16 == 0;
  return conv_mma::launch_cluster(
      fused_bwd_dc_cluster_kernel, kThreads, smem,
      dim3((O + cpb - 1) / cpb * cluster), cluster,
      static_cast<cudaStream_t>(stream), g, out, stats, gamma, beta, dc, dgb,
      dgb + O, O, HW, cluster, cpb, len, res, chunks, bulk, inv_hw, slope,
      inv_slope);
}

// xp (I, H+K-1, W+K-1), dc (O, H, W) -> dw (O, I, K, K), K in {1, 3}.
// tile: conv_mma::with_dw_tile's index; the pixel tiles split over cluster
// * groups blocks per output tile (cluster 1-8). partial: groups * (output
// tiles) * BO * BC * K * K floats of scratch (unread when groups == 1);
// ticket: one int per output tile, zero, and left zero.
int fused_block_bwd_dw(const float* xp, const float* dc, float* partial,
                       int* ticket, float* dw, int I, int H, int W, int O,
                       int K, int tile, int cluster, int groups,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster < 1 || cluster > conv_mma::kMaxSplit || groups < 1)
    return (int)cudaErrorInvalidValue;
  if (K == 1)
    return dw_k<1>(xp, dc, partial, ticket, dw, I, H, W, O, tile, cluster,
                   groups, st);
  if (K == 3)
    return dw_k<3>(xp, dc, partial, ticket, dw, I, H, W, O, tile, cluster,
                   groups, st);
  return (int)cudaErrorInvalidValue;
}

// dc (O, H, W), w (O, I, K, K) -> dx (I, H+K-1, W+K-1), K in {1, 3}. tile:
// conv_mma::with_tile's index; split: the blocks of a cluster that share
// one output tile (1-8, at most the chunks of 8 of the O channels).
int fused_block_bwd_dx(const float* dc, const float* w, float* dx, int O,
                       int H, int W, int I, int K, int tile, int split,
                       void* stream) {
  if ((K != 1 && K != 3) || split < 1 || split > conv_mma::kMaxSplit ||
      split > (O + 7) / 8)
    return (int)cudaErrorInvalidValue;
  return dx_tile(dc, w, dx, O, H, W, I, K, tile, split,
                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
