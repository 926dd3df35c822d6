// The tensor-core implicit-GEMM tile of a VALID stride-1 convolution, batch 1,
// shared by csrc/cf_conv.cu (cf_conv_fwd: the forward and the FULL input
// gradient) and csrc/lrt_conv.cu (lrt_conv_fwd: two contractions of one
// input stream). The FFMA tile of conv_tile.cuh stays for csrc/fused_block.cu
// and the weight gradient.
//
// The GEMM: M = output pixels (Hout * Wout), N = output channels, K = I * k^2,
// walked as (input-channel chunk, ky, kx, channel within the chunk).
//   * A block owns TH rows x 16 columns of output pixels (M) and BN output
//     channels (N). Each warp owns two rows (two m16 fragments) and NF n8
//     fragments. Tiles: 128x64, 64x64, 128x32, 64x32, 256x16, 128x16 and
//     64x16 (M x N), chosen per launch by ops/kernels/cf_conv.py::tile_plan.
//   * A channel chunk is 32 bytes: 16 bf16 or 8 f32 channels. The halo'd input
//     slab of one chunk is staged channels-last in shared memory,
//     slab[sy][sx][ic], so the A fragment of tap (ky, kx) is the slab shifted
//     by (ky, kx): ldmatrix reads it directly and im2col never reaches device
//     memory. The weights of the chunk are staged as B, w[tap][n][ic]. Ragged
//     channel edges (I or O not a multiple of the chunk or the tile) are zero
//     in shared memory. Each 32-byte row is two 16-byte halves, swapped on
//     every other group of four rows, so that ldmatrix's eight rows fall on
//     distinct banks.
//   * A ring of stages: the next chunks' slabs and weights are copied while
//     this chunk's MMAs run. f32 elements go by cp.async (4 bytes each,
//     zero-filled outside the tensor), up to 4 stages deep. A bf16 element is 2 bytes, below cp.async's
//     smallest copy, and a channels-first tensor has no contiguous run along
//     the channels a shared-memory row holds; so bf16 goes through registers
//     (a 16-byte store per half row), issued before this chunk's MMAs. Each
//     thread walks half rows with a mixed-radix counter, so the copy divides
//     nothing, and one address serves a half row's 8 or 4 channels.
//   * MMA: mma.sync m16n8k16 bf16 with f32 accumulation; for f32 storage,
//     3xTF32 on m16n8k8: v = hi + lo with hi = tf32(v), lo = tf32(v - hi), and
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi accumulated in f32 (about f32
//     accuracy, as the TPU kernels' Precision.HIGHEST).
//   * Split K: where the output tiles are too few to fill 132 SMs, a thread
//     block cluster of `split` blocks (gridDim.x) shares one output tile; rank
//     r takes chunks r, r + split, ... The leader sums the other ranks'
//     partial tiles through distributed shared memory in rank order:
//     deterministic, no float atomics, one launch.
//
// FULL: the input gradient of the VALID conv, the full correlation of an
// unpadded cotangent x = g (I, Hs, Ws) with a virtual (k-1) zero halo and
// the flipped, I/O-transposed kernel read by indexing from the forward weight
// w (I, O, k, k) as stored: wt[oc][i][ky][kx] = w[i][oc][k-1-ky][k-1-kx].
// Output (O, Hs + k - 1, Ws + k - 1).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace conv_mma {

namespace cg = cooperative_groups;

constexpr int kRowBytes = 32;  // one slab position's (or weight row's) chunk
constexpr int kTW = 16;        // output columns of a tile row: one m16 fragment
constexpr int kMF = 2;         // m16 fragments (tile rows) per warp

template <typename T> struct Chunk;
template <> struct Chunk<float> { static constexpr int C = 8; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int C = 16; };

// WM x WN warps; each warp two tile rows x NF n8 fragments
template <int WM_, int WN_, int NF_>
struct Tile {
  static constexpr int WM = WM_, WN = WN_, NF = NF_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int TH = kMF * WM;      // output rows per tile
  static constexpr int BN = 8 * NF * WN;   // output channels per tile
  static_assert(NF % 2 == 0, "B fragments are loaded in pairs");
};

__host__ __device__ inline int stage_bytes(int th, int bn, int k, int nw) {
  return ((th + k - 1) * (kTW + k - 1) + nw * bn * k * k) * kRowBytes;
}

// Stages of the ring: f32 copies are asynchronous, so up to 4 chunks are in
// flight while one is multiplied (as many as fit in ~100 KB, at least 2);
// bf16 copies complete when issued, so 2.
__host__ __device__ inline int ring_stages(int sbytes, int elem_bytes) {
  if (elem_bytes == 2) return 2;
  const int n = 100 * 1024 / sbytes;
  return n < 2 ? 2 : n > 4 ? 4 : n;
}

// Dynamic shared memory of one launch: the ring, or the split-K partial
// tile (NW x BM x BN f32) where that is larger.
template <typename T, class TL>
inline int smem_bytes(int k, int nw, int split) {
  const int sb = stage_bytes(TL::TH, TL::BN, k, nw);
  const int stages = ring_stages(sb, sizeof(T)) * sb;
  const int red = split > 1 ? nw * TL::TH * kTW * TL::BN * 4 : 0;
  return stages > red ? stages : red;
}

// byte offset of half h (16 bytes) of row q
__device__ __forceinline__ int half_at(int q, int h) {
  return q * kRowBytes + ((h ^ ((q >> 2) & 1)) << 4);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n - 1 copy groups (the next chunks') are in flight
__device__ __forceinline__ void cp_async_wait_ring(int n) {
  if (n >= 4)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 3)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A mixed-radix counter over N digits (digit N-1 fastest) that steps by a
// fixed stride without dividing: one thread's walk over a stage's elements
// (start threadIdx.x, stride the block's threads). Digit 0 is unbounded.
template <int N>
struct Walk {
  int d[N], s[N], r[N];
  __device__ __forceinline__ Walk(const int (&radix)[N], int start,
                                  int stride) {
#pragma unroll
    for (int i = N - 1; i > 0; --i) {
      r[i] = radix[i];
      d[i] = start % r[i];
      start /= r[i];
      s[i] = stride % r[i];
      stride /= r[i];
    }
    r[0] = radix[0];
    d[0] = start;
    s[0] = stride;
  }
  __device__ __forceinline__ void next() {
#pragma unroll
    for (int i = N - 1; i > 0; --i) {
      d[i] += s[i];
      if (d[i] >= r[i]) {
        d[i] -= r[i];
        d[i - 1] += 1;
      }
    }
    d[0] += s[0];
  }
};

// Copy what a walk visits (until digit 0 reaches top) into buf, one half
// row (16 bytes: 8 bf16 or 4 f32 channels of one slab position or weight
// row) per step. at(d, src, step, n_ok, off) names the half row at digits
// d: its first channel's element (src; channel c at src + c * step), how
// many of its channels lie inside the tensor (n_ok, the rest are zero) and
// its byte offset in buf. f32 by cp.async; bf16 through registers (a
// 16-byte store per half row), two half rows of loads in flight per thread
// before their stores.
template <typename T, int N, class At>
__device__ __forceinline__ void copy_walk(char* buf, Walk<N>& wk, int top,
                                          const At& at) {
  constexpr int H = 16 / (int)sizeof(T);
  if constexpr (sizeof(T) == 4) {
    for (; wk.d[0] < top; wk.next()) {
      const T* src;
      size_t step;
      int n_ok, off;
      at(wk.d, src, step, n_ok, off);
      const unsigned dst = (unsigned)__cvta_generic_to_shared(buf + off);
#pragma unroll
      for (int c = 0; c < H; ++c) {
        const bool ok = c < n_ok;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         dst + 4 * c),
                     "l"(ok ? src + c * step : src), "r"(ok ? 4 : 0)
                     : "memory");
      }
    }
  } else {
    constexpr int U = 2;
    while (wk.d[0] < top) {
      uint32_t v[U][H / 2];
      int off[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        off[u] = -1;
        if (wk.d[0] < top) {
          const T* src;
          size_t step;
          int n_ok;
          at(wk.d, src, step, n_ok, off[u]);
          const unsigned short* s16 =
              reinterpret_cast<const unsigned short*>(src);
#pragma unroll
          for (int c = 0; c < H; c += 2) {
            const uint32_t lo = c < n_ok ? (uint32_t)s16[c * step] : 0u;
            const uint32_t hi =
                c + 1 < n_ok ? (uint32_t)s16[(c + 1) * step] : 0u;
            v[u][c / 2] = lo | (hi << 16);
          }
          wk.next();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (off[u] >= 0)
          *reinterpret_cast<uint4*>(buf + off[u]) =
              make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
  }
}

// Stage chunk c (input channels c*C ...) of the slab and of NW weights into
// one stage buffer: slab[sy][sx] = x[i][y0 + sy - pad][x0 + sx - pad] and
// wsm[wi][tap][n] = wt of output channel n0 + n, zero outside.
template <typename T, int THREADS, int TH, int BN, int NW, bool FULL>
__device__ __forceinline__ void stage(char* buf, const T* __restrict__ x,
                                      const T* __restrict__ w0,
                                      const T* __restrict__ w1, int I, int Hs,
                                      int Ws, int O, int K, int y0, int x0,
                                      int n0, int c) {
  constexpr int H = 16 / (int)sizeof(T);  // channels per half row
  const int i0 = c * Chunk<T>::C;
  const int pad = FULL ? K - 1 : 0;
  const int SW = kTW + K - 1;
  const size_t plane = (size_t)Hs * Ws;
  // (half, row, column), columns fastest: contiguous in x
  Walk<3> ws({2, TH + K - 1, SW}, threadIdx.x, THREADS);
  copy_walk<T>(buf, ws, 2, [&](const int (&d)[3], const T*& src,
                               size_t& step, int& n_ok, int& off) {
    const int gi = i0 + d[0] * H, gy = y0 + d[1] - pad, gx = x0 + d[2] - pad;
    const bool in = gy >= 0 && gy < Hs && gx >= 0 && gx < Ws;
    n_ok = in ? min(max(I - gi, 0), H) : 0;
    src = n_ok ? x + gi * plane + (size_t)gy * Ws + gx : x;
    step = plane;
    off = half_at(d[1] * SW + d[2], d[0]);
  });
  const int KK = K * K;
  char* wbuf = buf + (TH + K - 1) * SW * kRowBytes;
  // (weight, output channel, half, tap), taps fastest: contiguous in w
  Walk<4> ww({NW, BN, 2, KK}, threadIdx.x, THREADS);
  copy_walk<T>(wbuf, ww, NW, [&](const int (&d)[4], const T*& src,
                                 size_t& step, int& n_ok, int& off) {
    const int oc = n0 + d[1], gi = i0 + d[2] * H, tap = d[3];
    const T* wsrc = d[0] ? w1 : w0;
    n_ok = oc < O ? min(max(I - gi, 0), H) : 0;
    src = !n_ok ? wsrc
                : FULL ? wsrc + ((size_t)gi * O + oc) * KK + (KK - 1 - tap)
                       : wsrc + ((size_t)oc * I + gi) * KK + tap;
    step = FULL ? (size_t)O * KK : (size_t)KK;
    off = d[0] * BN * KK * kRowBytes + half_at(tap * BN + d[1], d[2]);
  });
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const char* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// f32 bits v -> (tf32(v), tf32(v - tf32(v)))
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(v);
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}

template <typename T> __device__ __forceinline__ uint32_t square(uint32_t v);
template <> __device__ __forceinline__ uint32_t square<float>(uint32_t v) {
  const float f = __uint_as_float(v);
  return __float_as_uint(f * f);
}
// two bf16: squared in f32, rounded to bf16 for the MMA
template <>
__device__ __forceinline__ uint32_t square<__nv_bfloat16>(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  __nv_bfloat162 s = __floats2bfloat162_rn(f.x * f.x, f.y * f.y);
  return *reinterpret_cast<uint32_t*>(&s);
}

// acc[mf][nf] += A[mf] * B[nf] for one k-step
template <typename T, int NF>
__device__ __forceinline__ void products(float (&acc)[kMF][NF][4],
                                         const uint32_t (&a)[kMF][4],
                                         const uint32_t (&b)[NF][2]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        mma_bf16(acc[mf][nf], a[mf], b[nf][0], b[nf][1]);
  } else {
    uint32_t ah[kMF][4], al[kMF][4], bh[NF][2], bl[NF][2];
#pragma unroll
    for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[mf][e], ah[mf][e], al[mf][e]);
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) split_tf32(b[nf][e], bh[nf][e], bl[nf][e]);
#pragma unroll
    for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        mma_tf32(acc[mf][nf], al[mf], bh[nf][0], bh[nf][1]);
        mma_tf32(acc[mf][nf], ah[mf], bl[nf][0], bl[nf][1]);
        mma_tf32(acc[mf][nf], ah[mf], bh[nf][0], bh[nf][1]);
      }
  }
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

// One output tile: out0 = conv(x, w0) and, with NW == 2, out1 = conv(x^2,
// w1) (x^2 formed from the staged value at the point of use). x (I, Hs, Ws),
// w (O, I, K, K) (FULL: (I, O, K, K)), out (O, Hout, Wout). Launched on a
// grid (split, tiles of M, tiles of N) with clusters of (split, 1, 1).
template <typename T, class TL, int NW, bool FULL>
__device__ __forceinline__ void conv_tile_mma(
    const T* __restrict__ x, const T* __restrict__ w0,
    const T* __restrict__ w1, T* __restrict__ out0, T* __restrict__ out1,
    int I, int Hs, int Ws, int O, int K, int Hout, int Wout) {
  extern __shared__ __align__(128) char smem[];
  constexpr int C = Chunk<T>::C;
  constexpr int NF = TL::NF;
  constexpr int TH = TL::TH;
  constexpr int BN = TL::BN;
  constexpr int THREADS = TL::kThreads;
  const int SW = kTW + K - 1;
  const int KK = K * K;
  const int slab_bytes = (TH + K - 1) * SW * kRowBytes;
  const int sbytes = stage_bytes(TH, BN, K, NW);
  const int ns = ring_stages(sbytes, sizeof(T));
  const int tiles_x = (Wout + kTW - 1) / kTW;
  const int y0 = (blockIdx.y / tiles_x) * TH;
  const int x0 = (blockIdx.y % tiles_x) * kTW;
  const int n0 = blockIdx.z * BN;
  const int split = gridDim.x;
  const int rank = blockIdx.x;  // the cluster is (split, 1, 1)
  const int nch = (I + C - 1) / C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp % TL::WM, warp_n = warp / TL::WM;
  const int mi = lane >> 3, lr = lane & 7;

  float acc[NW][kMF][NF][4];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wi][mf][nf][e] = 0.f;

  // the ring: chunk j of this rank in stage j % ns, ns - 1 chunks ahead
  for (int j = 0; j < ns - 1; ++j) {
    const int c = rank + j * split;
    if (c < nch)
      stage<T, THREADS, TH, BN, NW, FULL>(smem + j * sbytes, x, w0, w1, I, Hs,
                                          Ws, O, K, y0, x0, n0, c);
    cp_async_commit();
  }
  int j = 0;
  for (int c = rank; c < nch; c += split, ++j) {
    const char* cur = smem + (j % ns) * sbytes;
    const int ahead = c + (ns - 1) * split;
    if (ahead < nch)
      stage<T, THREADS, TH, BN, NW, FULL>(smem + ((j + ns - 1) % ns) * sbytes,
                                          x, w0, w1, I, Hs, Ws, O, K, y0, x0,
                                          n0, ahead);
    cp_async_commit();
    cp_async_wait_ring(ns);
    __syncthreads();
    const char* wsm = cur + slab_bytes;
    for (int ky = 0; ky < K; ++ky) {
      for (int kx = 0; kx < K; ++kx) {
        const int tap = ky * K + kx;
        // A: lanes 0-7 pixels 0-7 half 0, 8-15 pixels 8-15 half 0, 16-23
        // pixels 0-7 half 1, 24-31 pixels 8-15 half 1
        uint32_t a[kMF][4];
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) {
          const int q = (kMF * warp_m + mf + ky) * SW + kx + (mi & 1) * 8 + lr;
          ldsm_x4(a[mf], cur + half_at(q, mi >> 1));
        }
        // B: lanes 0-7 channels 0-7 half 0, 8-15 channels 0-7 half 1, 16-23
        // channels 8-15 half 0, 24-31 channels 8-15 half 1
        uint32_t b[NW][NF][2];
#pragma unroll
        for (int wi = 0; wi < NW; ++wi)
#pragma unroll
          for (int p = 0; p < NF / 2; ++p) {
            const int n = warp_n * NF * 8 + p * 16 + (mi >> 1) * 8 + lr;
            uint32_t r[4];
            ldsm_x4(r, wsm + wi * BN * KK * kRowBytes +
                           half_at(tap * BN + n, mi & 1));
            b[wi][2 * p][0] = r[0];
            b[wi][2 * p][1] = r[1];
            b[wi][2 * p + 1][0] = r[2];
            b[wi][2 * p + 1][1] = r[3];
          }
        products<T, NF>(acc[0], a, b[0]);
        if constexpr (NW == 2) {
          uint32_t a2[kMF][4];
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
            for (int e = 0; e < 4; ++e) a2[mf][e] = square<T>(a[mf][e]);
          products<T, NF>(acc[1], a2, b[1]);
        }
      }
    }
    __syncthreads();
  }

  if (split > 1) {
    // partial tiles through distributed shared memory, summed by the leader
    // in rank order; each thread's registers map to the same output elements
    // in every rank
    cp_async_wait_all();
    cg::cluster_group cluster = cg::this_cluster();
    float* red = reinterpret_cast<float*>(smem);
    if (rank != 0) {
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[(((wi * kMF + mf) * NF + nf) * 4 + e) * THREADS +
                  threadIdx.x] = acc[wi][mf][nf][e];
    }
    cluster.sync();
    if (rank == 0) {
      for (int s = 1; s < split; ++s) {
        const float* remote = cluster.map_shared_rank(red, s);
#pragma unroll
        for (int wi = 0; wi < NW; ++wi)
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
            for (int nf = 0; nf < NF; ++nf)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[wi][mf][nf][e] +=
                    remote[(((wi * kMF + mf) * NF + nf) * 4 + e) * THREADS +
                           threadIdx.x];
      }
    }
    cluster.sync();  // the other ranks' shared memory lives until here
    if (rank != 0) return;
  }

  // c0, c1: pixel g, channels 2t, 2t+1; c2, c3: pixel g + 8
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int wi = 0; wi < NW; ++wi) {
    T* out = wi ? out1 : out0;
#pragma unroll
    for (int mf = 0; mf < kMF; ++mf) {
      const int y = y0 + kMF * warp_m + mf;
      if (y >= Hout) continue;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const int n = n0 + warp_n * NF * 8 + nf * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int xx = x0 + g + (e >> 1) * 8;
          const int oc = n + (e & 1);
          if (xx < Wout && oc < O)
            out[((size_t)oc * Hout + y) * Wout + xx] =
                from_f<T>(acc[wi][mf][nf][e]);
        }
      }
    }
  }
}

// Launch `kern` on grid (split, m tiles, n tiles) in clusters of (split, 1,
// 1). Returns the launch's cudaError_t.
template <typename... P, typename... A>
inline int launch(void (*kern)(P...), int threads, int smem, dim3 grid,
                  int split, cudaStream_t st, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiated tiles, by the index ops/kernels/cf_conv.py::TILES gives:
// 0: 128x64, 1: 64x64, 2: 128x32, 3: 64x32, 4: 256x16, 5: 128x16,
// 6: 64x16 (M x N).
constexpr int kMaxSplit = 8;

// F(tile) for the tile index i; returns cudaErrorInvalidValue otherwise
template <class F>
inline int with_tile(int i, F&& f) {
  switch (i) {
    case 0: return f(Tile<4, 2, 4>{});
    case 1: return f(Tile<2, 2, 4>{});
    case 2: return f(Tile<4, 1, 4>{});
    case 3: return f(Tile<2, 1, 4>{});
    case 4: return f(Tile<8, 1, 2>{});
    case 5: return f(Tile<4, 1, 2>{});
    case 6: return f(Tile<2, 1, 2>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace conv_mma
