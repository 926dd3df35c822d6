// The tensor-core implicit-GEMM tile of a VALID stride-1 convolution, batch 1,
// shared by csrc/cf_conv.cu (cf_conv_fwd: the forward and the FULL input
// gradient), csrc/lrt_conv.cu (lrt_conv_fwd: two contractions of one input
// stream) and csrc/fused_block.cu (fused_block_fwd's conv, through the
// epilogue hook of conv_tile_mma_at, and fused_block_bwd_dx, the FULL
// form); and, at the end of this file, the tile of the conv's weight
// gradient (cf_conv_dw, fused_block_bwd_dw) on the same staging.
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const char* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

// a stored value widened to f32 (exact)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The accumulators of output tile (at.my(), at.nz()) of conv(x, w0) and,
// with NW == 2, conv(x^2, w1) (x^2 formed from the staged value at the point
// of use), handed to epi(acc, y0, x0, n0, warp_m, warp_n, lane) by the block
// that holds the tile's sum. x (I, Hs, Ws), w (O, I, K, K) (FULL: (I, O, K,
// K)), output (O, Hout, Wout). The at.split() blocks of a cluster share the
// tile and take K chunks rank, rank + split, ... (rank = at.rank()); the
// leader (rank 0) sums the partial tiles and alone calls epi. Every thread
// of the block calls it.
// acc[wi][mf][nf][e]: output channel n0 + warp_n * NF * 8 + nf * 8 + 2t +
// (e & 1), pixel (y0 + kMF * warp_m + mf, x0 + g + (e >> 1) * 8), with
// g = lane / 4, t = lane % 4.
// PROMOTE: each channel chunk's MMAs accumulate from zero and the chunk's
// sum is added to acc in f32 on the CUDA cores, so no MMA chain runs longer
// than one chunk's taps. The tensor cores' f32 accumulation drops the bits
// of each product that fall below the running sum, the same way every time,
// so a long chain drifts from the exact sum with a sign that the pixels of
// a channel share; their mean (the fused forward's batch statistic) keeps
// that drift where the pixels' other errors cancel.
template <typename T, class TL, int NW, bool FULL, bool PROMOTE = false,
          class At, class Epi>
__device__ __forceinline__ void conv_tile_mma_at(
    const T* __restrict__ x, const T* __restrict__ w0,
    const T* __restrict__ w1, int I, int Hs, int Ws, int O, int K, int Hout,
    int Wout, const At& at, Epi&& epi) {
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
  const int y0 = (at.my() / tiles_x) * TH;
  const int x0 = (at.my() % tiles_x) * kTW;
  const int n0 = at.nz() * BN;
  const int split = at.split();
  const int rank = at.rank();
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
  float part[NW][kMF][NF][4];  // PROMOTE: this chunk's MMA sums
  float (&sum)[NW][kMF][NF][4] = PROMOTE ? part : acc;
  int j = 0;
  for (int c = rank; c < nch; c += split, ++j) {
    if constexpr (PROMOTE) {
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[wi][mf][nf][e] = 0.f;
    }
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
        products<T, NF>(sum[0], a, b[0]);
        if constexpr (NW == 2) {
          uint32_t a2[kMF][4];
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
            for (int e = 0; e < 4; ++e) a2[mf][e] = square<T>(a[mf][e]);
          products<T, NF>(sum[1], a2, b[1]);
        }
      }
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[wi][mf][nf][e] += part[wi][mf][nf][e];
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
  epi(acc, y0, x0, n0, warp_m, warp_n, lane);
}

// Where a block's tile is (conv_tile_mma_at's `at`). FromGrid: on a grid
// (split, tiles of M, tiles of N) with clusters of (split, 1, 1), read from
// the block's index where the tile needs it (taken as parameters instead,
// the values moved ptxas to other register counts in the f32 tiles).
struct FromGrid {
  __device__ __forceinline__ unsigned my() const { return blockIdx.y; }
  __device__ __forceinline__ unsigned nz() const { return blockIdx.z; }
  __device__ __forceinline__ int split() const { return gridDim.x; }
  __device__ __forceinline__ int rank() const { return blockIdx.x; }
};

// AtTile: a tile that a loop over work items names, with no split of K.
struct AtTile {
  unsigned m, n;
  __device__ __forceinline__ unsigned my() const { return m; }
  __device__ __forceinline__ unsigned nz() const { return n; }
  __device__ __forceinline__ int split() const { return 1; }
  __device__ __forceinline__ int rank() const { return 0; }
};

// One output tile of a launch on a grid (split, tiles of M, tiles of N) with
// clusters of (split, 1, 1), stored to out0 (and out1) in T.
template <typename T, class TL, int NW, bool FULL>
__device__ __forceinline__ void conv_tile_mma(
    const T* __restrict__ x, const T* __restrict__ w0,
    const T* __restrict__ w1, T* __restrict__ out0, T* __restrict__ out1,
    int I, int Hs, int Ws, int O, int K, int Hout, int Wout) {
  conv_tile_mma_at<T, TL, NW, FULL>(
      x, w0, w1, I, Hs, Ws, O, K, Hout, Wout, FromGrid{},
      [&](const float (&acc)[NW][kMF][TL::NF][4], int y0, int x0, int n0,
          int warp_m, int warp_n, int lane) {
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
            for (int nf = 0; nf < TL::NF; ++nf) {
              const int n = n0 + warp_n * TL::NF * 8 + nf * 8 + 2 * t;
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
      });
}

// Launch `kern` on `grid` in clusters of (split, 1, 1) with `smem` bytes of
// dynamic shared memory, which the kernel's limit must already allow.
// Returns the launch's cudaError_t.
template <typename... P, typename... A>
inline int launch_cluster(void (*kern)(P...), int threads, int smem,
                          dim3 grid, int split, cudaStream_t st, A... args) {
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

// Launch `kern` on grid (split, m tiles, n tiles) in clusters of (split, 1,
// 1). Returns the launch's cudaError_t.
// Above 48 KB of shared memory in all a kernel must opt in; the kernels'
// static shared memory (at most ~1 KB here) counts too, hence the margin.
constexpr int kOptInSmem = 46 * 1024;

template <typename... P, typename... A>
inline int launch(void (*kern)(P...), int threads, int smem, dim3 grid,
                  int split, cudaStream_t st, A... args) {
  if (smem > kOptInSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return launch_cluster(kern, threads, smem, grid, split, st, args...);
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

// ---------------------------------------------------------------------------
// The weight gradient of the VALID conv on the same staging and MMAs:
//   dw[o, i, ky, kx] = sum_{y, x} g[o, y, x] * xp[i, y + ky, x + kx],
// g (O, H, W), xp (I, H + K - 1, W + K - 1), dw (O, I, K, K) summed in f32
// and stored in OutT (f32; or bf16, rounded once, for the fused block): a
// GEMM with M = output channels, N = input channels x taps, and the
// reduction over pixels.
//   * A block owns BO = 16 WM output channels, BC = 16 WN input channels and
//     KYB rows of taps (all K rows for K <= 3, one row for K = 5, whose 25
//     taps would not fit in registers), and walks pixel tiles of kDwTH rows x
//     16 columns. Per pixel tile it stages the input's halo'd slab
//     channels-last exactly as the forward does (slab[sy][sx][ic], 32-byte
//     rows, swizzled halves) and the cotangent rows as stored,
//     g[o][16 pixels] (bf16 one 32-byte row, f32 two): for tap (ky, kx),
//     B[pixel][i] is the slab shifted by (ky, kx), a row-address offset, and
//     A[o][pixel] is g. bf16: A by ldmatrix, B by ldmatrix.trans (pixel
//     pairs of one channel), mma.sync m16n8k16 with f32 accumulation. f32:
//     A by ldmatrix; B by 32-bit shared loads (ldmatrix.trans would cut an
//     f32 in half); 3xTF32 on m16n8k8 as the forward. Staging xp
//     channels-first along the pixels instead would put an odd kx shift
//     between bf16 pairs, which no fragment load takes.
//   * Warps: WM x WN x WK. Each warp holds one m16 fragment x 16 channels x
//     the block's taps; the WK warps of one fragment pair take every WK-th
//     pixel row of a tile and are summed in order through shared memory.
//   * Split: the grid's x dimension splits the pixel tiles, block s taking
//     s, s + split, ...; split = cluster x groups. A cluster's ranks are
//     summed by its leader through distributed shared memory in rank order;
//     with groups > 1 each leader stores its sum to `partial`, and the last
//     leader to arrive (a ticket counter, which it resets for the next
//     launch) sums the groups in index order and stores dw. Deterministic,
//     one launch, no float atomics.
// The tile, cluster and groups come from ops/kernels/cf_conv.py::dw_plan.

constexpr int kDwTH = 8;  // pixel rows of a dw pixel tile (x kTW columns)

template <int WM_, int WN_, int WK_>
struct DwTile {
  static constexpr int WM = WM_, WN = WN_, WK = WK_;
  static constexpr int kThreads = 32 * WM * WN * WK;
  static constexpr int kHold = 32 * WM * WN;  // threads that hold the sum
  static constexpr int BO = 16 * WM;          // output channels
  static constexpr int BC = 16 * WN;          // input channels
};

// 32-byte g rows per (pixel row, output channel): 16 pixels
template <typename T>
__host__ __device__ constexpr int dw_g_rows() {
  return sizeof(T) == 4 ? 2 : 1;
}

template <typename T, class TL>
__host__ __device__ inline int dw_stage_bytes(int k, int kyb) {
  return (TL::BC / Chunk<T>::C) * (kDwTH + kyb - 1) * (kTW + k - 1) *
             kRowBytes +
         kDwTH * TL::BO * dw_g_rows<T>() * kRowBytes;
}

// Dynamic shared memory of one launch: the ring, or the reduction buffers
// (the WK - 1 other warps' sums, or one rank's sum for the cluster) where
// those are larger.
template <typename T, class TL>
inline int dw_smem_bytes(int k, int kyb, int cluster) {
  const int sb = dw_stage_bytes<T, TL>(k, kyb);
  const int ring = ring_stages(sb, sizeof(T)) * sb;
  int parts = TL::WK - 1;
  if (cluster > 1 && parts < 1) parts = 1;
  const int red = parts * TL::kHold * kyb * k * 8 * 4;
  return ring > red ? ring : red;
}

// Where pixel tile (y0, x0)'s slab half row at walk digits d = (chunk,
// half, row, column) comes from and goes: its first channel's element (src,
// channel c at src + c * step), how many of its channels lie inside xp (the
// rest are zero) and its byte offset in the stage. The slab holds NCHK
// chunks of input channels c0 ..., rows y0 + ky0 ... (kDwTH + KYB - 1 of
// them) and columns x0 ... (kTW + K - 1), channels-last.
template <typename T, class TL, int K, int KYB>
struct DwSlab {
  static constexpr int H8 = 16 / (int)sizeof(T);  // channels per half row
  static constexpr int NCHK = TL::BC / Chunk<T>::C;
  static constexpr int SW = kTW + K - 1, SH = kDwTH + KYB - 1;
  static constexpr int SLAB = SH * SW * kRowBytes;
  static constexpr int HALVES = NCHK * 2 * SH * SW;
  static constexpr int PER_THREAD = (HALVES + TL::kThreads - 1) / TL::kThreads;
  const T* xp;
  int I, Hp, Wp, y, x0, c0;
  __device__ __forceinline__ Walk<4> walk() const {
    return Walk<4>({NCHK, 2, SH, SW}, threadIdx.x, TL::kThreads);
  }
  __device__ __forceinline__ void operator()(const int (&d)[4], const T*& src,
                                             size_t& step, int& n_ok,
                                             int& off) const {
    const size_t plane = (size_t)Hp * Wp;
    const int gi = c0 + d[0] * Chunk<T>::C + d[1] * H8;
    const int gy = y + d[2], gx = x0 + d[3];
    n_ok = gy < Hp && gx < Wp ? min(max(I - gi, 0), H8) : 0;
    src = n_ok ? xp + gi * plane + (size_t)gy * Wp + gx : xp;
    step = plane;
    off = d[0] * SLAB + half_at(d[2] * SW + d[3], d[1]);
  }
};

// A bf16 slab held in registers between its loads and its stores, so that
// the loads of the next pixel tile are in flight during this one's MMAs.
template <class SL>
struct HeldSlab {
  uint32_t v[SL::PER_THREAD][4];
  int off[SL::PER_THREAD];
  __device__ __forceinline__ void load(const SL& sl) {
    Walk<4> wk = sl.walk();
#pragma unroll
    for (int u = 0; u < SL::PER_THREAD; ++u) {
      off[u] = -1;
      if (wk.d[0] < SL::NCHK) {
        const __nv_bfloat16* src;
        size_t step;
        int n_ok;
        sl(wk.d, src, step, n_ok, off[u]);
        const unsigned short* s16 =
            reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int c = 0; c < 8; c += 2) {
          const uint32_t lo = c < n_ok ? (uint32_t)s16[c * step] : 0u;
          const uint32_t hi = c + 1 < n_ok ? (uint32_t)s16[(c + 1) * step] : 0u;
          v[u][c / 2] = lo | (hi << 16);
        }
        wk.next();
      }
    }
  }
  __device__ __forceinline__ void store(char* buf) const {
#pragma unroll
    for (int u = 0; u < SL::PER_THREAD; ++u)
      if (off[u] >= 0)
        *reinterpret_cast<uint4*>(buf + off[u]) =
            make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
  }
};

// Stage pixel tile (y0, x0)'s cotangent rows into gbuf: rows [(r * GR + hx)
// * BO + o] of 8 (bf16) or 4 (f32) pixels per half, zero outside g,
// asynchronously. vec: g and W * sizeof(T) are 16-byte aligned, so a half
// row lies wholly inside or outside g and goes by one 16-byte cp.async;
// otherwise element by element.
template <typename T, class TL>
__device__ __forceinline__ void dw_stage_g(char* gbuf,
                                           const T* __restrict__ g, int O,
                                           int H, int W, int y0, int x0,
                                           int o0, bool vec) {
  constexpr int H8 = 16 / (int)sizeof(T);
  constexpr int GR = dw_g_rows<T>();
  constexpr int THREADS = TL::kThreads;
  const size_t gplane = (size_t)H * W;
  if (vec) {
    // (channel, row, pixel half-row pair, half), halves fastest
    constexpr int N = TL::BO * kDwTH * GR * 2;
    for (int idx = threadIdx.x; idx < N; idx += THREADS) {
      const int h = idx & 1, q = idx >> 1;
      const int hx = q % GR, r = q / GR % kDwTH, o = q / GR / kDwTH;
      const int oc = o0 + o, gy = y0 + r, gx = x0 + (hx * 2 + h) * H8;
      const bool ok = oc < O && gy < H && gx < W;
      const T* src = ok ? g + oc * gplane + (size_t)gy * W + gx : g;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          gbuf + half_at((r * GR + hx) * TL::BO + o, h));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst),
                   "l"(src), "r"(ok ? 16 : 0)
                   : "memory");
    }
  } else if constexpr (sizeof(T) == 4) {
    Walk<4> wg({TL::BO, kDwTH, GR, 2}, threadIdx.x, THREADS);
    copy_walk<T>(gbuf, wg, TL::BO, [&](const int (&d)[4], const T*& src,
                                       size_t& step, int& n_ok, int& off) {
      const int oc = o0 + d[0], gy = y0 + d[1];
      const int gx = x0 + (d[2] * 2 + d[3]) * H8;
      n_ok = oc < O && gy < H ? min(max(W - gx, 0), H8) : 0;
      src = n_ok ? g + oc * gplane + (size_t)gy * W + gx : g;
      step = 1;
      off = half_at((d[1] * GR + d[2]) * TL::BO + d[0], d[3]);
    });
  } else {
    // bf16 pairs of unaligned rows: 2-byte loads into 4-byte stores
    constexpr int N = TL::BO * kDwTH * 8;  // (channel, row, pixel pair)
    for (int idx = threadIdx.x; idx < N; idx += THREADS) {
      const int pp = idx & 7, r = idx >> 3 & (kDwTH - 1), o = idx >> 6;
      const int oc = o0 + o, gy = y0 + r, gx = x0 + 2 * pp;
      uint32_t v = 0u;
      if (oc < O && gy < H) {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(
            g + oc * gplane + (size_t)gy * W);
        if (gx < W) v = s16[gx];
        if (gx + 1 < W) v |= (uint32_t)s16[gx + 1] << 16;
      }
      *reinterpret_cast<uint32_t*>(
          gbuf + half_at(r * TL::BO + o, pp >> 2) + (pp & 3) * 4) = v;
    }
  }
}

// One output tile (blockIdx.y: output-channel tile, input-channel tile, tap
// group, the last fastest) of dw, launched on a grid (cluster * groups,
// tiles) in clusters of (cluster, 1, 1). partial: tiles * groups * BO * BC *
// KYB * K floats (unused when groups == 1); ticket: tiles ints, zero before
// the launch and after it. OutT (dw's type) is taken from the argument.
template <typename T, class TL, int K, int KYB, typename OutT>
__device__ __forceinline__ void dw_tile_mma(
    const T* __restrict__ xp, const T* __restrict__ g, OutT* __restrict__ dw,
    float* __restrict__ partial, int* __restrict__ ticket, int I, int Hp,
    int Wp, int O, int cluster, bool vec) {
  extern __shared__ __align__(128) char smem[];
  constexpr int NCHK = TL::BC / Chunk<T>::C;
  constexpr int TAPS = KYB * K;
  constexpr int NACC = TAPS * 2 * 4;
  constexpr int SW = kTW + K - 1;
  constexpr int SLAB = (kDwTH + KYB - 1) * SW * kRowBytes;
  constexpr int GR = dw_g_rows<T>();
  constexpr int HOLD = TL::kHold;
  constexpr int NTG = K / KYB;
  const int H = Hp - K + 1, W = Wp - K + 1;
  const int sbytes = dw_stage_bytes<T, TL>(K, KYB);
  const int ns = ring_stages(sbytes, sizeof(T));
  const int tiles_x = (W + kTW - 1) / kTW;
  const int n_pt = ((H + kDwTH - 1) / kDwTH) * tiles_x;
  const int n_ct = (I + TL::BC - 1) / TL::BC;
  const int tile = blockIdx.y;
  const int ky0 = (tile % NTG) * KYB;
  const int c0 = (tile / NTG % n_ct) * TL::BC;
  const int o0 = (tile / NTG / n_ct) * TL::BO;
  const int split = gridDim.x, s = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp % TL::WM, warp_n = warp / TL::WM % TL::WN;
  const int wk = warp / (TL::WM * TL::WN);
  const int mi = lane >> 3, lr = lane & 7;
  const int gq = lane >> 2, tq = lane & 3;

  float acc[TAPS][2][4];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nf][e] = 0.f;

  const int gbytes = NCHK * SLAB;  // the g rows' offset in a stage
  auto slab_of = [&](int pt) {
    return DwSlab<T, TL, K, KYB>{xp, I, Hp, Wp,
                                 (pt / tiles_x) * kDwTH + ky0,
                                 (pt % tiles_x) * kTW, c0};
  };
  auto stage_g = [&](char* buf, int pt) {
    dw_stage_g<T, TL>(buf + gbytes, g, O, H, W, (pt / tiles_x) * kDwTH,
                      (pt % tiles_x) * kTW, o0, vec);
  };
  // the products of the staged pixel tile at cur
  auto products_at = [&](const char* cur) {
    const char* gbuf = cur + gbytes;
    for (int r = wk; r < kDwTH; r += TL::WK) {
      if constexpr (sizeof(T) == 2) {
        // A: lanes 0-7 channels 0-7 pixels 0-7, 8-15 channels 8-15 pixels
        // 0-7, 16-23 channels 0-7 pixels 8-15, 24-31 channels 8-15 pixels
        // 8-15
        uint32_t a[4];
        ldsm_x4(a, gbuf + half_at(r * TL::BO + warp_m * 16 + (mi & 1) * 8 + lr,
                                  mi >> 1));
        const char* slab = cur + warp_n * SLAB;
#pragma unroll
        for (int ky = 0; ky < KYB; ++ky)
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            // B (transposed): lanes 0-7 pixels 0-7 channels 0-7, 8-15
            // pixels 8-15 channels 0-7, 16-23 pixels 0-7 channels 8-15,
            // 24-31 pixels 8-15 channels 8-15
            uint32_t b[4];
            ldsm_x4_trans(b, slab + half_at((r + ky) * SW + kx + (mi & 1) * 8 +
                                                lr,
                                            mi >> 1));
            mma_bf16(acc[ky * K + kx][0], a, b[0], b[1]);
            mma_bf16(acc[ky * K + kx][1], a, b[2], b[3]);
          }
      } else {
#pragma unroll
        for (int hx = 0; hx < 2; ++hx) {  // pixels 8 hx ... 8 hx + 7
          uint32_t a[4], ah[4], al[4];
          ldsm_x4(a, gbuf + half_at((r * GR + hx) * TL::BO + warp_m * 16 +
                                        (mi & 1) * 8 + lr,
                                    mi >> 1));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
          for (int ky = 0; ky < KYB; ++ky)
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
#pragma unroll
              for (int nf = 0; nf < 2; ++nf) {
                // B[pixel tq (+4)][channel gq] of chunk 2 warp_n + nf
                const char* slab = cur + (warp_n * 2 + nf) * SLAB;
                const int q = (r + ky) * SW + kx + hx * 8 + tq;
                const int cb = (gq & 3) * 4;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
                    slab + half_at(q, gq >> 2) + cb);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
                    slab + half_at(q + 4, gq >> 2) + cb);
                uint32_t bh0, bl0, bh1, bl1;
                split_tf32(b0, bh0, bl0);
                split_tf32(b1, bh1, bl1);
                float(&c)[4] = acc[ky * K + kx][nf];
                mma_tf32(c, al, bh0, bh1);
                mma_tf32(c, ah, bl0, bl1);
                mma_tf32(c, ah, bh0, bh1);
              }
        }
      }
    }
  };

  if constexpr (sizeof(T) == 2) {
    // two stages; the next pixel tile's slab loads are issued before this
    // one's MMAs and stored after them, its g rows copied asynchronously
    HeldSlab<DwSlab<T, TL, K, KYB>> held;
    if (s < n_pt) {
      held.load(slab_of(s));
      stage_g(smem, s);
      held.store(smem);
    }
    cp_async_commit();
    int j = 0;
    for (int pt = s; pt < n_pt; pt += split, ++j) {
      char* cur = smem + (j & 1) * sbytes;
      char* nxt = smem + ((j + 1) & 1) * sbytes;
      const int ahead = pt + split;
      if (ahead < n_pt) {
        held.load(slab_of(ahead));
        stage_g(nxt, ahead);
      }
      cp_async_commit();
      cp_async_wait_ring(2);
      __syncthreads();
      products_at(cur);
      if (ahead < n_pt) held.store(nxt);
      __syncthreads();
    }
  } else {
    // the ring: this block's j-th pixel tile in stage j % ns, all by
    // cp.async
    auto stage_pt = [&](char* buf, int pt) {
      const DwSlab<T, TL, K, KYB> sl = slab_of(pt);
      Walk<4> ws = sl.walk();
      copy_walk<T>(buf, ws, NCHK, sl);
      stage_g(buf, pt);
    };
    for (int j = 0; j < ns - 1; ++j) {
      const int pt = s + j * split;
      if (pt < n_pt) stage_pt(smem + j * sbytes, pt);
      cp_async_commit();
    }
    int j = 0;
    for (int pt = s; pt < n_pt; pt += split, ++j) {
      const char* cur = smem + (j % ns) * sbytes;
      const int ahead = pt + (ns - 1) * split;
      if (ahead < n_pt) stage_pt(smem + ((j + ns - 1) % ns) * sbytes, ahead);
      cp_async_commit();
      cp_async_wait_ring(ns);
      __syncthreads();
      products_at(cur);
      __syncthreads();
    }
  }

  cp_async_wait_all();
  __syncthreads();
  // the holding thread's value e of part p in the reduction buffer
  float* red = reinterpret_cast<float*>(smem);
  const int hold = threadIdx.x % HOLD;
  auto slot = [&](int p, int t, int nf, int e) {
    return ((p * TAPS + t) * 2 + nf) * 4 + e;
  };
  // 1. the WK warps of one fragment pair, in order
  if constexpr (TL::WK > 1) {
    if (wk > 0) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
#pragma unroll
        for (int nf = 0; nf < 2; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[slot(wk - 1, t, nf, e) * HOLD + hold] = acc[t][nf][e];
    }
    __syncthreads();
    if (wk == 0) {
      for (int p = 0; p < TL::WK - 1; ++p)
#pragma unroll
        for (int t = 0; t < TAPS; ++t)
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[t][nf][e] += red[slot(p, t, nf, e) * HOLD + hold];
    }
    __syncthreads();
  }
  // 2. the cluster's ranks, in rank order, through distributed shared memory
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    const int rank = s % cluster;
    if (rank != 0 && wk == 0) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
#pragma unroll
        for (int nf = 0; nf < 2; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[slot(0, t, nf, e) * HOLD + hold] = acc[t][nf][e];
    }
    cl.sync();
    if (rank == 0 && wk == 0) {
      for (int q = 1; q < cluster; ++q) {
        const float* remote = cl.map_shared_rank(red, q);
#pragma unroll
        for (int t = 0; t < TAPS; ++t)
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[t][nf][e] += remote[slot(0, t, nf, e) * HOLD + hold];
      }
    }
    cl.sync();  // the other ranks' shared memory lives until here
    if (rank != 0) return;
  }
  // 3. the groups of clusters, in index order, by the last leader to arrive
  const int groups = split / cluster;
  if (groups > 1) {
    __shared__ int last;
    float* all = partial + (size_t)tile * groups * NACC * HOLD;
    if (wk == 0) {
      float* mine = all + (size_t)(s / cluster) * NACC * HOLD;
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
#pragma unroll
        for (int nf = 0; nf < 2; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mine[slot(0, t, nf, e) * HOLD + hold] = acc[t][nf][e];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&ticket[tile], 1) == groups - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (wk == 0) {
      // group by group, each group's values loaded together (L2, not L1)
      for (int q = 0; q < groups; ++q) {
        const float* p = all + (size_t)q * NACC * HOLD + hold;
#pragma unroll
        for (int t = 0; t < TAPS; ++t)
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = __ldcg(p + slot(0, t, nf, e) * HOLD);
              acc[t][nf][e] = q ? acc[t][nf][e] + v : v;
            }
      }
    }
    if (threadIdx.x == 0) ticket[tile] = 0;
  }
  if (wk != 0) return;
  // c0, c1: output channel gq, input channels 2tq, 2tq+1; c2, c3: gq + 8
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const int ky = ky0 + t / K, kx = t % K;
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + warp_m * 16 + gq + (e >> 1) * 8;
        const int c = c0 + warp_n * 16 + nf * 8 + 2 * tq + (e & 1);
        if (o < O && c < I)
          dw[(((size_t)o * I + c) * K + ky) * K + kx] =
              from_f<OutT>(acc[t][nf][e]);
      }
  }
}

// The instantiated dw tiles, by the index ops/kernels/cf_conv.py::DW_TILES
// gives (WM x WN x WK warps; BO x BC channels): 0: 1x1x4 (16x16), 1: 2x1x2
// (32x16). K = 5 runs tile 0 only (ONLY0).
template <bool ONLY0, class F>
inline int with_dw_tile(int i, F&& f) {
  if (i == 0) return f(DwTile<1, 1, 4>{});
  if constexpr (!ONLY0)
    if (i == 1) return f(DwTile<2, 1, 2>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace conv_mma
