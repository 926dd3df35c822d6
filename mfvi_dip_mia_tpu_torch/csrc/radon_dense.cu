// The dense-matrix Radon operator for Hopper (sm_90a): the (P, Q) projection
// matrix A stored in bf16, row-major, f32 image / sinogram, f32 accumulation.
//
// Replaces the two Pallas TPU kernels of
// mfvi_dip_mia_tpu/ops/pallas/radon_kernel.py:
//   * radon_dense_fwd <- _fwd_call:  out[c, p] = sum_q A[p, q] * v[c, q]
//   * radon_dense_adj <- _bwd_call:  out[c, q] = sum_p A[p, q] * g[c, p]
// (P = T*W sinogram bins, Q = H*W pixels, c the image columns B*C: 1 in the
// DIP fit). Both stream the SAME row-major A; its transpose (1.51 GB at
// 256^2 / 45 angles) is never formed.
//
// What bounds them on the card: bytes. Each element of A is used once per
// image column at two FLOPs (2 FLOP per 2 bytes of A), so both read A once
// per column (P*Q*2 bytes: 1.51 GB at 256^2 / 45 angles, 0.45 ms at
// 3.35 TB/s). The tensor cores do not help: an MMA needs a second operand
// dimension to reuse A against, and one image column gives it none. The
// design is the card's streaming template:
//   * A persistent grid, two blocks per SM (the wrapper's plan,
//     ops/kernels/radon_dense.py::dense_plan, sized by the card's SM count).
//     Every block streams an equal share of A's bytes: the forward a
//     contiguous range of rows, the adjoint a list of (row range x column
//     strip) tiles. The kernels receive only these bounds.
//   * A reaches shared memory through a ring of kStages stages of kRows x
//     kCols bf16 (16 KB), each filled by 1-D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes, one per row piece: A's
//     rows are contiguous and 16-byte aligned when Q % 8 == 0, so no tensor
//     map is needed). One producer thread issues them with an L2 evict_first
//     policy, so the 1.5 GB stream does not evict the operand every block
//     reuses (v or g, copied with evict_last). Four consumer warps wait on a
//     stage's full barrier, convert bf16 to f32, FMA in f32 and arrive on its
//     empty barrier; no block-wide barrier fences the stream. The producer
//     fences the async proxy after each empty wait (bulk_copy.cuh::
//     fence_proxy_async): without it an adjoint launch at 3 image columns
//     now and then refilled a stage a consumer was still reading.
//   * Forward: a block walks its rows in tiles of <= kRows rows (its row
//     range cut as evenly as kRows allows); each stage holds kCols columns of
//     the tile's rows and the same columns of v (also by bulk copy, read once
//     per tile of rows, so its traffic is 1/4 of A's). Each warp owns
//     kRows / 4 rows of the tile, each lane one f32 partial per row, and the
//     warp sums a row with a fixed shuffle tree.
//   * Adjoint, one launch: a consumer thread owns 8 columns of its tile's
//     strip and sums them over the tile's rows in row order. Each stage
//     also holds its rows of g, bulk-copied in a 16-byte-aligned window:
//     the ring leaves L1 little room, so a plain load of g waits on L2. A
//     whole stage is read into registers and released before its FMAs.
//     A strip cut into several tiles ("splits") stores each split's f32
//     partial to scratch; the last block to finish the strip (a ticket
//     counter it resets for the next launch) sums the splits in split order
//     and stores out. No float atomics.
// Every sum has a fixed order, independent of timing: two launches give the
// same bits. Image columns take one pass over A each, in order, in the same
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "bulk_copy.cuh"
#include "conv_tile.cuh"

namespace {

using namespace bulk_copy;

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;  // threads that compute
constexpr int kThreads = kConsumers + 32;        // and one producer warp
constexpr int kStages = 4;                       // depth of the ring
constexpr int kRows = 8;                         // rows of A per stage
constexpr int kCols = 8 * kConsumers;            // columns of A per stage
constexpr int kRowsPerWarp = kRows / kConsumerWarps;  // forward
constexpr int kSumBatch = 4;                     // adjoint: splits summed per batch
constexpr int kBarBytes = 128;                   // the barriers (and the
                                                 // adjoint's flag), then the ring
constexpr int kStageA = kRows * kCols * 2;       // bytes of A per stage
// The forward's stages also hold kCols floats of v; the adjoint's the
// 16-byte-aligned window of g around the stage's kRows rows (<= 16 floats).
constexpr int kStageFwd = kStageA + kCols * 4;
constexpr int kStageAdj = kStageA + 16 * 4;
constexpr int kFwdSmem = kBarBytes + kStages * kStageFwd;  // dynamic shared
constexpr int kAdjSmem = kBarBytes + kStages * kStageAdj;  // memory of a launch

// The ring's barriers: full[s] completes when stage s's bytes have landed
// (the producer's one arrival with its byte count), empty[s] when every
// consumer thread has read it.
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (kStages + s);
}

__device__ __forceinline__ void ring_init(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full_bar(bars, s), 1);
      bar_init(empty_bar(bars, s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A position in the ring: the stage, and the parity of its barriers' phase
// (the producer waits for the stage to be empty, a consumer for it to be
// full).
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void producer_acquire(uint32_t bars, const RingPos& at,
                                                 uint32_t bytes) {
  bar_wait(empty_bar(bars, at.s), at.phase ^ 1);
  // the consumers' reads of the stage before the copies that overwrite it
  fence_proxy_async();
  bar_expect_tx(full_bar(bars, at.s), bytes);
}

__device__ __forceinline__ void consumers_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Tile t of n_tiles over the n rows from r: rows [t0, t1), as even as can be.
__device__ __forceinline__ void tile_rows(int r, int n, int n_tiles, int t, int& t0,
                                          int& t1) {
  t0 = r + (int)((long long)n * t / n_tiles);
  t1 = r + (int)((long long)n * (t + 1) / n_tiles);
}

// grid (blocks); block b owns rows [rows[b], rows[b + 1]) of A, for each
// image column in turn. v (cols, Q), out (cols, P); Q % 8 == 0; dynamic
// shared memory kFwdSmem.
__global__ void __launch_bounds__(kThreads, 2)
radon_dense_fwd_kernel(const __nv_bfloat16* __restrict__ a, const float* __restrict__ v,
                       float* __restrict__ out, const int* __restrict__ rows, int P,
                       int Q, int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = smem + kBarBytes;
  const int r_begin = rows[blockIdx.x];
  const int n_rows = rows[blockIdx.x + 1] - r_begin;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int n_chunks = (Q + kCols - 1) / kCols;
  ring_init(bars);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kConsumerWarps) {  // the producer
    if (lane != 0) return;
    const uint64_t stream = l2_evict_first(), keep = l2_evict_last();
    RingPos at;
    for (int c = 0; c < cols; ++c) {
      for (int t = 0; t < n_tiles; ++t) {
        int r0, r1;
        tile_rows(r_begin, n_rows, n_tiles, t, r0, r1);
        for (int j = 0; j < n_chunks; ++j, at.next()) {
          const int q0 = j * kCols, w = min(kCols, Q - q0);
          producer_acquire(bars, at, (uint32_t)((r1 - r0) * w * 2 + w * 4));
          const uint32_t dst = smem_u32(ring + at.s * kStageFwd);
          const uint32_t full = full_bar(bars, at.s);
          for (int r = r0; r < r1; ++r)
            bulk_load(dst + (r - r0) * kCols * 2, a + (size_t)r * Q + q0, w * 2, full, stream);
          bulk_load(dst + kStageA, v + (size_t)c * Q + q0, w * 4, full, keep);
        }
      }
    }
    return;
  }

  RingPos at;
  const int i0 = warp * kRowsPerWarp;  // this warp's first row in a tile
  for (int c = 0; c < cols; ++c) {
    for (int t = 0; t < n_tiles; ++t) {
      int r0, r1;
      tile_rows(r_begin, n_rows, n_tiles, t, r0, r1);
      float acc[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) acc[k] = 0.f;
      for (int j = 0; j < n_chunks; ++j, at.next()) {
        const int w = min(kCols, Q - j * kCols);
        bar_wait(full_bar(bars, at.s), at.phase);
        const unsigned char* stage = ring + at.s * kStageFwd;
        const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(stage);
        const float* sv = reinterpret_cast<const float*>(stage + kStageA);
#pragma unroll
        for (int x0 = 0; x0 < kCols; x0 += 32 * 8) {
          const int x = x0 + lane * 8;
          if (x < w) {
            const float4 b0 = *reinterpret_cast<const float4*>(sv + x);
            const float4 b1 = *reinterpret_cast<const float4*>(sv + x + 4);
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int k = 0; k < kRowsPerWarp; ++k) {
              float av[8];
              load8(sa + (i0 + k) * kCols + x, av);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[k] = fmaf(av[e], b[e], acc[k]);
            }
          }
        }
        bar_arrive(empty_bar(bars, at.s));
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const float sum = conv_tile::warp_sum(acc[k]);
        const int r = r0 + i0 + k;
        if (lane == 0 && r < r1) out[(size_t)c * P + r] = sum;
      }
    }
  }
}

// grid (blocks); plan = [tile_ptr (blocks + 1) | tiles (n_tiles x 5)]: block b
// owns tiles tile_ptr[b] ... tile_ptr[b + 1] - 1, each (strip, p0, p1, split,
// n_split): rows [p0, p1) of columns [strip * strip_w, +strip_w) of A, split
// `split` of the strip's n_split, in row order; for each image column in
// turn. g (cols, P), out (cols, Q); partial (cols, n_tiles, strip_w) f32
// scratch; ticket: one int per (image column, strip), zero before and
// after. Q % 8 == 0, strip_w % 8 == 0, strip_w <= kCols; g 16-byte aligned
// and readable up to cols * P rounded up to 4 floats; dynamic shared memory
// kAdjSmem.
__global__ void __launch_bounds__(kThreads, 2)
radon_dense_adj_kernel(const __nv_bfloat16* __restrict__ a, const float* __restrict__ g,
                       float* __restrict__ partial, int* __restrict__ ticket,
                       float* __restrict__ out, const int* __restrict__ plan, int P, int Q,
                       int cols, int strip_w, int n_tiles, int n_strips) {
  extern __shared__ __align__(128) unsigned char smem[];
  int& last = *reinterpret_cast<int*>(smem + 16 * kStages);  // after the barriers
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = smem + kBarBytes;
  const int t_begin = plan[blockIdx.x], t_end = plan[blockIdx.x + 1];
  const int* tiles = plan + gridDim.x + 1;
  ring_init(bars);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x != kConsumers) return;
    const uint64_t stream = l2_evict_first(), keep = l2_evict_last();
    RingPos at;
    for (int c = 0; c < cols; ++c) {
      for (int t = t_begin; t < t_end; ++t) {
        const int* tl = tiles + 5 * t;
        const int q0 = tl[0] * strip_w, w = min(strip_w, Q - q0);
        for (int p = tl[1]; p < tl[2]; p += kRows, at.next()) {
          const int nr = min(kRows, tl[2] - p);
          // g[c, p ... p + nr) within whole 16-byte pieces
          const size_t f = (size_t)c * P + p, lo = f & ~(size_t)3;
          const uint32_t g_bytes = (uint32_t)(((f + nr + 3) & ~(size_t)3) - lo) * 4;
          producer_acquire(bars, at, (uint32_t)(nr * w * 2) + g_bytes);
          const uint32_t dst = smem_u32(ring + at.s * kStageAdj);
          const uint32_t full = full_bar(bars, at.s);
          for (int i = 0; i < nr; ++i)
            bulk_load(dst + i * kCols * 2, a + (size_t)(p + i) * Q + q0, w * 2, full, stream);
          bulk_load(dst + kStageA, g + lo, g_bytes, full, keep);
        }
      }
    }
    return;
  }

  const int x = threadIdx.x * 8;  // this thread's 8 columns of the strip
  RingPos at;
  for (int c = 0; c < cols; ++c) {
    for (int t = t_begin; t < t_end; ++t) {
      const int* tl = tiles + 5 * t;
      const int strip = tl[0], split = tl[3], n_split = tl[4];
      const int q0 = strip * strip_w, w = min(strip_w, Q - q0);
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      for (int p = tl[1]; p < tl[2]; p += kRows, at.next()) {
        const int nr = min(kRows, tl[2] - p);
        bar_wait(full_bar(bars, at.s), at.phase);
        const unsigned char* stage = ring + at.s * kStageAdj;
        bool released = false;
        if (x < w) {
          const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(stage);
          // row p of column c in its window of g
          const float* sg = reinterpret_cast<const float*>(stage + kStageA) +
                            (int)(((size_t)c * P + p) & 3);
          if (nr == kRows) {
            // a whole stage: its A and g into registers, the stage released,
            // then the FMAs
            float av[kRows][8], gv[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) load8(sa + i * kCols + x, av[i]);
#pragma unroll
            for (int i = 0; i < kRows; ++i) gv[i] = sg[i];
            bar_arrive(empty_bar(bars, at.s));
            released = true;
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[e] = fmaf(av[i][e], gv[i], acc[e]);
          } else {
            for (int i = 0; i < nr; ++i) {
              float av[8];
              load8(sa + i * kCols + x, av);
              const float gi = sg[i];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[e] = fmaf(av[e], gi, acc[e]);
            }
          }
        }
        if (!released) bar_arrive(empty_bar(bars, at.s));
      }

      if (n_split > 1) {
        // this split's partial, then the last block of the strip sums them
        if (x < w) store8(partial + ((size_t)c * n_tiles + t) * strip_w + x, acc);
        __threadfence();
        consumers_barrier();
        int* tk = ticket + c * n_strips + strip;
        if (threadIdx.x == 0) last = atomicAdd(tk, 1) == n_split - 1;
        consumers_barrier();
        if (!last) continue;
        __threadfence();
        if (x < w) {
          const float* src = partial + ((size_t)c * n_tiles + t - split) * strip_w + x;
          // kSumBatch splits' loads in flight at once (this sum ends the
          // strip's last block's work on it), added in split order
          for (int k0 = 0; k0 < n_split; k0 += kSumBatch) {
            float4 u[kSumBatch][2];
#pragma unroll
            for (int k = 0; k < kSumBatch; ++k)
              if (k0 + k < n_split) {
                const float* sk = src + (size_t)(k0 + k) * strip_w;
                u[k][0] = __ldcg(reinterpret_cast<const float4*>(sk));
                u[k][1] = __ldcg(reinterpret_cast<const float4*>(sk + 4));
              }
#pragma unroll
            for (int k = 0; k < kSumBatch; ++k)
              if (k0 + k < n_split) {
                const float v[8] = {u[k][0].x, u[k][0].y, u[k][0].z, u[k][0].w,
                                    u[k][1].x, u[k][1].y, u[k][1].z, u[k][1].w};
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[e] = k0 + k ? acc[e] + v[e] : v[e];
              }
          }
        }
        if (threadIdx.x == 0) *tk = 0;
      }
      if (x < w) store8(out + (size_t)c * Q + q0 + x, acc);
    }
  }
}

// The kernel's dynamic shared memory limit, raised once to what it needs
// (under a mutex: host threads launch concurrently).
int allow_smem(const void* kern, int smem, bool& allowed) {
  static std::mutex mu;
  std::lock_guard<std::mutex> hold(mu);
  if (allowed) return 0;
  const int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err) allowed = true;
  return err;
}

}  // namespace

extern "C" {

// a (P, Q) bf16 with Q % 8 == 0; v (cols, Q) f32 -> out (cols, P) f32;
// rows: blocks + 1 row bounds (ops/kernels/radon_dense.py::dense_plan).
int radon_dense_fwd(const void* a, const float* v, float* out, const int* rows, int P,
                    int Q, int cols, int blocks, void* stream) {
  static bool allowed = false;
  if (Q % 8 || cols < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  int err = allow_smem((const void*)radon_dense_fwd_kernel, kFwdSmem, allowed);
  if (err) return err;
  radon_dense_fwd_kernel<<<blocks, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), v, out, rows, P, Q, cols);
  return (int)cudaGetLastError();
}

// a (P, Q) bf16 with Q % 8 == 0; g (cols, P) f32 -> out (cols, Q) f32; plan,
// partial and ticket as radon_dense_adj_kernel takes them.
int radon_dense_adj(const void* a, const float* g, float* partial, int* ticket, float* out,
                    const int* plan, int P, int Q, int cols, int blocks, int strip_w,
                    int n_tiles, int n_strips, void* stream) {
  static bool allowed = false;
  if (Q % 8 || strip_w % 8 || strip_w > kCols || cols < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  int err = allow_smem((const void*)radon_dense_adj_kernel, kAdjSmem, allowed);
  if (err) return err;
  radon_dense_adj_kernel<<<blocks, kThreads, kAdjSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), g, partial, ticket, out, plan, P, Q, cols,
      strip_w, n_tiles, n_strips);
  return (int)cudaGetLastError();
}

}  // extern "C"
