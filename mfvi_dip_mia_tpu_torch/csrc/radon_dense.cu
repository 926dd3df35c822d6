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
// column at two FLOPs, so both read A once (P*Q*2 bytes: 1.51 GB at 256^2 /
// 45 angles, 0.45 ms at 3.35 TB/s). Both read it as 16-byte vectors (8 bf16),
// neighbouring lanes on neighbouring addresses, and neither uses atomics:
//   * forward: a block owns 32 rows of A (4 per warp) and walks Q in chunks
//     whose v values it stages in shared memory; each lane keeps one f32
//     partial per row and the warp sums them with a fixed shuffle tree. The
//     v chunk is read once per 32 rows, so its traffic is 1/16 of A's.
//   * adjoint: a block owns a strip of 2,048 q columns (8 per thread) and one
//     chunk of P, with that chunk of g in shared memory; the chunks' f32
//     partials are summed in a fixed order by a second kernel.
// One image column per grid z: each column streams A once more, which the
// DIP fit (one column) never pays.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows of A per forward block
constexpr int kQChunk = 2048;                 // v values staged per pass
constexpr int kStrip = kThreads * 8;          // q columns per adjoint block

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

// grid (ceil(P / kRows), cols); v (cols, Q), out (cols, P); Q % 8 == 0.
__global__ void __launch_bounds__(kThreads)
radon_dense_fwd_kernel(const __nv_bfloat16* __restrict__ a, const float* __restrict__ v,
                       float* __restrict__ out, int P, int Q) {
  __shared__ __align__(16) float vs[kQChunk];
  const int col = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows + warp * kRowsPerWarp;
  const float* vc = v + (size_t)col * Q;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kQChunk) {
    const int n = min(kQChunk, Q - q0);
    __syncthreads();
    for (int i = threadIdx.x * 4; i < n; i += kThreads * 4)
      *reinterpret_cast<float4*>(&vs[i]) = *reinterpret_cast<const float4*>(&vc[q0 + i]);
    __syncthreads();
#pragma unroll 2
    for (int q = lane * 8; q < n; q += 32 * 8) {
      const float4 b0 = *reinterpret_cast<const float4*>(&vs[q]);
      const float4 b1 = *reinterpret_cast<const float4*>(&vs[q + 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (r0 + r < P) {
          float av[8];
          load8(a + (size_t)(r0 + r) * Q + q0 + q, av);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r] = fmaf(av[k], b[k], acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float s = conv_tile::warp_sum(acc[r]);
    if (lane == 0 && r0 + r < P) out[(size_t)col * P + r0 + r] = s;
  }
}

// grid (ceil(Q / kStrip), n_split, cols); dynamic shared memory rows_per_split
// floats. partial[(c * n_split + s) * Q + q] = sum over split s's rows of
// A[p, q] * g[c, p].
__global__ void __launch_bounds__(kThreads)
radon_dense_adj_partial_kernel(const __nv_bfloat16* __restrict__ a,
                               const float* __restrict__ g, float* __restrict__ partial,
                               int P, int Q, int rows_per_split) {
  extern __shared__ float gs[];
  const int split = blockIdx.y;
  const int col = blockIdx.z;
  const int n_split = gridDim.y;
  const int p_begin = split * rows_per_split;
  const int p_end = min(P, p_begin + rows_per_split);
  for (int p = p_begin + threadIdx.x; p < p_end; p += kThreads)
    gs[p - p_begin] = g[(size_t)col * P + p];
  __syncthreads();

  const int q = blockIdx.x * kStrip + threadIdx.x * 8;
  if (q >= Q) return;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const __nv_bfloat16* ap = a + (size_t)p_begin * Q + q;
#pragma unroll 4
  for (int p = p_begin; p < p_end; ++p, ap += Q) {
    float av[8];
    load8(ap, av);
    const float s = gs[p - p_begin];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = fmaf(av[k], s, acc[k]);
  }
  float* dst = partial + ((size_t)col * n_split + split) * Q + q;
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// out[c * Q + q] = sum_s partial[(c * n_split + s) * Q + q], in split order.
__global__ void __launch_bounds__(kThreads)
radon_dense_adj_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                              int Q, int n_split, int cols) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)Q * cols) return;
  const size_t col = idx / Q;
  const size_t q = idx - col * Q;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += partial[(col * n_split + k) * Q + q];
  out[idx] = s;
}

}  // namespace

extern "C" {

// a (P, Q) bf16 with Q % 8 == 0; v (cols, Q) f32 -> out (cols, P) f32.
int radon_dense_fwd(const void* a, const float* v, float* out, int P, int Q, int cols,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q % 8) return (int)cudaErrorInvalidValue;
  dim3 grid((P + kRows - 1) / kRows, cols);
  radon_dense_fwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a), v, out, P, Q);
  return (int)cudaGetLastError();
}

// a (P, Q) bf16 with Q % 8 == 0; g (cols, P) f32; partial (cols, n_split, Q)
// f32 scratch -> out (cols, Q) f32.
int radon_dense_adj(const void* a, const float* g, float* partial, float* out, int P,
                    int Q, int cols, int n_split, int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows_per_split * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        radon_dense_adj_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  dim3 grid((Q + kStrip - 1) / kStrip, n_split, cols);
  radon_dense_adj_partial_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a), g, partial, P, Q, rows_per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t n = (size_t)Q * cols;
  radon_dense_adj_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                                  st>>>(partial, out, Q, n_split, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
