// Block-banded Radon forward and adjoint for Hopper (sm_90a): f32 or bf16
// band storage, f32 image / sinogram, f32 accumulation.
//
// Replaces the two Pallas TPU kernels of
// mfvi_dip_mia_tpu/ops/pallas/radon_banded.py:
//   * radon_fwd <- _fwd_call:
//       sino[t*W + jlo[t*G+g] + r, c] += sum_p B[g, t, r, p] * v[c, g*pp + p]
//   * radon_adj <- _bwd_call:
//       grad[c, g*pp + p] += sum_{t, r} B[g, t, r, p] * gs[t*W + jlo + r, c]
// with the band B stored (G, T_pad/tchunk, tchunk*jwin, pp), i.e. row
// ((g * T_pad + t) * jwin + r) of pp contiguous values.
//
// What bounds them on the card: bytes. Each band element is used once per
// image column (cols == 1 for the DIP fit), so both kernels stream the band
// (188.7 MB bf16 at 256^2 / 45 angles / patch 16) at two FLOPs per element;
// their bound is the band's bytes over the card's memory bandwidth. Both
// read it as 16-byte vectors, neighbouring lanes on neighbouring addresses,
// and neither uses atomics:
//   * forward: blocks own (angle, chunk of patches); each warp accumulates
//     its band rows into a private sinogram row in shared memory, the warps'
//     rows are summed in a fixed order into an f32 scratch, and a second
//     kernel sums the patch chunks per sinogram bin (deterministic);
//   * adjoint: one block per patch owns its pp output pixels, stages every
//     angle's jwin-row cotangent window in shared memory, and its warps split
//     the (angle, row) pairs; their per-pixel sums meet in shared memory in a
//     fixed order. No transpose of the band is ever formed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
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

// grid (t_pad, n_gc, cols); dynamic shared memory kWarps * W floats.
// partial[((c * n_gc + gc) * t_pad + t) * W + j]
template <typename T>
__global__ void __launch_bounds__(kThreads)
radon_fwd_partial_kernel(const T* __restrict__ blocks, const int* __restrict__ jlo,
                         const float* __restrict__ v, float* __restrict__ partial,
                         int G, int t_pad, int jwin, int pp, int W, int gchunk) {
  extern __shared__ float rows[];
  const int t = blockIdx.x;
  const int gc = blockIdx.y;
  const int col = blockIdx.z;
  const int n_gc = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* my = rows + warp * W;
  for (int j = lane; j < W; j += 32) my[j] = 0.f;
  __syncwarp();

  const int n_chunks = pp / 8;
  const float* vc = v + (size_t)col * G * pp;
  const int g_begin = gc * gchunk;
  const int g_end = min(G, g_begin + gchunk);
  for (int g = g_begin; g < g_end; ++g) {
    const T* band = blocks + ((size_t)g * t_pad + t) * jwin * pp;
    const float* vg = vc + (size_t)g * pp;
    const int lo = jlo[t * G + g];
    for (int r = warp; r < jwin; r += kWarps) {
      const T* row = band + (size_t)r * pp;
      float s = 0.f;
      for (int c = lane; c < n_chunks; c += 32) {
        float a[8], b[8];
        load8(row + c * 8, a);
        load8(vg + c * 8, b);
#pragma unroll
        for (int k = 0; k < 8; ++k) s = fmaf(a[k], b[k], s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) my[lo + r] += s;
    }
  }
  __syncthreads();
  float* dst = partial + (((size_t)col * n_gc + gc) * t_pad + t) * W;
  for (int j = threadIdx.x; j < W; j += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += rows[k * W + j];
    dst[j] = s;
  }
}

// out[(t*W + j) * cols + c] = sum_gc partial[((c * n_gc + gc) * t_pad * W) + t*W + j]
__global__ void __launch_bounds__(kThreads)
radon_fwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                        int n_gc, int n_rows, int cols) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * cols) return;
  const int row = idx / cols;
  const int col = idx - row * cols;
  float s = 0.f;
  for (int gc = 0; gc < n_gc; ++gc) s += partial[((size_t)col * n_gc + gc) * n_rows + row];
  out[idx] = s;
}

// grid (G, cols); dynamic shared memory (t_pad * jwin + kWarps * pp) floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
radon_adj_kernel(const T* __restrict__ blocks, const int* __restrict__ jlo,
                 const float* __restrict__ gs, float* __restrict__ out, int G,
                 int t_pad, int jwin, int pp, int W, int cols) {
  extern __shared__ float sm[];
  float* win = sm;                  // [t_pad * jwin]
  float* red = sm + t_pad * jwin;   // [kWarps][pp]
  const int g = blockIdx.x;
  const int col = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_rows = t_pad * jwin;
  for (int idx = threadIdx.x; idx < n_rows; idx += kThreads) {
    const int t = idx / jwin;
    const int r = idx - t * jwin;
    win[idx] = gs[((size_t)t * W + jlo[t * G + g] + r) * cols + col];
  }
  __syncthreads();

  const int n_chunks = pp / 8;
  const T* band = blocks + (size_t)g * t_pad * jwin * pp;  // rows t * jwin + r
  for (int c = lane; c < n_chunks; c += 32) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int tr = warp; tr < n_rows; tr += kWarps) {
      float a[8];
      load8(band + (size_t)tr * pp + c * 8, a);
      const float s = win[tr];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(a[k], s, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) red[warp * pp + c * 8 + k] = acc[k];
  }
  __syncthreads();
  float* dst = out + (size_t)col * G * pp + (size_t)g * pp;
  for (int p = threadIdx.x; p < pp; p += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k * pp + p];
    dst[p] = s;
  }
}

template <typename K>
int smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int fwd(const void* blocks, const int* jlo, const float* v, float* partial,
        float* out, int G, int t_pad, int jwin, int pp, int W, int cols,
        int gchunk, cudaStream_t st) {
  const int n_gc = (G + gchunk - 1) / gchunk;
  const size_t smem = (size_t)kWarps * W * sizeof(float);
  int err = smem_attr(radon_fwd_partial_kernel<T>, smem);
  if (err) return err;
  radon_fwd_partial_kernel<T><<<dim3(t_pad, n_gc, cols), kThreads, smem, st>>>(
      static_cast<const T*>(blocks), jlo, v, partial, G, t_pad, jwin, pp, W, gchunk);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = t_pad * W * cols;
  radon_fwd_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partial, out, n_gc, t_pad * W, cols);
  return (int)cudaGetLastError();
}

template <typename T>
int adj(const void* blocks, const int* jlo, const float* gs, float* out, int G,
        int t_pad, int jwin, int pp, int W, int cols, cudaStream_t st) {
  const size_t smem = ((size_t)t_pad * jwin + (size_t)kWarps * pp) * sizeof(float);
  const int err = smem_attr(radon_adj_kernel<T>, smem);
  if (err) return err;
  radon_adj_kernel<T><<<dim3(G, cols), kThreads, smem, st>>>(
      static_cast<const T*>(blocks), jlo, gs, out, G, t_pad, jwin, pp, W, cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of the band: 0 = float32, 1 = bfloat16. v (cols, G*pp) f32;
// partial (cols, ceil(G/gchunk), t_pad*W) f32 scratch; out (t_pad*W, cols) f32.
int radon_banded_fwd(const void* blocks, const int* jlo, const float* v,
                     float* partial, float* out, int dtype, int G, int t_pad,
                     int jwin, int pp, int W, int cols, int gchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(blocks, jlo, v, partial, out, G, t_pad, jwin, pp, W, cols, gchunk, st);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(blocks, jlo, v, partial, out, G, t_pad, jwin, pp, W, cols,
                              gchunk, st);
  return (int)cudaErrorInvalidValue;
}

// gs (t_pad*W, cols) f32 -> out (cols, G*pp) f32.
int radon_banded_adj(const void* blocks, const int* jlo, const float* gs, float* out,
                     int dtype, int G, int t_pad, int jwin, int pp, int W, int cols,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return adj<float>(blocks, jlo, gs, out, G, t_pad, jwin, pp, W, cols, st);
  if (dtype == 1)
    return adj<__nv_bfloat16>(blocks, jlo, gs, out, G, t_pad, jwin, pp, W, cols, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
