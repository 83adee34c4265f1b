// Robust-gossip displacement apply on the flat parameter plane, for Hopper
// (sm_90a): kernel B8.
//
// Replaces the Pallas TPU kernel src/repro/kernels/robust.py::_robust_kernel
// (wrapper robust_flat_apply). Per element of row w of the [W, N] plane, in
// f32 and in the reference's operation order:
//
//     keep   = (|delta| <= thr) ? 1 : 0
//     theta' = theta + scale * (delta * keep)
//
// with (scale, thr) = sc[w, 0..1]. keep is MULTIPLIED, not selected: a
// trimmed inf or NaN in delta gives NaN (inf * 0), and a trimmed coordinate
// adds +0.0 (so theta = -0.0 becomes +0.0), as the reference computes.
// theta is float32 or bfloat16 (the output has its type, bf16 rounded to
// nearest even); delta is always float32. The output is a separate buffer:
// the caller still needs theta for the optimizer update that follows. Each
// of out, theta and delta has its own leading dimension (elements between
// rows), so the partitioned mixing can pass the column slices x[:, lo:hi] of
// a [W, total] plane and write into the same slice of its output, no copy.
//
// Bound: memory bandwidth. Three streams (read theta and delta, write
// theta') against 4 flops per element, about 0.33 flop/byte in f32. The
// design only streams: one row per blockIdx.y (the row's two scalars are
// read once per thread), a grid-stride loop over the row, and 16-byte
// accesses (four elements per thread per iteration) when every row of every
// operand starts 16-byte aligned (pointers and leading dimensions), which
// the wrapper checks; otherwise scalar accesses. A chunk whose column offset
// is not a multiple of four takes the scalar kernel. The
// arithmetic uses the _rn intrinsics, which the compiler does not contract
// into FMAs, so the result equals the plain PyTorch version bit for bit.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -split-compile=0 -shared
//     -Xcompiler -fPIC
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// four consecutive elements starting at i (i a multiple of 4, 16-byte or
// 8-byte aligned by the wrapper's check)
__device__ __forceinline__ void load4(const float* p, int64_t i, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int64_t i, float v[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p + i);
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, int64_t i, const float v[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<const unsigned int*>(&lo);
  a.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p + i) = a;
}

__device__ __forceinline__ float robust_one(float t, float d, float scale, float thr) {
  const float keep = (fabsf(d) <= thr) ? 1.0f : 0.0f;
  return __fadd_rn(t, __fmul_rn(scale, __fmul_rn(d, keep)));
}

// ld_o, ld_t, ld_d: the leading dimensions of out, theta and delta
template <typename T>
__global__ void robust_flat_apply_kernel(T* __restrict__ out,
                                         const T* __restrict__ theta,
                                         const float* __restrict__ delta,
                                         const float* __restrict__ sc,
                                         int64_t n, int64_t ld_o, int64_t ld_t,
                                         int64_t ld_d) {
  const int64_t row = blockIdx.y;
  const float scale = sc[row * 2 + 0];
  const float thr = sc[row * 2 + 1];
  T* o_row = out + row * ld_o;
  const T* t_row = theta + row * ld_t;
  const float* d_row = delta + row * ld_d;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    store(o_row, j, robust_one(load_f32(t_row, j), d_row[j], scale, thr));
  }
}

// n % 4 == 0 and every row of every operand 16-byte aligned (8-byte for bf16
// theta/out)
template <typename T>
__global__ void robust_flat_apply_vec4_kernel(T* __restrict__ out,
                                              const T* __restrict__ theta,
                                              const float* __restrict__ delta,
                                              const float* __restrict__ sc,
                                              int64_t n, int64_t ld_o, int64_t ld_t,
                                              int64_t ld_d) {
  const int64_t row = blockIdx.y;
  const float scale = sc[row * 2 + 0];
  const float thr = sc[row * 2 + 1];
  T* o_row = out + row * ld_o;
  const T* t_row = theta + row * ld_t;
  const float* d_row = delta + row * ld_d;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n4; j += stride) {
    const int64_t i = 4 * j;
    float t[4], d[4], o[4];
    load4(t_row, i, t);
    load4(d_row, i, d);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = robust_one(t[e], d[e], scale, thr);
    store4(o_row, i, o);
  }
}

template <typename T>
cudaError_t launch(void* out, const void* theta, const float* delta, const float* sc,
                   int64_t w, int64_t n, int64_t ld_o, int64_t ld_t, int64_t ld_d,
                   int vec4, cudaStream_t stream) {
  if (w <= 0 || n <= 0) return cudaSuccess;
  if (w > 65535) return cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t items = vec4 ? n / 4 : n;
  int64_t blocks = (items + threads - 1) / threads;
  // about eight blocks per SM over the whole grid; rows share them
  int64_t cap = (132 * 8 + w - 1) / w;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  dim3 grid((unsigned)blocks, (unsigned)w);
  if (vec4) {
    robust_flat_apply_vec4_kernel<T><<<grid, threads, 0, stream>>>(
        static_cast<T*>(out), static_cast<const T*>(theta), delta, sc, n, ld_o, ld_t, ld_d);
  } else {
    robust_flat_apply_kernel<T><<<grid, threads, 0, stream>>>(
        static_cast<T*>(out), static_cast<const T*>(theta), delta, sc, n, ld_o, ld_t, ld_d);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (theta and out); delta and sc are
// float32. ld_o / ld_t / ld_d: elements between consecutive rows of out,
// theta and delta (n for contiguous [w, n] rows). vec4 != 0 selects the
// 16-byte path (the caller checked n % 4, the pointers and the leading
// dimensions). Returns a cudaError_t (0 = success).
extern "C" int repro_robust_flat_apply(int t_dtype, void* out, const void* theta,
                                       const void* delta, const void* sc, int64_t w,
                                       int64_t n, int64_t ld_o, int64_t ld_t, int64_t ld_d,
                                       int vec4, void* stream) {
  const float* d = static_cast<const float*>(delta);
  const float* s = static_cast<const float*>(sc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t_dtype == 0) return (int)launch<float>(out, theta, d, s, w, n, ld_o, ld_t, ld_d, vec4, st);
  if (t_dtype == 1)
    return (int)launch<__nv_bfloat16>(out, theta, d, s, w, n, ld_o, ld_t, ld_d, vec4, st);
  return (int)cudaErrorInvalidValue;
}
