// Fused elastic-gossip + NAG update on the flat parameter plane, for Hopper
// (sm_90a): kernels B1 and B2 (B3 runs B1 on a [1, numel] view).
//
// B1 replaces the Pallas TPU kernel src/repro/kernels/fused_update.py::_flat_kernel
// (wrapper fused_flat_elastic_nag_update). Per element of row w of the
// [W, N] plane, in f32 and in the reference's operation order:
//
//     v'     = mu*v - eta*g
//     theta' = theta - coef*(theta - peer) - eta*g + mu*v'
//
// with (coef, eta, mu) = sc[w, 0..2]. theta and v are written in place.
// Every element's inputs are read before the same thread writes its outputs,
// so peer may alias theta.
//
// The row-list form runs B1 on the rows listed in an int32 device array only
// (the async engine's partial event windows): blockIdx.y indexes the list,
// and a row not listed is neither read nor written. It is the same kernel
// body instantiated with ROWS = true; ROWS = false is the whole-plane kernel.
//
// B2 replaces src/repro/kernels/fused_update.py::_flat_nag_kernel (wrapper
// fused_flat_nag_update): B1 without the peer stream, the non-firing step of
// the dist engine,
//
//     v'     = mu*v - eta*g
//     theta' = theta - eta*g + mu*v'
//
// with (eta, mu) = sc[w, 0..1], in place on theta and v.
//
// Bound: memory bandwidth. B1 moves six streams (read theta/peer/v/g, write
// theta/v) against ~9 flops per element, B2 five streams against 5 flops,
// both below 0.5 flop/byte in f32, far below the card's ridge point. The
// design does nothing but stream: a 2-D grid puts one row per blockIdx.y (so
// a row's scalars are read once per thread and no index is divided), and a
// grid-stride loop over the row's columns with coalesced scalar loads. The
// arithmetic uses the _rn intrinsics, which the compiler does not contract
// into FMAs, so the result rounds exactly as the plain PyTorch version does.
// Tuning the vector width and the grid is later work.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -split-compile=0 -shared
//     -Xcompiler -fPIC
// and called through ctypes (plain C entry points below).

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

template <typename T, typename V, bool ROWS>
__global__ void fused_flat_elastic_nag_kernel(T* theta,
                                              const T* peer,
                                              V* __restrict__ v,
                                              const T* __restrict__ g,
                                              const float* __restrict__ sc,
                                              const int32_t* __restrict__ rows,
                                              int64_t w, int64_t n) {
  // theta and peer are not __restrict__: peer may be theta itself
  int64_t row = blockIdx.y;
  if (ROWS) {
    row = rows[blockIdx.y];
    if (row < 0 || row >= w) return;   // a bad index writes nothing
  }
  const float coef = sc[row * 3 + 0];
  const float eta = sc[row * 3 + 1];
  const float mu = sc[row * 3 + 2];
  const int64_t base = row * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    const int64_t i = base + j;
    const float t = load_f32(theta, i);
    const float p = load_f32(peer, i);
    const float vv = load_f32(v, i);
    const float gg = load_f32(g, i);
    const float eg = __fmul_rn(eta, gg);
    const float v_new = __fsub_rn(__fmul_rn(mu, vv), eg);
    float t_new = __fsub_rn(t, __fmul_rn(coef, __fsub_rn(t, p)));
    t_new = __fsub_rn(t_new, eg);
    t_new = __fadd_rn(t_new, __fmul_rn(mu, v_new));
    store(theta, i, t_new);
    store(v, i, v_new);
  }
}

// B2, one element: (theta', v') from (theta, v, g) in f32
__device__ __forceinline__ void nag_one(float t, float vv, float gg, float eta, float mu,
                                        float* t_new, float* v_new) {
  const float eg = __fmul_rn(eta, gg);
  *v_new = __fsub_rn(__fmul_rn(mu, vv), eg);
  *t_new = __fadd_rn(__fsub_rn(t, eg), __fmul_rn(mu, *v_new));
}

template <typename T, typename V>
__global__ void fused_flat_nag_kernel(T* __restrict__ theta, V* __restrict__ v,
                                      const T* __restrict__ g,
                                      const float* __restrict__ sc, int64_t n) {
  const int64_t row = blockIdx.y;
  const float eta = sc[row * 2 + 0];
  const float mu = sc[row * 2 + 1];
  const int64_t base = row * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    const int64_t i = base + j;
    float t_new, v_new;
    nag_one(load_f32(theta, i), load_f32(v, i), load_f32(g, i), eta, mu, &t_new, &v_new);
    store(theta, i, t_new);
    store(v, i, v_new);
  }
}

// one row per blockIdx.y, about eight blocks per SM over the whole grid
dim3 row_grid(int64_t items, int64_t w, int threads) {
  int64_t blocks = (items + threads - 1) / threads;
  int64_t cap = (132 * 8 + w - 1) / w;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  return dim3((unsigned)blocks, (unsigned)w);
}

template <typename T, typename V>
cudaError_t launch_nag(void* theta, void* v, const void* g, const float* sc, int64_t w,
                       int64_t n, cudaStream_t stream) {
  if (w <= 0 || n <= 0) return cudaSuccess;
  if (w > 65535) return cudaErrorInvalidValue;
  const int threads = 256;
  fused_flat_nag_kernel<T, V><<<row_grid(n, w, threads), threads, 0, stream>>>(
      static_cast<T*>(theta), static_cast<V*>(v), static_cast<const T*>(g), sc, n);
  return cudaGetLastError();
}

// rows == nullptr: every one of the w rows; else the nrows rows listed
template <typename T, typename V>
cudaError_t launch(void* theta, const void* peer, void* v, const void* g,
                   const float* sc, const int32_t* rows, int64_t nrows, int64_t w,
                   int64_t n, cudaStream_t stream) {
  const int64_t grid_rows = rows ? nrows : w;
  if (grid_rows <= 0 || n <= 0) return cudaSuccess;
  if (grid_rows > 65535) return cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid = row_grid(n, grid_rows, threads);
  if (rows) {
    fused_flat_elastic_nag_kernel<T, V, true><<<grid, threads, 0, stream>>>(
        static_cast<T*>(theta), static_cast<const T*>(peer), static_cast<V*>(v),
        static_cast<const T*>(g), sc, rows, w, n);
  } else {
    fused_flat_elastic_nag_kernel<T, V, false><<<grid, threads, 0, stream>>>(
        static_cast<T*>(theta), static_cast<const T*>(peer), static_cast<V*>(v),
        static_cast<const T*>(g), sc, nullptr, w, n);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. rows: nullptr for the whole [w, n]
// plane, else an int32 device array of nrows distinct row indices (a row
// outside [0, w) is skipped). Returns a cudaError_t (0 = success).
extern "C" int repro_fused_flat_elastic_nag(int t_dtype, int v_dtype, void* theta,
                                            const void* peer, void* v, const void* g,
                                            const void* sc, const void* rows,
                                            int64_t nrows, int64_t w, int64_t n,
                                            void* stream) {
  const float* s = static_cast<const float*>(sc);
  const int32_t* r = static_cast<const int32_t*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t_dtype == 0 && v_dtype == 0)
    return (int)launch<float, float>(theta, peer, v, g, s, r, nrows, w, n, st);
  if (t_dtype == 1 && v_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(theta, peer, v, g, s, r, nrows, w, n, st);
  if (t_dtype == 1 && v_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(theta, peer, v, g, s, r, nrows, w, n, st);
  return (int)cudaErrorInvalidValue;
}

// B2. dtype codes as above; sc is [w, 2] f32 (eta, mu). Returns a
// cudaError_t (0 = success).
extern "C" int repro_fused_flat_nag(int t_dtype, int v_dtype, void* theta, void* v,
                                    const void* g, const void* sc, int64_t w, int64_t n,
                                    void* stream) {
  const float* s = static_cast<const float*>(sc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t_dtype == 0 && v_dtype == 0)
    return (int)launch_nag<float, float>(theta, v, g, s, w, n, st);
  if (t_dtype == 1 && v_dtype == 1)
    return (int)launch_nag<__nv_bfloat16, __nv_bfloat16>(theta, v, g, s, w, n, st);
  if (t_dtype == 1 && v_dtype == 0)
    return (int)launch_nag<__nv_bfloat16, float>(theta, v, g, s, w, n, st);
  return (int)cudaErrorInvalidValue;
}
