// Gossip-compression codec kernels on the flat parameter plane, for Hopper
// (sm_90a): B4 q8 encode, B5 q8 decode, B6 top-k encode, B7 top-k decode.
//
// Replace the Pallas TPU kernels of src/repro/kernels/codec.py:
//   B4 _q8_encode_kernel   (wrapper q8_encode)
//   B5 _q8_decode_kernel   (wrapper q8_decode)
//   B6 _topk_encode_kernel (wrapper topk_encode)
//   B7 _topk_decode_kernel (wrapper topk_decode)
// Each computes what its TPU kernel computes on a [W, n] f32 bucket cut into
// codec blocks of `block` elements (nb = ceil(n / block); the tail of the
// last block reads as zeros). One thread block per (codec block j, row w):
// grid (nb, W), blockIdx.x = j, blockIdx.y = w.
//
// Bound: memory bandwidth for B4, B5 and B7 (one read and one write of the
// plane, a few operations per element). B6 ranks every element of a block
// against every other in shared memory, O(block^2) comparisons (cut short
// once an element's rank reaches k), so at block 512 it is bound by those
// operations, not by its bytes. A selection that scales better is later
// work.
//
// Exactness: the outputs equal the plain PyTorch versions bit for bit.
//   - The rounding noise is the reference's uint32 hash, computed in
//     uint32_t, which wraps as jnp's uint32 does.
//   - scale = amax * f32(1/127) with the constant written as the f32
//     rounding of the double 1/127 (as jnp.float32(1.0 / 127.0)).
//   - x / scale is an IEEE division (__fdiv_rn); an approximate divide would
//     flip int8 values. All float arithmetic uses _rn intrinsics, which the
//     compiler does not contract into FMAs.
//   - Top-k order: descending magnitude, ties to the lowest index, which is
//     the order of lax.top_k and of the Pallas argmax loop. Inputs are
//     assumed finite: NaN ordering is not matched.
//   - Top-k decode sums each column's pairs from +0.0f in pair order, as the
//     Pallas kernel's fori_loop does, so a kept -0.0 decodes to +0.0.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end). Every entry
// point returns a cudaError_t (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 128;   // a codec block is a multiple of 128
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr int64_t kMaxRows = 65535;  // gridDim.y
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float stochastic_uniform(uint32_t idx, uint32_t seed) {
  uint32_t x = idx ^ seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  // top 24 bits -> [0, 1): both factors exact, the product exact
  return __fmul_rn((float)(x >> 8), 1.0f / 16777216.0f);
}

// Max over the thread block of a non-negative value; every thread gets it.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// B4: per block, scale = amax/127 (1 where amax = 0) and
// q = clip(floor(x / scale + u), -127, 127), u = hash(j*block + lane, seed[w]).
// values: int8 [W, nb*block] (padded lanes written too), scales: f32 [W, nb].
__global__ void q8_encode_kernel(const float* __restrict__ x,
                                 const int64_t* __restrict__ seeds,
                                 int8_t* __restrict__ values,
                                 float* __restrict__ scales,
                                 int64_t n, int64_t block, int64_t nb) {
  __shared__ float red[32];
  const int64_t j = blockIdx.x, w = blockIdx.y;
  const float* xr = x + w * n;
  const int64_t c0 = j * block;
  float amax = 0.0f;
  for (int64_t l = threadIdx.x; l < block; l += blockDim.x) {
    const int64_t c = c0 + l;
    if (c < n) amax = fmaxf(amax, fabsf(xr[c]));
  }
  amax = block_max(amax, red);
  const float scale = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
  const uint32_t seed = (uint32_t)seeds[w];
  int8_t* vr = values + w * nb * block;
  for (int64_t l = threadIdx.x; l < block; l += blockDim.x) {
    const int64_t c = c0 + l;
    const float xv = c < n ? xr[c] : 0.0f;
    const float u = stochastic_uniform((uint32_t)c, seed);
    const float q = fminf(fmaxf(floorf(__fadd_rn(__fdiv_rn(xv, scale), u)), -127.0f), 127.0f);
    vr[c] = (int8_t)(int)q;
  }
  if (threadIdx.x == 0) scales[w * nb + j] = scale;
}

// B5: out[w, c] = values[w, c] * scales[w, c / block] for c < n. A 2-D grid
// (row = blockIdx.y) with a grid-stride loop over the row's columns.
__global__ void q8_decode_kernel(const int8_t* __restrict__ values,
                                 const float* __restrict__ scales,
                                 float* __restrict__ out,
                                 int64_t n, int64_t block, int64_t nb) {
  const int64_t w = blockIdx.y;
  const int8_t* vr = values + w * nb * block;
  const float* sr = scales + w * nb;
  float* orow = out + w * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < n; c += stride)
    orow[c] = __fmul_rn((float)vr[c], sr[c / block]);
}

// B6: acc = x + r over the block (staged in shared memory, padded lanes 0);
// rank(i) = #{j : |a_j| > |a_i| or (|a_j| == |a_i| and j < i)}; the k
// entries of rank < k are written at position rank (values and in-block
// indices), and r'[c] = rank < k ? 0 : acc for c < n.
__global__ void topk_encode_kernel(const float* __restrict__ x,
                                   const float* __restrict__ r,
                                   float* __restrict__ vals,
                                   int32_t* __restrict__ idx,
                                   float* __restrict__ res,
                                   int64_t n, int block, int k, int64_t nb) {
  extern __shared__ float smem[];
  float* acc = smem;           // [block]
  float* mag = smem + block;   // [block]
  const int64_t j = blockIdx.x, w = blockIdx.y;
  const int64_t c0 = j * block;
  const int64_t row = w * n;
  for (int l = threadIdx.x; l < block; l += blockDim.x) {
    const int64_t c = c0 + l;
    const float a = c < n ? __fadd_rn(x[row + c], r[row + c]) : 0.0f;
    acc[l] = a;
    mag[l] = fabsf(a);
  }
  __syncthreads();
  const int64_t out0 = (w * nb + j) * k;
  for (int l = threadIdx.x; l < block; l += blockDim.x) {
    const float m = mag[l];
    int rank = 0;
    for (int i = 0; i < block && rank < k; ++i) {
      const float o = mag[i];
      rank += (o > m) | ((o == m) & (i < l));
    }
    const float a = acc[l];
    if (rank < k) {
      vals[out0 + rank] = a;
      idx[out0 + rank] = l;
    }
    const int64_t c = c0 + l;
    if (c < n) res[row + c] = rank < k ? 0.0f : a;
  }
}

// B7: out[w, j*block + l] = sum over the block's pairs p with idx == l of
// vals[p], from +0.0f in pair order, for columns < n.
__global__ void topk_decode_kernel(const float* __restrict__ vals,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out,
                                   int64_t n, int block, int k, int64_t nb) {
  extern __shared__ float smem[];
  float* sv = smem;                                    // [k]
  int32_t* si = reinterpret_cast<int32_t*>(smem + k);  // [k]
  const int64_t j = blockIdx.x, w = blockIdx.y;
  const int64_t in0 = (w * nb + j) * k;
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    sv[p] = vals[in0 + p];
    si[p] = idx[in0 + p];
  }
  __syncthreads();
  float* orow = out + w * n;
  for (int l = threadIdx.x; l < block; l += blockDim.x) {
    const int64_t c = j * block + l;
    if (c >= n) break;
    float s = 0.0f;
    for (int p = 0; p < k; ++p)
      if (si[p] == l) s = __fadd_rn(s, sv[p]);
    orow[c] = s;
  }
}

cudaError_t check_grid(int64_t w, int64_t nb) {
  if (w > kMaxRows || nb > 0x7FFFFFFF) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int repro_q8_encode(const void* x, const void* seeds, void* values, void* scales,
                               int64_t w, int64_t n, int64_t block, void* stream) {
  if (w <= 0 || n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block % kBlockThreads) return (int)cudaErrorInvalidValue;
  const int64_t nb = (n + block - 1) / block;
  cudaError_t e = check_grid(w, nb);
  if (e != cudaSuccess) return (int)e;
  q8_encode_kernel<<<dim3((unsigned)nb, (unsigned)w), kBlockThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int64_t*>(seeds),
      static_cast<int8_t*>(values), static_cast<float*>(scales), n, block, nb);
  return (int)cudaGetLastError();
}

extern "C" int repro_q8_decode(const void* values, const void* scales, void* out,
                               int64_t w, int64_t n, int64_t block, int64_t nb,
                               void* stream) {
  if (w <= 0 || n <= 0) return (int)cudaSuccess;
  if (block <= 0 || nb * block < n) return (int)cudaErrorInvalidValue;
  if (w > kMaxRows) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // about eight blocks per SM over the whole grid; rows share them
  int64_t cap = (132 * 8 + w - 1) / w;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  q8_decode_kernel<<<dim3((unsigned)blocks, (unsigned)w), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(values), static_cast<const float*>(scales),
      static_cast<float*>(out), n, block, nb);
  return (int)cudaGetLastError();
}

extern "C" int repro_topk_encode(const void* x, const void* r, void* vals, void* idx,
                                 void* res, int64_t w, int64_t n, int64_t block,
                                 int64_t k, void* stream) {
  if (w <= 0 || n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block % kBlockThreads || k <= 0 || k > block)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = (n + block - 1) / block;
  cudaError_t e = check_grid(w, nb);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 2 * (size_t)block * sizeof(float);
  e = allow_smem(topk_encode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  topk_encode_kernel<<<dim3((unsigned)nb, (unsigned)w), kBlockThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<float*>(vals), static_cast<int32_t*>(idx), static_cast<float*>(res),
      n, (int)block, (int)k, nb);
  return (int)cudaGetLastError();
}

extern "C" int repro_topk_decode(const void* vals, const void* idx, void* out,
                                 int64_t w, int64_t n, int64_t block, int64_t k,
                                 int64_t nb, void* stream) {
  if (w <= 0 || n <= 0) return (int)cudaSuccess;
  if (block <= 0 || k <= 0 || k > block || nb * block < n)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = check_grid(w, nb);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 2 * (size_t)k * sizeof(float);
  e = allow_smem(topk_decode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  topk_decode_kernel<<<dim3((unsigned)nb, (unsigned)w), kBlockThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n, (int)block, (int)k, nb);
  return (int)cudaGetLastError();
}
