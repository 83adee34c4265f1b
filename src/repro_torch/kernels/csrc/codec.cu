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
// last block reads as zeros). B4 and B7 take one codec block (j, row w) per
// thread block, grid (nb, W), blockIdx.x = j, blockIdx.y = w; B6 takes one
// per warp, several per thread block; B5 is a grid-stride loop per row.
//
// Bound: memory bandwidth for all four (one read and one write of the
// plane, a few operations per element). B6 is a radix select, one warp per
// codec block: about 16-20 one-bit passes over the block's magnitude bits in
// shared memory (each pass three or four operations per element), then one
// pass that keeps, writes the residual and compacts, and an O(k^2) rank of
// the k kept pairs; see topk_encode_kernel.
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
constexpr unsigned FULL_MASK = 0xffffffffu;

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

// B6: acc = x + r over the block (padded lanes 0); the k entries of
// largest |acc|, in descending order, ties to the lowest index; values and
// in-block indices at out0 + rank, and r'[c] = kept ? 0 : acc for c < n.
//
// One warp per codec block, kTopkWarps codec blocks per thread block; the
// warp stages its block in shared memory (lane l holds indices l + 32 c, so
// loads and residual stores are coalesced). For finite acc the bits of
// |acc| as uint32 order like the magnitudes, so the k-th largest magnitude
// is found MSB-first one bit at a time: with `want` the bits fixed so far
// and `need` how many of the elements whose top bits equal it are still to
// be taken, a pass counts the candidates whose next bit is 1 (a warp sum)
// and fixes that bit. The select stops as soon as every candidate is to be
// taken (ceq == need), usually well before bit 0. Then, with M masking the
// fixed bits, an element is kept if |acc| & M > want, or if it equals want
// and fewer than `need` equal elements have a lower index (a running ballot
// count over the columns: lane order within a column, columns in order, is
// index order). The kept pairs are compacted in index order, and each one's
// output slot is its rank among the kept (greater magnitude, or equal and
// earlier): O(k^2) comparisons, 676 at k = 26.
constexpr int kTopkWarps = 4;

__global__ void __launch_bounds__(kTopkWarps * 32)
topk_encode_kernel(const float* __restrict__ x, const float* __restrict__ r,
                   float* __restrict__ vals, int32_t* __restrict__ idx,
                   float* __restrict__ res, int64_t n, int block, int k, int64_t nb,
                   int64_t total, int wpc) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t gid = (int64_t)blockIdx.x * wpc + warp;
  if (gid >= total) return;
  float* acc = smem + (size_t)warp * (block + 2 * k);   // [block]
  float* cv = acc + block;                              // [k] kept values
  int32_t* ci = reinterpret_cast<int32_t*>(cv + k);     // [k] their indices
  const int64_t w = gid / nb, j = gid - (gid / nb) * nb;
  const int64_t c0 = j * block;
  const int64_t row = w * n;
  const int cols = block >> 5;
#pragma unroll 4
  for (int c = 0; c < cols; ++c) {
    const int i = lane + 32 * c;
    const int64_t g = c0 + i;
    acc[i] = g < n ? __fadd_rn(x[row + g], r[row + g]) : 0.0f;
  }
  __syncwarp();

  // radix select of the k-th largest |acc| bit pattern
  uint32_t want = 0u, M = 0u;
  int need = k, ceq = block;
  for (int sh = 30; sh >= 0 && ceq != need; --sh) {   // bit 31 is the sign
    const uint32_t Mn = 0x7fffffffu & (0xffffffffu << sh);
    const uint32_t wn = want | (1u << sh);
    int cnt = 0;
#pragma unroll 4
    for (int c = 0; c < cols; ++c)
      cnt += (__float_as_uint(acc[lane + 32 * c]) & Mn) == wn;
    cnt = (int)__reduce_add_sync(FULL_MASK, (unsigned)cnt);
    if (cnt >= need) {
      want = wn;
      ceq = cnt;
    } else {
      need -= cnt;
      ceq -= cnt;
    }
    M = Mn;
  }

  // keep, write the residual, compact the kept pairs in index order
  const unsigned lt = (1u << lane) - 1u;
  int eq_before = 0, kept_before = 0;
  for (int c = 0; c < cols; ++c) {
    const int i = lane + 32 * c;
    const float a = acc[i];
    const uint32_t u = __float_as_uint(a) & M;
    const bool eq = u == want;
    const unsigned eb = __ballot_sync(FULL_MASK, eq);
    const bool kept = u > want || (eq && eq_before + __popc(eb & lt) < need);
    eq_before += __popc(eb);
    const unsigned kb = __ballot_sync(FULL_MASK, kept);
    if (kept) {
      const int slot = kept_before + __popc(kb & lt);
      cv[slot] = a;
      ci[slot] = i;
    }
    kept_before += __popc(kb);
    const int64_t g = c0 + i;
    if (g < n) res[row + g] = kept ? 0.0f : a;
  }
  __syncwarp();

  // each kept pair's output slot: its rank among the kept
  const int64_t out0 = gid * k;
  for (int p = lane; p < k; p += 32) {
    const float a = cv[p];
    const uint32_t up = __float_as_uint(a) & 0x7fffffffu;
    int rank = 0;
    for (int q = 0; q < k; ++q) {
      const uint32_t uq = __float_as_uint(cv[q]) & 0x7fffffffu;
      rank += (uq > up) | ((uq == up) & (q < p));
    }
    vals[out0 + rank] = a;
    idx[out0 + rank] = ci[p];
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
  // kTopkWarps codec blocks per thread block while they fit the default
  // shared memory, fewer (down to one, opted in past 48 KB) for big blocks
  const size_t per_warp = (size_t)(block + 2 * k) * sizeof(float);
  int wpc = kTopkWarps;
  while (wpc > 1 && wpc * per_warp > (size_t)kDefaultSmem) wpc >>= 1;
  const size_t smem = wpc * per_warp;
  e = allow_smem(topk_encode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t total = w * nb;
  const int64_t grid = (total + wpc - 1) / wpc;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  topk_encode_kernel<<<(unsigned)grid, wpc * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<float*>(vals), static_cast<int32_t*>(idx), static_cast<float*>(res),
      n, (int)block, (int)k, nb, total, wpc);
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
