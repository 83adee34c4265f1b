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
// last block reads as zeros). B4, B6 and B7 take one codec block per warp,
// several per thread block, over a 1-d grid of the W * nb codec blocks
// (codec block gid = w * nb + j); B5 is a grid-stride loop per row.
//
// Bound: memory bandwidth for all four (one read and one write of the
// plane, a few operations per element).
//   - B4 holds its block in registers (16 floats a lane at block 512), takes
//     the amax with one warp reduction, quantizes from registers and stores
//     four int8 as one 32-bit word: one read of x, one write of the values,
//     about 30 instructions an element (hash, IEEE divide, floor, clamp,
//     pack) that overlap with the loads of other warps.
//   - B6 is a radix select, one warp per codec block: about 16-20 one-bit
//     passes over the block's magnitude bits in shared memory (each pass
//     three or four operations per element), then one pass that keeps,
//     writes the residual and compacts, and an O(k^2) rank of the k kept
//     pairs; see topk_encode_kernel.
//   - B7 stages the block's output in shared memory, zeroed, adds the k
//     pairs in pair order and writes the block once with 16-byte stores:
//     O(block + k) work a codec block.
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
//   - q8 amax propagates NaN as jnp.max and torch.amax do: a block holding
//     a NaN gets scale 1 (NaN > 0 is false), one holding an inf scale inf.
//   - Top-k decode sums each column's pairs from +0.0f in pair order, as the
//     Pallas kernel's fori_loop does, so a kept -0.0 decodes to +0.0, and
//     duplicate indices (a corrupted wire) sum in pair order too.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -split-compile=0 -shared
//     -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end). Every entry
// point returns a cudaError_t (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;          // a codec block is a multiple of 128
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

// B4: per codec block, scale = amax/127 (1 where amax is 0 or NaN) and
// q = clip(floor(x / scale + u), -127, 127), u = hash(j*block + lane, seed[w]).
// values: int8 [W, nb*block] (padded lanes written too), scales: f32 [W, nb].
//
// One warp per codec block, kQ8Warps codec blocks per thread block. Lane l
// holds columns 4(l + 32c) .. 4(l + 32c) + 3 of the block for c = 0 ..
// block/128 - 1, so each warp load covers 512 contiguous bytes and each
// warp store (four int8 packed into one 32-bit word a lane) 128. With
// C = block/128 <= 8 (the template's C) the block stays in registers: all C
// loads are in flight before any is used, one pass over device memory. C = 0
// (blocks above 1024) reads the block twice in the same warp, the second
// time from L2. The amax is one redux.sync over the bit patterns of |x|:
// non-negative floats order like their uint32 bits and a NaN's bits lie
// above inf's, so the max is NaN for a block holding one. VEC (rows 16-byte
// aligned: n % 4 == 0 and x aligned) loads float4; otherwise four scalars.
constexpr int kQ8Warps = 8;

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ xr, int i, int lim) {
  if (VEC)   // lim % 4 == 0: a float4 lies wholly inside or wholly past the row
    return i < lim ? *reinterpret_cast<const float4*>(xr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(i < lim ? xr[i] : 0.0f, i + 1 < lim ? xr[i + 1] : 0.0f,
                     i + 2 < lim ? xr[i + 2] : 0.0f, i + 3 < lim ? xr[i + 3] : 0.0f);
}

__device__ __forceinline__ uint32_t abs_bits_max(uint32_t m, float4 v) {
  m = max(m, __float_as_uint(v.x) & 0x7fffffffu);
  m = max(m, __float_as_uint(v.y) & 0x7fffffffu);
  m = max(m, __float_as_uint(v.z) & 0x7fffffffu);
  return max(m, __float_as_uint(v.w) & 0x7fffffffu);
}

// the warp's amax from each lane's max |x| bits -> the block's scale
__device__ __forceinline__ float q8_scale(uint32_t lane_max) {
  const float amax = __uint_as_float(__reduce_max_sync(FULL_MASK, lane_max));
  return amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
}

__device__ __forceinline__ uint32_t q8_one(float xv, float scale, uint32_t idx, uint32_t seed) {
  const float u = stochastic_uniform(idx, seed);
  const float q = fminf(fmaxf(floorf(__fadd_rn(__fdiv_rn(xv, scale), u)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// the int8 of columns idx .. idx + 3, little-endian in one word
__device__ __forceinline__ uint32_t q8_pack(float4 v, float scale, uint32_t idx, uint32_t seed) {
  return q8_one(v.x, scale, idx, seed) | q8_one(v.y, scale, idx + 1u, seed) << 8 |
         q8_one(v.z, scale, idx + 2u, seed) << 16 | q8_one(v.w, scale, idx + 3u, seed) << 24;
}

template <int C, bool VEC>
__global__ void __launch_bounds__(kQ8Warps * 32)
q8_encode_kernel(const float* __restrict__ x, const int64_t* __restrict__ seeds,
                 int8_t* __restrict__ values, float* __restrict__ scales,
                 int64_t n, int block, int64_t nb, int64_t total) {
  const int lane = threadIdx.x & 31;
  const int64_t gid = (int64_t)blockIdx.x * kQ8Warps + (threadIdx.x >> 5);
  if (gid >= total) return;
  const int64_t w = gid / nb;
  const int64_t c0 = (gid - w * nb) * block;           // the block's first column
  const float* xr = x + w * n + c0;
  const int lim = n - c0 < block ? (int)(n - c0) : block;   // its columns inside the row
  uint32_t* vr = reinterpret_cast<uint32_t*>(values + gid * block);
  const uint32_t seed = (uint32_t)seeds[w];
  const uint32_t idx = (uint32_t)c0 + 4u * lane;      // in-row column, mod 2^32
  uint32_t m = 0u;
  float scale;
  if constexpr (C > 0) {
    float4 v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = load4<VEC>(xr, 4 * lane + 128 * c, lim);
#pragma unroll
    for (int c = 0; c < C; ++c) m = abs_bits_max(m, v[c]);
    scale = q8_scale(m);
#pragma unroll
    for (int c = 0; c < C; ++c) vr[lane + 32 * c] = q8_pack(v[c], scale, idx + 128u * c, seed);
  } else {
    const int chunks = block >> 7;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c) m = abs_bits_max(m, load4<VEC>(xr, 4 * lane + 128 * c, lim));
    scale = q8_scale(m);
#pragma unroll 4
    for (int c = 0; c < chunks; ++c)
      vr[lane + 32 * c] = q8_pack(load4<VEC>(xr, 4 * lane + 128 * c, lim), scale,
                                  idx + 128u * c, seed);
  }
  if (lane == 0) scales[gid] = scale;
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
// vals[p], from +0.0f in pair order, for columns < n; pairs whose index lies
// outside [0, block) are dropped.
//
// One warp per codec block, wpc codec blocks per thread block. The warp
// stages `stage` = min(block, kStageCols) output columns at a time in
// shared memory (one tile: the whole block up to 4096): zeroed with 16-byte
// stores; then the k pairs added in rounds of 32, lane t holding pair
// 32r + t, __syncwarp between rounds; then the tile written to the row with
// 16-byte stores (VEC: n % 4 == 0 and out aligned) or 4-byte ones. Equal
// indices in one round (only a corrupted wire carries them) are grouped by
// match.any; the group's lowest lane adds its members' values in lane
// order, so every column sums in pair order. Work O(block + k) a codec block
// (k per tile beyond 4096 columns); each output byte is written once.
constexpr int kDecodeWarps = 8;
constexpr int kStageCols = 4096;

template <bool VEC>
__global__ void __launch_bounds__(kDecodeWarps * 32)
topk_decode_kernel(const float* __restrict__ vals, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int64_t n, int block, int k, int64_t nb,
                   int64_t total, int wpc, int stage) {
  extern __shared__ float4 stage_mem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t gid = (int64_t)blockIdx.x * wpc + warp;
  if (gid >= total) return;
  const int64_t w = gid / nb;
  const int64_t c0 = (gid - w * nb) * block;
  if (c0 >= n) return;                                 // a wire block past the row
  float* st = reinterpret_cast<float*>(stage_mem) + (size_t)warp * stage;
  float* orow = out + w * n + c0;
  const int lim = n - c0 < block ? (int)(n - c0) : block;
  const float* pv = vals + gid * k;
  const int32_t* pi = idx + gid * k;
  for (int t0 = 0; t0 < lim; t0 += stage) {
    const int tw = min(stage, block - t0);
    for (int i = 4 * lane; i < tw; i += 128)
      *reinterpret_cast<float4*>(st + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    for (int r = 0; r < k; r += 32) {
      const int p = r + lane;
      int ix = -1;
      float v = 0.0f;
      if (p < k) {
        ix = pi[p];
        v = pv[p];
      }
      const unsigned col = (unsigned)ix - (unsigned)t0;   // huge unless in the tile
      const bool hit = p < k && col < (unsigned)tw;
      // a lane that misses gets a key of its own, above every column
      const unsigned grp = __match_any_sync(FULL_MASK, hit ? col : (unsigned)tw + lane);
      if (__all_sync(FULL_MASK, grp == 1u << lane)) {
        if (hit) st[col] = __fadd_rn(st[col], v);
      } else {
        const bool lead = hit && (grp & ((1u << lane) - 1u)) == 0u;
        float s = lead ? st[col] : 0.0f;
        for (int src = 0; src < 32; ++src) {
          const float vs = __shfl_sync(FULL_MASK, v, src);
          if (lead && (grp >> src & 1u)) s = __fadd_rn(s, vs);
        }
        if (lead) st[col] = s;
      }
      __syncwarp();
    }
    const int wl = min(tw, lim - t0);                  // the tile's columns < n
    if (VEC) {
      for (int i = 4 * lane; i < wl; i += 128)
        *reinterpret_cast<float4*>(orow + t0 + i) = *reinterpret_cast<const float4*>(st + i);
    } else {
      for (int i = lane; i < wl; i += 32) orow[t0 + i] = st[i];
    }
    __syncwarp();
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

template <int C>
cudaError_t launch_q8_encode(bool vec, int64_t grid, cudaStream_t stream, const float* x,
                             const int64_t* seeds, int8_t* values, float* scales, int64_t n,
                             int block, int64_t nb, int64_t total) {
  if (vec)
    q8_encode_kernel<C, true><<<(unsigned)grid, kQ8Warps * 32, 0, stream>>>(
        x, seeds, values, scales, n, block, nb, total);
  else
    q8_encode_kernel<C, false><<<(unsigned)grid, kQ8Warps * 32, 0, stream>>>(
        x, seeds, values, scales, n, block, nb, total);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int repro_q8_encode(const void* x, const void* seeds, void* values, void* scales,
                               int64_t w, int64_t n, int64_t block, void* stream) {
  if (w <= 0 || n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block % kLane || block > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int64_t nb = (n + block - 1) / block;
  const int64_t total = w * nb;
  const int64_t grid = (total + kQ8Warps - 1) / kQ8Warps;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(x);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const float*>(x);
  const auto sp = static_cast<const int64_t*>(seeds);
  const auto vp = static_cast<int8_t*>(values);
  const auto cp = static_cast<float*>(scales);
  const int b = (int)block;
  switch (block / kLane) {   // the block in registers up to 1024, else two passes
    case 1: return (int)launch_q8_encode<1>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    case 2: return (int)launch_q8_encode<2>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    case 3: return (int)launch_q8_encode<3>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    case 4: return (int)launch_q8_encode<4>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    case 5: return (int)launch_q8_encode<5>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    case 6: return (int)launch_q8_encode<6>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    case 7: return (int)launch_q8_encode<7>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    case 8: return (int)launch_q8_encode<8>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
    default: return (int)launch_q8_encode<0>(vec, grid, s, xp, sp, vp, cp, n, b, nb, total);
  }
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
  if (block <= 0 || block % kLane || k <= 0 || k > block)
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
  if (block <= 0 || block % kLane || block > 0x7FFFFFFF || k <= 0 || k > block ||
      nb * block < n)
    return (int)cudaErrorInvalidValue;
  // kDecodeWarps codec blocks per thread block while their stages fit the
  // default shared memory: 8 at block 512 (16 KB), 2 from block 4096 up
  const int stage = (int)(block < kStageCols ? block : kStageCols);
  int wpc = kDecodeWarps;
  while (wpc > 1 && (size_t)wpc * stage * sizeof(float) > (size_t)kDefaultSmem) wpc >>= 1;
  const int64_t total = w * nb;
  const int64_t grid = (total + wpc - 1) / wpc;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)wpc * stage * sizeof(float);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto vp = static_cast<const float*>(vals);
  const auto ip = static_cast<const int32_t*>(idx);
  const auto op = static_cast<float*>(out);
  if (n % 4 == 0 && aligned16(out))
    topk_decode_kernel<true><<<(unsigned)grid, wpc * 32, smem, s>>>(
        vp, ip, op, n, (int)block, (int)k, nb, total, wpc, stage);
  else
    topk_decode_kernel<false><<<(unsigned)grid, wpc * 32, smem, s>>>(
        vp, ip, op, n, (int)block, (int)k, nb, total, wpc, stage);
  return (int)cudaGetLastError();
}
