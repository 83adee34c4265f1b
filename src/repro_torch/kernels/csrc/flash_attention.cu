// Blockwise online-softmax (flash) attention for Hopper (sm_90a): kernel B9.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (wrapper flash_attention). For every query row and the keys it may see:
//
//     s   = (q . k) * hd^-0.5                      (f32)
//     s   = softcap * tanh(s / softcap)            (when softcap > 0)
//     s   = visible ? s : -1e30                    (a select, never -inf)
//     out = sum_k softmax(s)_k v_k                 (online, f32 m / l / acc)
//     out = acc / max(l, 1e-30)                    (cast to q's dtype)
//
// A key kv_pos is visible to a query at absolute position q_pos (q_offset +
// its row) when kv_pos < kv_len, kv_pos >= kv_start[b] (the per-row
// continuous-batching bound; 0 without it), kv_pos <= q_pos if causal, and
// q_pos - kv_pos < window if window > 0. q_offset and kv_len are read from
// device memory when the caller passes pointers (decode takes them from the
// cache's position counter), as the TPU kernel reads kv_len from SMEM, so a
// decode step never waits on the host.
//
// Layout: q [B, Sq, H, hd], k and v [B, Skv, Hkv, hd], out [B, Sq, H, hd],
// each read through its own (b, s, h) strides in elements with the head dim
// contiguous: the model's BSHD tensors, the [B, max_len, Hkv, hd] cache and
// the op's BHSD views all go in without a copy. H = G * Hkv (GQA).
//
// Grid and block. The TPU kernel walks (b, h, q tile) in parallel and the kv
// tiles in order, reloading each kv tile per query head. Here one block
// takes one (batch row, kv head) and RW = 8 query rows of the G * Sq rows
// that share that kv head, row r being query s = r / G of head g = r % G;
// at TinyLlama's G = 8 a block is one query position for all eight heads,
// so every K/V row it reads serves eight heads. Nothing carries across
// blocks. The block's NW warps split the kv range: warp w takes the tiles
// of BK = 32 keys starting at lo + 32 (w + NW t), stages them into its own
// shared-memory tile (16-byte loads, converted to f32), and keeps its own
// running max m, sum l and accumulator acc for the RW rows; at the end the
// warps merge (m, l, acc) through shared memory. Inside a tile lane j owns
// key j for the scores (its K row against the RW rows of Q held in shared
// memory, float4 broadcast reads) and head dims j, j + 32, ... for P.V.
//
// Block skipping. The block only visits keys in [lo, hi): lo the largest of
// kv_start[b] and the window's lower edge for the block's first query, hi
// the smallest of kv_len, Skv and (causal) its last query + 1. A tile that
// is fully masked for every row of the block is never read: decode reads
// the pos + 1 live cache rows, not max_len, and causal prefill stops at the
// diagonal. This is exact for any row with at least one visible key, since
// the first visible key's correction exp(-1e30 - m) is exactly 0 in the
// reference too. Keys in a tile past hi are staged as zeros and a masked
// key's probability is selected to 0, so whatever garbage lies below
// kv_start or past kv_len contributes exactly nothing. A row with no
// visible key at all is out of contract (no path produces one): it gives 0
// here and the mean of v in the reference.
//
// Bound on this card: the larger of the bytes (q, the visible K/V rows and
// out, each moved once) and the operations (4 * hd flops per row and
// visible key) at the bf16 tensor-core peak; at the serve path's shapes the
// bytes, for prefill and decode alike. This first kernel runs on the CUDA
// cores in f32 (no tensor cores, no TMA, no wgmma): a simple kernel that is
// right, far from that bound. Shared memory: Q [RW][hd], P [NW][RW][32],
// K [NW][32][hd + 4] (the +4 keeps the lanes' float4 reads of their own K
// row on distinct banks), V [NW][32][hd]; about 72 KB at hd 64 and 139 KB
// at hd 256 (NW = 2 there), opted in with cudaFuncSetAttribute.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RW = 8;            // query rows per block
constexpr int BK = 32;           // keys per warp tile: one per lane
constexpr float NEG = -1e30f;    // the reference's finite mask value
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;   // element strides
  int B, Sq, Skv, H, Hkv, hd;
  int causal, window;
  float softcap, scale;
  int q_offset, kv_len;          // used when the pointer beside it is null
  const int* q_offset_ptr;
  const int* kv_len_ptr;
  const int* kv_start;           // [B] or null
};

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<__nv_bfloat16> { static constexpr int N = 8; };

// 16 bytes at p (16-byte aligned, checked by the wrapper) as f32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// n f32 values (n a multiple of 4, dst 16-byte aligned) into shared memory
template <int N>
__device__ __forceinline__ void put(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
}

template <typename T, int HDC, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_attention_kernel(Args a) {
  constexpr int VN = VecN<T>::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = a.hd;
  const int kstride = hd + 4;
  float* Qs = smem;                        // [RW][hd]
  float* Ps = Qs + RW * hd;                // [NW][RW][BK]
  float* Ks = Ps + NW * RW * BK;           // [NW][BK][kstride]
  float* Vs = Ks + NW * BK * kstride;      // [NW][BK][hd]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int r0 = blockIdx.x * RW;
  const int nrows = min(RW, G * a.Sq - r0);

  const int q_offset = a.q_offset_ptr ? *a.q_offset_ptr : a.q_offset;
  const int kv_len = a.kv_len_ptr ? *a.kv_len_ptr : a.kv_len;
  const int start = a.kv_start ? a.kv_start[b] : 0;
  const int qp_lo = q_offset + r0 / G;
  const int qp_hi = q_offset + (r0 + nrows - 1) / G;
  int lo = max(start, 0);
  if (a.window > 0) lo = max(lo, qp_lo - a.window + 1);
  int hi = min(kv_len, a.Skv);
  if (a.causal) hi = min(hi, qp_hi + 1);

  // the block's RW query rows, f32, zero for rows past the end
  const T* q = static_cast<const T*>(a.q);
  const int nchunk = hd / VN;
  for (int e = threadIdx.x; e < RW * nchunk; e += NW * 32) {
    const int r = e / nchunk, c = e - (e / nchunk) * nchunk;
    float buf[VN];
    if (r < nrows) {
      const int rr = r0 + r;
      const int sq = rr / G, h = hk * G + rr % G;
      load16(q + b * a.qb + sq * a.qs + h * a.qh + c * VN, buf);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) buf[i] = 0.f;
    }
    put<VN>(Qs + r * hd + c * VN, buf);
  }
  __syncthreads();

  int qpos[RW];
  float m[RW], l[RW], acc[RW][HDC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    qpos[r] = q_offset + (r0 + r) / G;
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < HDC; ++i) acc[r][i] = 0.f;
  }

  float* Kw = Ks + warp * BK * kstride;
  float* Vw = Vs + warp * BK * hd;
  float* Pw = Ps + warp * RW * BK;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;

  for (int t0 = lo + warp * BK; t0 < hi; t0 += NW * BK) {
    const int nk = min(BK, hi - t0);
    __syncwarp();
    for (int e = lane; e < BK * nchunk; e += 32) {
      const int j = e / nchunk, c = e - (e / nchunk) * nchunk;
      float kb[VN], vb[VN];
      if (j < nk) {
        load16(kp + (int64_t)(t0 + j) * a.ks + c * VN, kb);
        load16(vp + (int64_t)(t0 + j) * a.vs + c * VN, vb);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kb[i] = vb[i] = 0.f;
      }
      put<VN>(Kw + j * kstride + c * VN, kb);
      put<VN>(Vw + j * hd + c * VN, vb);
    }
    __syncwarp();

    // scores: lane owns key t0 + lane
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float* krow = Kw + lane * kstride;
    for (int d = 0; d < hd; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + r * hd + d);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int kpos = t0 + lane;
    unsigned vis = 0;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float x = s[r] * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      bool ok = lane < nk && r < nrows;
      if (a.causal) ok = ok && kpos <= qpos[r];
      if (a.window > 0) ok = ok && (qpos[r] - kpos) < a.window;
      s[r] = ok ? x : NEG;
      vis |= (ok ? 1u : 0u) << r;
    }

    // online softmax; l stays a per-lane partial sum until the end
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float mx = s[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float corr = expf(m[r] - mn);
      const float p = ((vis >> r) & 1u) ? expf(s[r] - mn) : 0.f;
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int i = 0; i < HDC; ++i) acc[r][i] *= corr;
      m[r] = mn;
      Pw[r * BK + lane] = p;
    }
    __syncwarp();

    // acc[r][d] += sum_j p[r][j] v[j][d], lane owns d = lane + 32 i
    const int nk4 = (nk + 3) & ~3;
    for (int j = 0; j < nk4; j += 4) {
      float4 pr[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) pr[r] = *reinterpret_cast<const float4*>(Pw + r * BK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < HDC; ++i) {
          const int d = lane + 32 * i;
          const float vv = d < hd ? Vw[(j + jj) * hd + d] : 0.f;
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
            acc[r][i] += pj * vv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l[r] += __shfl_xor_sync(FULL, l[r], off);
  }
  __syncthreads();                         // every warp is done with its tiles
  float* Mw = Ks;                          // [NW][RW]
  float* Lw = Mw + NW * RW;                // [NW][RW]
  float* Aw = Lw + NW * RW;                // [NW][RW][hd]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      Mw[warp * RW + r] = m[r];
      Lw[warp * RW + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int i = 0; i < HDC; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) Aw[(warp * RW + r) * hd + d] = acc[r][i];
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o);
  for (int e = threadIdx.x; e < nrows * hd; e += NW * 32) {
    const int r = e / hd, d = e - (e / hd) * hd;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * RW + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(Mw[w * RW + r] - M);
      L += Lw[w * RW + r] * c;
      A += Aw[(w * RW + r) * hd + d] * c;
    }
    const int rr = r0 + r;
    const int sq = rr / G, h = hk * G + rr % G;
    store(o + b * a.ob + sq * a.os + h * a.oh + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HDC, int NW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)RW * a.hd + (size_t)NW * RW * BK +
                                       (size_t)NW * BK * (a.hd + 4) + (size_t)NW * BK * a.hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HDC, NW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = a.H / a.Hkv * a.Sq;
  const dim3 grid((unsigned)((rows + RW - 1) / RW), (unsigned)a.Hkv, (unsigned)a.B);
  flash_attention_kernel<T, HDC, NW><<<grid, NW * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.hd <= 32) return launch<T, 1, 4>(a, stream);
  if (a.hd <= 64) return launch<T, 2, 4>(a, stream);
  if (a.hd <= 128) return launch<T, 4, 4>(a, stream);
  return launch<T, 8, 2>(a, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// strides: 12 element strides (q, k, v, out; each batch, seq, head), the
// head dim contiguous. q_offset_ptr / kv_len_ptr: int32 device scalars or
// null (then the int beside them is used); kv_start: int32 [B] or null.
// Returns a cudaError_t (0 = success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* o, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                                     int64_t Hkv, int64_t hd, const int64_t* strides,
                                     int causal, int window, float softcap, int q_offset,
                                     const void* q_offset_ptr, int kv_len,
                                     const void* kv_len_ptr, const void* kv_start,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || hd < 8 || hd > 256 || hd % 8 != 0 || B > 65535 ||
      Hkv > 65535 || (H / Hkv) * Sq > (int64_t)1 << 30 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.qb = strides[0]; a.qs = strides[1]; a.qh = strides[2];
  a.kb = strides[3]; a.ks = strides[4]; a.kh = strides[5];
  a.vb = strides[6]; a.vs = strides[7]; a.vh = strides[8];
  a.ob = strides[9]; a.os = strides[10]; a.oh = strides[11];
  a.B = (int)B; a.Sq = (int)Sq; a.Skv = (int)Skv; a.H = (int)H; a.Hkv = (int)Hkv;
  a.hd = (int)hd;
  a.causal = causal; a.window = window;
  a.softcap = softcap;
  a.scale = (float)(1.0 / sqrt((double)hd));   // f32 of hd^-0.5, as the reference rounds it
  a.q_offset = q_offset; a.kv_len = kv_len;
  a.q_offset_ptr = static_cast<const int*>(q_offset_ptr);
  a.kv_len_ptr = static_cast<const int*>(kv_len_ptr);
  a.kv_start = static_cast<const int*>(kv_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
