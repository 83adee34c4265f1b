// Blockwise online-softmax (flash) attention for Hopper (sm_90a): kernel B9.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (wrapper flash_attention). For every query row and the keys it may see:
//
//     s   = (q . k) * hd^-0.5                      (f32)
//     s   = softcap * tanh(s / softcap)            (when softcap > 0)
//     s   = visible ? s : -1e30                    (the reference's mask)
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
// Layout: q [B, Sq, H, hd], k [B, Skv, Hkv, hd], v [B, Skv, Hkv, dv], out
// [B, Sq, H, dv], each read through its own (b, s, h) strides in elements
// with the head dim contiguous: the model's BSHD tensors, the [B, max_len,
// Hkv, hd] cache and the op's BHSD views all go in without a copy. H = G *
// Hkv (GQA). The values may be narrower than the keys (dv <= hd <= 576, both
// multiples of 8): MLA attends with 576-wide keys (the 512-wide latent c_kv
// and the 64-wide roped key) over the latent alone. Where v is the prefix of
// k (the same pointer and strides: MLA's values as the view kk[..., :dv]),
// the SIMT and SPLIT forms and MMA's MLA kernel read the values from the K
// tile they already hold.
//
// Three forms compute this function. The wrapper picks one from host-known
// shapes alone (kernels/flash_attention.py::_form; never from kv_len, which
// is a device scalar) and passes it in:
//
//   rows = (H / Hkv) * Sq, the query rows that share one kv head
//   rows <= 16                              -> SPLIT (decode; f32 and bf16, any hd)
//   bf16, hd in {64, 80, 128, 256}, dv = hd -> MMA   (prefill on the tensor cores)
//   bf16, hd 576, dv 512, v in k            -> MMA   (MLA's prefill: its own kernel)
//   otherwise                               -> SIMT  (f32 prefill, other shapes)
//
// Every form visits only the keys in [lo, hi): lo the largest of
// kv_start[b] and the window's lower edge for the block's first query, hi
// the smallest of kv_len, Skv and (causal) its last query + 1. Keys outside
// are never read (staged as zeros where a tile overhangs), and a key masked
// for one row has its probability selected to 0, so whatever garbage lies
// below kv_start or past kv_len contributes exactly nothing. This is exact
// for any row with at least one visible key, since the first visible key's
// correction exp(-1e30 - m) is exactly 0 in the reference too. A row with no
// visible key at all is out of contract (no path produces one): it gives 0
// here and the mean of v in the reference. Query rows are packed s-major,
// row r being query s = r / G of head g = r % G (G = H / Hkv), so every K/V
// row a block reads serves all G heads.
//
// MMA (bf16; FA2's structure on mma.sync). A block of 4 warps takes one
// (batch row, kv head) and 128 of its query rows at hd 64 and 80 (each warp
// two 16-row atoms, so every K and V fragment it reads feeds 32 rows), 64 at
// hd 128 and 256 (one atom a warp, for registers). Q is copied once into
// shared memory; K/V tiles of 64 keys (32 at hd 256) go through a double
// buffer with 16-byte cp.async, so tile t + 1 loads while tile t is
// computed. S = Q K^T is mma.sync.m16n8k16 bf16 -> f32 with Q and K read by
// ldmatrix. Scores are scaled (and softcapped) into log2 units, so each
// probability is one ex2; on a tile that some row of the warp does not
// wholly see, masked scores are selected to -inf (ex2 gives exactly 0), and
// wholly visible tiles skip the masks. The running max, sum and correction
// stay in f32 registers; P is rounded to bf16 and O += P V is mma.sync with
// V read by ldmatrix.trans. Rows are padded by 16 bytes in shared memory,
// so ldmatrix's eight rows fall on distinct banks. O is normalised in f32,
// cast once and staged through shared memory into 16-byte stores. Blocks
// are issued longest-first across the whole grid (the last query rows see
// the most keys under causal masking), which balances the SMs' work. At hd
// 80 (Zamba2's shared attention) the loops run over 5 k-steps of 16 and 10
// chunks of 8; rows of 88 elements still put ldmatrix's rows on distinct
// banks. At hd 64 and 80 a thread takes 255 registers (O and S of two
// atoms), so 2 blocks (8 warps) share an SM; one atom a warp, 32-key
// tiles or a cap of 3 blocks an SM all ran slower on an H100.
//
// MMA at MLA's shapes (bf16, hd 576, dv 512, v the keys' prefix; kernel
// flash_attention_mla_kernel). One warp's 16-row atom over 576 key dims and
// 512 value columns does not fit its registers (O alone would be 256 f32 a
// thread), so warps work in pairs. A block of 8 warps takes 64 query rows
// of one (batch row, kv head): at G = 16 that is 4 query positions of all
// 16 heads, so its rows share nearly one causal range. Q is copied once
// into shared memory (64 x 576); K goes through a double buffer of 32-key
// tiles with 16-byte cp.async, and the values are read from the K tile's
// first 512 columns, so no V tile exists. Warps w and w + 4 own the same 16
// rows: each computes the partial S over one half of the 576 dims (18
// mma.sync k-steps), the pair adds the two partials through shared memory
// (IEEE addition commutes, so both hold the same S bit for bit), both run
// the same online softmax, and each accumulates O over its own 256 of the
// 512 value columns (128 f32 a thread). About 162 KB of shared memory, one
// block an SM. The bound is bytes (q, out and each key row once; the kernel
// reads the keys once per 64 query rows, from L2 after the first). What
// holds it above the bound is shared memory, through which ldmatrix moves
// about 0.6 bytes a flop, and one block of 8 warps an SM (241 registers a
// thread), too few warps to hide the mma chains' latency; the SIMT form it
// replaces at this shape ran f32 FMAs on the CUDA cores, 8 query rows a
// block.
//
// SPLIT (flash-decoding; f32 CUDA-core math). Launch 1 has a block per
// (split, kv head, batch row); split c takes the keys [32 c, 32 c + 32)
// of [lo, hi) (nsplit = ceil(Skv / 32), from the host-known Skv), a key per
// lane. It stages its keys with cp.async and its <= 16 query rows, and
// writes its partial state (m, l, acc[hd]) per row to a scratch buffer the
// wrapper allocated; a split with no key in [lo, hi) writes m = -1e30,
// l = 0 and exits. Launch 2, a block per (query row, kv head, batch row),
// merges the splits whose l > 0 into
// out = sum acc e^(m - M) / sum l e^(m - M), over a compacted list of them.
//
// SIMT (the first form, f32 on the CUDA cores: f32 prefill, and bf16
// prefill at shapes no path runs on the tensor cores). One block takes one (batch
// row, kv head) and RW = 8 query rows. The block's NW warps split the kv
// range: warp w takes the tiles of BK = 32 keys starting at lo + 32 (w + NW
// t), stages them into its own shared-memory tile (16-byte loads, converted
// to f32), and keeps its own running max m, sum l and accumulator acc for
// the RW rows; at the end the warps merge (m, l, acc) through shared
// memory. Inside a tile lane j owns key j for the scores (its K row against
// the RW rows of Q held in shared memory, float4 broadcast reads) and value
// dims j, j + 32, ... for P.V. Shared memory: Q [RW][hd], P [NW][RW][32],
// K [NW][32][hd + 4], V [NW][32][dv] (none when v is k's prefix); about 72
// KB at hd 64 and 139 KB at hd 256 (NW = 2 there), 169 KB for MLA's hd 576 /
// dv 512 with v in k (NW = 2), opted in with cudaFuncSetAttribute. NW is the
// most warps (4, or 2 past dv 128) whose tiles fit in 227 KB, else 1.
//
// Bound on this card: the larger of the bytes (q, the visible K/V rows and
// out, each moved once) and the operations (2 * (hd + dv) flops per row and
// visible key) at the bf16 tensor-core peak; at the serve path's shapes the
// bytes, for prefill and decode alike. MMA keeps the K/V traffic at one read
// per 64 or 128 query rows and the math on the tensor cores; SPLIT spreads
// the decode keys over 32 times as many blocks as one per (batch row, kv
// head) would.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -split-compile=0 -shared
//     -Xcompiler -fPIC
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RW = 8;            // query rows per block (SIMT)
constexpr int BK = 32;           // keys per warp tile, one per lane (SIMT)
constexpr float NEG = -1e30f;    // the reference's finite mask value
constexpr unsigned FULL = 0xffffffffu;
constexpr int SPLIT_KEYS = 32;   // keys per split (SPLIT): a key per lane
constexpr int SPLIT_ROWS = 16;   // most query rows per kv head (SPLIT)
constexpr int SPLIT_THREADS = 128;
constexpr int MMA_THREADS = 128;
constexpr int MAX_HD = 576;              // MLA's 512 + 64
constexpr size_t MAX_SMEM = 232448;      // the dynamic shared memory a block may opt in to
enum Form { SIMT = 0, MMA = 1, SPLIT = 2 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;   // element strides
  int B, Sq, Skv, H, Hkv, hd, dv;
  int v_in_k;                    // v is k's prefix: the same pointer and strides
  int causal, window;
  float softcap, scale;
  int q_offset, kv_len;          // used when the pointer beside it is null
  const int* q_offset_ptr;
  const int* kv_len_ptr;
  const int* kv_start;           // [B] or null
  float* part;                   // SPLIT's partial states, or null
  int nsplit;
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

// 4 elements at p (8 bytes of bf16 or 16 of f32, aligned to that) as f32
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
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

// The keys [lo, hi) that query rows [r0, r0 + nrows) of batch row b may see
// (the union over the rows), with the scalars they come from.
struct Span {
  int q_offset, kv_len, start, lo, hi;
};

__device__ __forceinline__ Span span_of(const Args& a, int b, int r0, int nrows, int G) {
  Span sp;
  sp.q_offset = a.q_offset_ptr ? *a.q_offset_ptr : a.q_offset;
  sp.kv_len = a.kv_len_ptr ? *a.kv_len_ptr : a.kv_len;
  sp.start = a.kv_start ? a.kv_start[b] : 0;
  const int qp_lo = sp.q_offset + r0 / G;
  const int qp_hi = sp.q_offset + (r0 + nrows - 1) / G;
  sp.lo = max(sp.start, 0);
  if (a.window > 0) sp.lo = max(sp.lo, qp_lo - a.window + 1);
  sp.hi = min(sp.kv_len, a.Skv);
  if (a.causal) sp.hi = min(sp.hi, qp_hi + 1);
  return sp;
}

// [lo, hi) of the keys that the query at absolute position qpos may see
__device__ __forceinline__ void row_bounds(const Args& a, const Span& sp, int qpos, int& lo,
                                           int& hi) {
  lo = max(sp.start, 0);
  if (a.window > 0) lo = max(lo, qpos - a.window + 1);
  hi = min(sp.kv_len, a.Skv);
  if (a.causal) hi = min(hi, qpos + 1);
}

// a score scaled and, when softcap > 0, softcapped (SPLIT)
__device__ __forceinline__ float cap(const Args& a, float s) {
  const float x = s * a.scale;
  return a.softcap > 0.f ? a.softcap * tanhf(x / a.softcap) : x;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int HDC, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_attention_kernel(Args a) {
  constexpr int VN = VecN<T>::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = a.hd, dv = a.dv;
  const int kstride = hd + 4;
  const int vstride = a.v_in_k ? kstride : dv;
  float* Qs = smem;                        // [RW][hd]
  float* Ps = Qs + RW * hd;                // [NW][RW][BK]
  float* Ks = Ps + NW * RW * BK;           // [NW][BK][kstride]
  float* Vs = Ks + NW * BK * kstride;      // [NW][BK][dv], unless v_in_k

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int r0 = blockIdx.x * RW;
  const int nrows = min(RW, G * a.Sq - r0);

  const Span sp = span_of(a, b, r0, nrows, G);
  const int q_offset = sp.q_offset, lo = sp.lo, hi = sp.hi;

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
  float* Vw = a.v_in_k ? Kw : Vs + warp * BK * dv;
  float* Pw = Ps + warp * RW * BK;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;

  for (int t0 = lo + warp * BK; t0 < hi; t0 += NW * BK) {
    const int nk = min(BK, hi - t0);
    __syncwarp();
    for (int e = lane; e < BK * nchunk; e += 32) {
      const int j = e / nchunk, c = e - (e / nchunk) * nchunk;
      float kb[VN];
      if (j < nk) {
        load16(kp + (int64_t)(t0 + j) * a.ks + c * VN, kb);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kb[i] = 0.f;
      }
      put<VN>(Kw + j * kstride + c * VN, kb);
    }
    if (!a.v_in_k) {
      const int nvchunk = dv / VN;
      for (int e = lane; e < BK * nvchunk; e += 32) {
        const int j = e / nvchunk, c = e - (e / nvchunk) * nvchunk;
        float vb[VN];
        if (j < nk) {
          load16(vp + (int64_t)(t0 + j) * a.vs + c * VN, vb);
        } else {
#pragma unroll
          for (int i = 0; i < VN; ++i) vb[i] = 0.f;
        }
        put<VN>(Vw + j * dv + c * VN, vb);
      }
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
          const float vv = d < dv ? Vw[(j + jj) * vstride + d] : 0.f;
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
  float* Aw = Lw + NW * RW;                // [NW][RW][dv]
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
      if (d < dv) Aw[(warp * RW + r) * dv + d] = acc[r][i];
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o);
  for (int e = threadIdx.x; e < nrows * dv; e += NW * 32) {
    const int r = e / dv, d = e - (e / dv) * dv;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * RW + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(Mw[w * RW + r] - M);
      L += Lw[w * RW + r] * c;
      A += Aw[(w * RW + r) * dv + d] * c;
    }
    const int rr = r0 + r;
    const int sq = rr / G, h = hk * G + rr % G;
    store(o + b * a.ob + sq * a.os + h * a.oh + d, A / fmaxf(L, 1e-30f));
  }
}

// SIMT's shared memory with NW warps
size_t simt_smem(const Args& a, int NW) {
  return sizeof(float) * ((size_t)RW * a.hd + (size_t)NW * RW * BK +
                          (size_t)NW * BK * (a.hd + 4) +
                          (a.v_in_k ? 0 : (size_t)NW * BK * a.dv));
}

template <typename T, int HDC, int NW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = simt_smem(a, NW);
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

// HDC = ceil(dv / 32) accumulator columns a lane, rounded up to an
// instantiated count; NW the most warps (4, or 2 past dv 128, for the
// registers) whose tiles fit in shared memory. Where even 2 do not (hd past
// about 400 with values of their own), one warp with 16 (or 18) columns,
// the extra ones idle: fewer instantiations to compile
template <typename T, int HDC>
cudaError_t launch_nw(const Args& a, cudaStream_t stream) {
  if constexpr (HDC <= 4) {
    if (simt_smem(a, 4) <= MAX_SMEM) return launch<T, HDC, 4>(a, stream);
  }
  if (simt_smem(a, 2) <= MAX_SMEM) return launch<T, HDC, 2>(a, stream);
  if constexpr (HDC < 16) return launch<T, 16, 1>(a, stream);
  else return launch<T, HDC, 1>(a, stream);
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.dv <= 32) return launch_nw<T, 1>(a, stream);
  if (a.dv <= 64) return launch_nw<T, 2>(a, stream);
  if (a.dv <= 128) return launch_nw<T, 4>(a, stream);
  if (a.dv <= 256) return launch_nw<T, 8>(a, stream);
  if (a.dv <= 512) return launch_nw<T, 16>(a, stream);
  return launch_nw<T, 18>(a, stream);
}

// ---------------------------------------------------------------------------
// MMA: bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a 2^x that maps to one MUFU op; 2^-inf = +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a named barrier over n threads (a multiple of 32); id 0 is __syncthreads'
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One key tile's scores into probabilities, for a warp's RA 16-row atoms
// over NB 8-key blocks (lane = 4 g + t4 holds rows g and g + 8 of each atom,
// keys t0 + 8 n + 2 t4 + {0, 1}): scale (and softcap) into log2 units, mask
// the keys a row does not see unless every row of the warp sees the whole
// tile (-inf, whose ex2 is exactly 0), and take the online-softmax step. S
// becomes the unnormalised P, m and l move on, and corr is the factor by
// which each row's O accumulator is to be scaled.
template <int RA, int NB>
__device__ __forceinline__ void softmax_step(const Args& a, float (&s)[RA][NB][4],
                                             float (&m)[RA][2], float (&l)[RA][2],
                                             float (&corr)[RA][2], const int (&rlo)[RA][2],
                                             const int (&rhi)[RA][2], int t0, int t4) {
  constexpr float LOG2E = 1.4426950408889634f;
  bool full = true;
#pragma unroll
  for (int ra = 0; ra < RA; ++ra)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) full = full && rlo[ra][hh] <= t0 && rhi[ra][hh] >= t0 + 8 * NB;
  full = __all_sync(FULL, full);
  if (a.softcap > 0.f) {        // a uniform branch around the loop, never per score
    const float cap_in = a.scale / a.softcap;
    const float cap_l2 = a.softcap * LOG2E;           // softcap tanh(.) -> log2 units
#pragma unroll
    for (int ra = 0; ra < RA; ++ra)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[ra][n][i] = cap_l2 * tanhf(s[ra][n][i] * cap_in);
  } else {
    const float sl2 = a.scale * LOG2E;                // s -> log2 units
#pragma unroll
    for (int ra = 0; ra < RA; ++ra)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[ra][n][i] *= sl2;
  }
  if (!full) {
#pragma unroll
    for (int ra = 0; ra < RA; ++ra)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = t0 + n * 8 + 2 * t4 + (i & 1);
          const int hh = i >> 1;
          if (!(key >= rlo[ra][hh] && key < rhi[ra][hh])) s[ra][n][i] = -INFINITY;
        }
  }
  // the online softmax per row (a quad of lanes holds a row)
#pragma unroll
  for (int ra = 0; ra < RA; ++ra) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[ra][n][i]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = mx[hh];
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
      const float mn = fmaxf(m[ra][hh], v);
      corr[ra][hh] = exp2_approx(m[ra][hh] - mn);
      m[ra][hh] = mn;
      l[ra][hh] *= corr[ra][hh];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2_approx(s[ra][n][i] - m[ra][i >> 1]);
        s[ra][n][i] = p;
        l[ra][i >> 1] += p;
      }
    }
  }
}

// the visible key range [lo, hi) of each of a thread's rows (row r of the
// block for r = r0w + 16 ra + g + 8 hh; empty past nrows)
template <int RA>
__device__ __forceinline__ void thread_rows(const Args& a, const Span& sp, int r0, int r0w,
                                            int nrows, int G, int g, int (&rlo)[RA][2],
                                            int (&rhi)[RA][2]) {
#pragma unroll
  for (int ra = 0; ra < RA; ++ra) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0w + ra * 16 + g + 8 * hh;
      if (r < nrows) {
        row_bounds(a, sp, sp.q_offset + (r0 + r) / G, rlo[ra][hh], rhi[ra][hh]);
      } else {
        rlo[ra][hh] = 1;
        rhi[ra][hh] = 0;
      }
    }
  }
}

// 1 / l of a thread's two rows of an atom, l summed over the row's quad
__device__ __forceinline__ void inv_sums(const float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float v = l[hh];
    v += __shfl_xor_sync(FULL, v, 1);
    v += __shfl_xor_sync(FULL, v, 2);
    inv[hh] = 1.f / fmaxf(v, 1e-30f);
  }
}

template <int HD>
struct MmaTile {
  static constexpr int RA = HD <= 80 ? 2 : 1;       // 16-row atoms per warp
  static constexpr int ROWS = 4 * 16 * RA;          // query rows per block
  static constexpr int BKN = HD > 128 ? 32 : 64;    // keys per K/V tile
  static constexpr int LD = HD + 8;                 // smem row stride (elements)
  static constexpr size_t smem = sizeof(bf16) * (size_t)(ROWS + 4 * BKN) * LD;
};

// Fragment layouts of mma.m16n8k16 (lane = 4 g + t): A row g / g + 8, cols
// 2t, 2t + 1 (+ 8); B col g, rows 2t, 2t + 1 (+ 8); C/D row g / g + 8, cols
// 2t, 2t + 1. So for each of its RA row atoms a thread holds rows g and
// g + 8, and in S the keys 8 n + 2 t + {0, 1} of each 8-key block n. Each K
// and V fragment read from shared memory feeds the warp's RA atoms. Scores
// are kept in log2 units (scaled by log2 e), so each probability is one
// ex2; masked scores are -inf, whose ex2 is exactly 0.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(Args a) {
  using Tile = MmaTile<HD>;
  constexpr int RA = Tile::RA, ROWS = Tile::ROWS, BKN = Tile::BKN, LD = Tile::LD;
  constexpr int NB = BKN / 8;      // 8-key blocks of S per tile
  constexpr int DB = HD / 8;       // 8-dim blocks of O
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);   // [ROWS][LD]
  bf16* Ks = Qs + ROWS * LD;                     // [2][BKN][LD]
  bf16* Vs = Ks + 2 * BKN * LD;                  // [2][BKN][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // a 1-d grid, longest first over the whole grid: every (kv head, batch
  // row) of the last row tile, then of the one before, ...
  const int G = a.H / a.Hkv;
  const int pairs = a.Hkv * a.B;
  const int hk = (int)(blockIdx.x % pairs) % a.Hkv, b = (int)(blockIdx.x % pairs) / a.Hkv;
  const int r0 = (int)(gridDim.x / pairs - 1 - blockIdx.x / pairs) * ROWS;
  const int nrows = min(ROWS, G * a.Sq - r0);
  const Span sp = span_of(a, b, r0, nrows, G);
  const int lo = sp.lo, hi = sp.hi;
  const int wr0 = warp * 16 * RA;                      // the warp's first row

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < ROWS * CH; e += MMA_THREADS) {
    const int r = e / CH, c = e - (e / CH) * CH;
    const int rr = r0 + min(r, nrows - 1);
    const int sq = rr / G, h = hk * G + rr % G;
    cp_async16(Qs + r * LD + c * 8, q + b * a.qb + sq * a.qs + h * a.qh + c * 8, r < nrows);
  }
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.kb + hk * a.kh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vb + hk * a.vh;
  const int ntiles = hi > lo ? (hi - lo + BKN - 1) / BKN : 0;
  auto load_kv = [&](int t0, int buf) {
    for (int e = tid; e < BKN * CH; e += MMA_THREADS) {
      const int j = e / CH, c = e - (e / CH) * CH;
      const bool ok = t0 + j < hi;
      const int64_t row = ok ? t0 + j : t0;
      cp_async16(Ks + (buf * BKN + j) * LD + c * 8, kp + row * a.ks + c * 8, ok);
      cp_async16(Vs + (buf * BKN + j) * LD + c * 8, vp + row * a.vs + c * 8, ok);
    }
  };
  if (ntiles > 0) load_kv(lo, 0);
  cp_async_commit();

  int rlo[RA][2], rhi[RA][2];
  thread_rows<RA>(a, sp, r0, wr0, nrows, G, g, rlo, rhi);
  float o[RA][DB][4];
  float m[RA][2], l[RA][2];
#pragma unroll
  for (int ra = 0; ra < RA; ++ra) {
#pragma unroll
    for (int i = 0; i < DB; ++i) o[ra][i][0] = o[ra][i][1] = o[ra][i][2] = o[ra][i][3] = 0.f;
    m[ra][0] = m[ra][1] = NEG;
    l[ra][0] = l[ra][1] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = lo + t * BKN;
    if (t + 1 < ntiles) load_kv(t0 + BKN, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * BKN * LD;
    const bf16* Vt = Vs + (t & 1) * BKN * LD;

    float s[RA][NB][4];
#pragma unroll
    for (int ra = 0; ra < RA; ++ra)
#pragma unroll
      for (int n = 0; n < NB; ++n) s[ra][n][0] = s[ra][n][1] = s[ra][n][2] = s[ra][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[RA][4];
#pragma unroll
      for (int ra = 0; ra < RA; ++ra)
        ldmatrix_x4(qa[ra], Qs + (wr0 + ra * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int ra = 0; ra < RA; ++ra) {
          mma16816(s[ra][2 * n2], qa[ra], kb[0], kb[1]);
          mma16816(s[ra][2 * n2 + 1], qa[ra], kb[2], kb[3]);
        }
      }
    }

    float corr[RA][2];
    softmax_step<RA, NB>(a, s, m, l, corr, rlo, rhi, t0, t4);
#pragma unroll
    for (int ra = 0; ra < RA; ++ra) {
#pragma unroll
      for (int i = 0; i < DB; ++i) {
        o[ra][i][0] *= corr[ra][0];
        o[ra][i][1] *= corr[ra][0];
        o[ra][i][2] *= corr[ra][1];
        o[ra][i][3] *= corr[ra][1];
      }
    }

    // O += P V: P's C fragments of two 8-key blocks are an A fragment
#pragma unroll
    for (int kc = 0; kc < BKN / 16; ++kc) {
      uint32_t pa[RA][4];
#pragma unroll
      for (int ra = 0; ra < RA; ++ra) {
        pa[ra][0] = pack_bf16(s[ra][2 * kc][0], s[ra][2 * kc][1]);
        pa[ra][1] = pack_bf16(s[ra][2 * kc][2], s[ra][2 * kc][3]);
        pa[ra][2] = pack_bf16(s[ra][2 * kc + 1][0], s[ra][2 * kc + 1][1]);
        pa[ra][3] = pack_bf16(s[ra][2 * kc + 1][2], s[ra][2 * kc + 1][3]);
      }
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  d2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int ra = 0; ra < RA; ++ra) {
          mma16816(o[ra][2 * d2], pa[ra], vb[0], vb[1]);
          mma16816(o[ra][2 * d2 + 1], pa[ra], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();   // Q rows land before a warp reuses them (no tile: no barrier yet)

  // normalise, stage the warp's rows in its own Q rows, store 16 bytes a lane
  bf16* Ow = Qs + wr0 * LD;
#pragma unroll
  for (int ra = 0; ra < RA; ++ra) {
    float inv[2];
    inv_sums(l[ra], inv);
#pragma unroll
    for (int i = 0; i < DB; ++i) {
      *reinterpret_cast<uint32_t*>(Ow + (ra * 16 + g) * LD + i * 8 + 2 * t4) =
          pack_bf16(o[ra][i][0] * inv[0], o[ra][i][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(Ow + (ra * 16 + g + 8) * LD + i * 8 + 2 * t4) =
          pack_bf16(o[ra][i][2] * inv[1], o[ra][i][3] * inv[1]);
    }
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.o);
  for (int e = lane; e < 16 * RA * CH; e += 32) {
    const int r = e / CH, c = e - (e / CH) * CH;
    const int rw = wr0 + r;
    if (rw < nrows) {
      const int rr = r0 + rw;
      const int sq = rr / G, h = hk * G + rr % G;
      *reinterpret_cast<uint4*>(out + b * a.ob + sq * a.os + h * a.oh + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + c * 8);
    }
  }
}

// A tensor-core kernel over a 1-d grid: ceil(rows / ROWS) row tiles times
// every (kv head, batch row), with smem bytes of dynamic shared memory
cudaError_t launch_rows(void (*kernel)(Args), size_t smem, int threads, int ROWS, const Args& a,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = a.H / a.Hkv * a.Sq;
  const int64_t blocks = (int64_t)((rows + ROWS - 1) / ROWS) * a.Hkv * a.B;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  return launch_rows(flash_attention_mma_kernel<HD>, MmaTile<HD>::smem, MMA_THREADS,
                     MmaTile<HD>::ROWS, a, stream);
}

// ---------------------------------------------------------------------------
// MMA at MLA's shapes: bf16, hd 576 over values that are the keys' 512-wide
// prefix, warps in pairs over the dims (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int MLA_HD = 576, MLA_DV = 512;
constexpr int MLA_ROWS = 64;                 // query rows per block: 4 row atoms
constexpr int MLA_BKN = 32;                  // keys per K tile
constexpr int MLA_LD = MLA_HD + 8;           // smem row stride (elements)
constexpr int MLA_THREADS = 256;             // 8 warps: pair p is warps p and p + 4
constexpr int MLA_KH = MLA_HD / 2;           // the key dims a warp scores over
constexpr int MLA_VH = MLA_DV / 2;           // the value columns a warp accumulates
constexpr size_t MLA_SMEM = sizeof(bf16) * (size_t)(MLA_ROWS + 2 * MLA_BKN) * MLA_LD +
                            sizeof(float) * (size_t)(MLA_THREADS / 32) * 16 * MLA_BKN;
static_assert(MLA_SMEM <= MAX_SMEM, "MLA's tiles must fit one block's shared memory");

__global__ void __launch_bounds__(MLA_THREADS, 1)
flash_attention_mla_kernel(Args a) {
  constexpr int NB = MLA_BKN / 8;      // 8-key blocks of S per tile
  constexpr int DB = MLA_VH / 8;       // 8-column blocks of the warp's O
  constexpr int CH = MLA_HD / 8;       // 16-byte chunks per row
  constexpr int LD = MLA_LD;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);                     // [64][LD]
  bf16* Ks = Qs + MLA_ROWS * LD;                                   // [2][32][LD]
  float4* Xs = reinterpret_cast<float4*>(Ks + 2 * MLA_BKN * LD);   // [8 warps][NB][32 lanes]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pair = warp & 3, half = warp >> 2;
  // longest first over the whole grid, as the MMA kernel
  const int G = a.H / a.Hkv;
  const int pairs = a.Hkv * a.B;
  const int hk = (int)(blockIdx.x % pairs) % a.Hkv, b = (int)(blockIdx.x % pairs) / a.Hkv;
  const int r0 = (int)(gridDim.x / pairs - 1 - blockIdx.x / pairs) * MLA_ROWS;
  const int nrows = min(MLA_ROWS, G * a.Sq - r0);
  const Span sp = span_of(a, b, r0, nrows, G);
  const int lo = sp.lo, hi = sp.hi;
  const int wr0 = pair * 16;                       // the pair's first row
  const int kc0 = half * MLA_KH;                   // the warp's first key dim
  const int vc0 = half * MLA_VH;                   // the warp's first value column

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < MLA_ROWS * CH; e += MLA_THREADS) {
    const int r = e / CH, c = e - (e / CH) * CH;
    const int rr = r0 + min(r, nrows - 1);
    const int sq = rr / G, h = hk * G + rr % G;
    cp_async16(Qs + r * LD + c * 8, q + b * a.qb + sq * a.qs + h * a.qh + c * 8, r < nrows);
  }
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.kb + hk * a.kh;
  const int ntiles = hi > lo ? (hi - lo + MLA_BKN - 1) / MLA_BKN : 0;
  auto load_k = [&](int t0, int buf) {
    for (int e = tid; e < MLA_BKN * CH; e += MLA_THREADS) {
      const int j = e / CH, c = e - (e / CH) * CH;
      const bool ok = t0 + j < hi;
      const int64_t row = ok ? t0 + j : t0;
      cp_async16(Ks + (buf * MLA_BKN + j) * LD + c * 8, kp + row * a.ks + c * 8, ok);
    }
  };
  if (ntiles > 0) load_k(lo, 0);
  cp_async_commit();

  int rlo[1][2], rhi[1][2];
  thread_rows<1>(a, sp, r0, wr0, nrows, G, g, rlo, rhi);
  float o[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[1][2] = {{NEG, NEG}}, l[1][2] = {{0.f, 0.f}};

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = lo + t * MLA_BKN;
    if (t + 1 < ntiles) load_k(t0 + MLA_BKN, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * MLA_BKN * LD;

    // this warp's half of the dims: the partial S of the pair's 16 rows
    float s[1][NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[0][n][0] = s[0][n][1] = s[0][n][2] = s[0][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MLA_KH / 16; ++kk) {
      const int col = kc0 + kk * 16;
      uint32_t qa[4];
      ldmatrix_x4(qa, Qs + (wr0 + (lane & 15)) * LD + col + (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + col +
                            ((lane >> 3) & 1) * 8);
        mma16816(s[0][2 * n2], qa, kb[0], kb[1]);
        mma16816(s[0][2 * n2 + 1], qa, kb[2], kb[3]);
      }
    }
    // the pair's two partials, added in both warps (a + b == b + a exactly)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      Xs[(warp * NB + n) * 32 + lane] = make_float4(s[0][n][0], s[0][n][1], s[0][n][2], s[0][n][3]);
    bar_sync(1 + pair, 64);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float4 x = Xs[((warp ^ 4) * NB + n) * 32 + lane];
      s[0][n][0] += x.x;
      s[0][n][1] += x.y;
      s[0][n][2] += x.z;
      s[0][n][3] += x.w;
    }

    float corr[1][2];
    softmax_step<1, NB>(a, s, m, l, corr, rlo, rhi, t0, t4);
#pragma unroll
    for (int i = 0; i < DB; ++i) {
      o[i][0] *= corr[0][0];
      o[i][1] *= corr[0][0];
      o[i][2] *= corr[0][1];
      o[i][3] *= corr[0][1];
    }

    // O += P V over the warp's value columns, V read from the K tile
#pragma unroll
    for (int kc = 0; kc < MLA_BKN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[0][2 * kc][0], s[0][2 * kc][1]);
      pa[1] = pack_bf16(s[0][2 * kc][2], s[0][2 * kc][3]);
      pa[2] = pack_bf16(s[0][2 * kc + 1][0], s[0][2 * kc + 1][1]);
      pa[3] = pack_bf16(s[0][2 * kc + 1][2], s[0][2 * kc + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < DB / 2; ++d2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Kt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + vc0 +
                                  d2 * 16 + (lane >> 4) * 8);
        mma16816(o[2 * d2], pa, vb[0], vb[1]);
        mma16816(o[2 * d2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer and Xs before they are refilled
  }
  cp_async_wait<0>();
  __syncthreads();     // Q rows land before a warp reuses them (no tile: no barrier yet)

  // normalise, stage the warp's columns in the pair's Q rows, store 16 bytes a lane
  bf16* Ow = Qs + wr0 * LD + vc0;
  float inv[2];
  inv_sums(l[0], inv);
#pragma unroll
  for (int i = 0; i < DB; ++i) {
    *reinterpret_cast<uint32_t*>(Ow + g * LD + i * 8 + 2 * t4) =
        pack_bf16(o[i][0] * inv[0], o[i][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * LD + i * 8 + 2 * t4) =
        pack_bf16(o[i][2] * inv[1], o[i][3] * inv[1]);
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.o);
  constexpr int OCH = MLA_VH / 8;                  // 16-byte chunks of the warp's columns
  for (int e = lane; e < 16 * OCH; e += 32) {
    const int r = e / OCH, c = e - (e / OCH) * OCH;
    const int rw = wr0 + r;
    if (rw < nrows) {
      const int rr = r0 + rw;
      const int sq = rr / G, h = hk * G + rr % G;
      *reinterpret_cast<uint4*>(out + b * a.ob + sq * a.os + h * a.oh + vc0 + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + c * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// SPLIT: decode as split-KV, f32 math
// ---------------------------------------------------------------------------

// the partial states: m [B][Hkv][nsplit][16], then l of the same shape, then
// acc [B][Hkv][nsplit][16][dv]
struct Parts {
  float *m, *l, *acc;
};
__device__ __forceinline__ Parts parts_of(const Args& a) {
  const size_t ml = (size_t)a.B * a.Hkv * a.nsplit * SPLIT_ROWS;
  return Parts{a.part, a.part + ml, a.part + 2 * ml};
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
flash_attention_split_kernel(Args a) {
  constexpr int VN = VecN<T>::N;
  constexpr int NWARP = SPLIT_THREADS / 32;
  extern __shared__ float4 smem4[];
  const int hd = a.hd, dv = a.dv;
  const int ldk = hd + VN;                                     // +16 bytes a row
  const int ldv = a.v_in_k ? ldk : dv + VN;
  float* Qs = reinterpret_cast<float*>(smem4);                 // [16][hd]
  float* Ps = Qs + SPLIT_ROWS * hd;                            // [16][32]
  T* Ks = reinterpret_cast<T*>(Ps + SPLIT_ROWS * SPLIT_KEYS);  // [32][ldk]
  T* Vs = a.v_in_k ? Ks : Ks + SPLIT_KEYS * ldk;               // [32][ldv]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int rows = G * a.Sq;
  const Span sp = span_of(a, b, 0, rows, G);
  const int c0 = max(sp.lo, split * SPLIT_KEYS);
  const int c1 = min(sp.hi, split * SPLIT_KEYS + SPLIT_KEYS);
  const Parts P = parts_of(a);
  const size_t pid = ((size_t)b * a.Hkv + hk) * a.nsplit + split;
  float* pm = P.m + pid * SPLIT_ROWS;
  float* pl = P.l + pid * SPLIT_ROWS;
  float* pacc = P.acc + pid * SPLIT_ROWS * dv;
  if (c0 >= c1) {
    if (tid < rows) {
      pm[tid] = NEG;
      pl[tid] = 0.f;
    }
    return;
  }
  const int nk = c1 - c0;
  const int nch = hd / VN;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;
  for (int e = tid; e < SPLIT_KEYS * nch; e += SPLIT_THREADS) {
    const int j = e / nch, c = e - (e / nch) * nch;
    const bool ok = j < nk;
    const int64_t row = ok ? c0 + j : c0;
    cp_async16(Ks + j * ldk + c * VN, kp + row * a.ks + c * VN, ok);
  }
  if (!a.v_in_k) {
    const int nvch = dv / VN;
    for (int e = tid; e < SPLIT_KEYS * nvch; e += SPLIT_THREADS) {
      const int j = e / nvch, c = e - (e / nvch) * nvch;
      const bool ok = j < nk;
      const int64_t row = ok ? c0 + j : c0;
      cp_async16(Vs + j * ldv + c * VN, vp + row * a.vs + c * VN, ok);
    }
  }
  cp_async_commit();
  const T* q = static_cast<const T*>(a.q);
  for (int e = tid; e < rows * nch; e += SPLIT_THREADS) {
    const int r = e / nch, c = e - (e / nch) * nch;
    const int sq = r / G, h = hk * G + r % G;
    float buf[VN];
    load16(q + b * a.qb + sq * a.qs + h * a.qh + c * VN, buf);
    put<VN>(Qs + r * hd + c * VN, buf);
  }
  cp_async_wait<0>();
  __syncthreads();

  // lane j scores key c0 + j against rows warp, warp + 4, ...; the warp then
  // holds whole rows, so their max and sum are warp reductions (the rows'
  // chains interleaved)
  constexpr int RPW = SPLIT_ROWS / NWARP;   // rows per warp
  float s[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) s[i] = 0.f;
  const T* krow = Ks + lane * ldk;
  for (int d = 0; d < hd; d += VN) {
    float kf[VN];
    load16(krow + d, kf);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NWARP * i;
      if (r < rows) {
        const float* qr = Qs + r * hd + d;
#pragma unroll
        for (int v4 = 0; v4 < VN; v4 += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qr + v4);
          s[i] += qq.x * kf[v4] + qq.y * kf[v4 + 1] + qq.z * kf[v4 + 2] + qq.w * kf[v4 + 3];
        }
      }
    }
  }
  const int key = c0 + lane;
  float mx[RPW], p[RPW], sum[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NWARP * i;
    bool ok = false;
    if (r < rows && lane < nk) {
      int rlo, rhi;
      row_bounds(a, sp, sp.q_offset + r / G, rlo, rhi);
      ok = key >= rlo && key < rhi;
    }
    s[i] = ok ? cap(a, s[i]) : -INFINITY;
    mx[i] = s[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < RPW; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], off));
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    mx[i] = fmaxf(mx[i], NEG);                // a row with no key here: m = -1e30, l = 0
    p[i] = expf(s[i] - mx[i]);
    sum[i] = p[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < RPW; ++i) sum[i] += __shfl_xor_sync(FULL, sum[i], off);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NWARP * i;
    if (r < rows) {
      Ps[r * SPLIT_KEYS + lane] = p[i];
      if (lane == 0) {
        pm[r] = mx[i];
        pl[r] = sum[i];
      }
    }
  }
  __syncthreads();

  // acc[r][d .. d + 3] = sum_j p[r][j] v[j][d .. d + 3]: four chains a thread
  const int nd4 = dv / 4;
  for (int e = tid; e < rows * nd4; e += SPLIT_THREADS) {
    const int r = e / nd4, d = (e - (e / nd4) * nd4) * 4;
    const float* pr = Ps + r * SPLIT_KEYS;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vv[4];
      load4(Vs + j * ldv + d, vv);
      const float pj = pr[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += pj * vv[i];
    }
    *reinterpret_cast<float4*>(pacc + r * dv + d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// A block per (query row, kv head, batch row). Warp 0 lists the splits that
// saw a key (l > 0) in shared memory, compacted, with their weights
// e^(m - M), and sums L; then every thread sums its head dims over the list
// (no branch in that loop, so its loads go out together).
template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
flash_attention_merge_kernel(Args a) {
  extern __shared__ float wsm[];                 // [nsplit] weights, then [nsplit] indices
  __shared__ float Lsh;
  __shared__ int nlive;
  int* live = reinterpret_cast<int*>(wsm + a.nsplit);
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = a.H / a.Hkv, dv = a.dv, nsplit = a.nsplit;
  const Parts P = parts_of(a);
  const size_t p0 = ((size_t)b * a.Hkv + hk) * nsplit;
  if (tid < 32) {
    float M = NEG;
    for (int c = tid; c < nsplit; c += 32) {
      const size_t i = (p0 + c) * SPLIT_ROWS + r;
      if (P.l[i] > 0.f) M = fmaxf(M, P.m[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
    float L = 0.f;
    int n = 0;
    for (int c0 = 0; c0 < nsplit; c0 += 32) {   // warp-uniform trip count
      const int c = c0 + tid;
      const size_t i = (p0 + c) * SPLIT_ROWS + r;
      const float l = c < nsplit ? P.l[i] : 0.f;
      const bool ok = l > 0.f;
      const unsigned bal = __ballot_sync(FULL, ok);
      if (ok) {
        const float w = expf(P.m[i] - M);
        const int slot = n + __popc(bal & ((1u << tid) - 1u));
        wsm[slot] = w;
        live[slot] = c;
        L += l * w;
      }
      n += __popc(bal);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(FULL, L, off);
    if (tid == 0) {
      Lsh = L;
      nlive = n;
    }
  }
  __syncthreads();
  const float inv = 1.f / fmaxf(Lsh, 1e-30f);
  const int n = nlive;
  T* o = static_cast<T*>(a.o);
  const int sq = r / G, h = hk * G + r % G;
  const float* acc = P.acc + (p0 * SPLIT_ROWS + r) * dv;
  for (int d = tid; d < dv; d += SPLIT_THREADS) {
    float A = 0.f;
#pragma unroll 8
    for (int t = 0; t < n; ++t) A += wsm[t] * acc[(size_t)live[t] * SPLIT_ROWS * dv + d];
    store(o + b * a.ob + sq * a.os + h * a.oh + d, A * inv);
  }
}

template <typename T>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)SPLIT_ROWS * (a.hd + SPLIT_KEYS) +
                      sizeof(T) * (size_t)SPLIT_KEYS *
                          ((a.hd + VecN<T>::N) + (a.v_in_k ? 0 : a.dv + VecN<T>::N));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_split_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_attention_split_kernel<T><<<dim3((unsigned)a.nsplit, (unsigned)a.Hkv, (unsigned)a.B),
                                    SPLIT_THREADS, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t wsmem = 2 * sizeof(float) * (size_t)a.nsplit;
  if (wsmem > 48 * 1024) {
    e = cudaFuncSetAttribute(flash_attention_merge_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
    if (e != cudaSuccess) return e;
  }
  const int rows = a.H / a.Hkv * a.Sq;
  flash_attention_merge_kernel<T><<<dim3((unsigned)rows, (unsigned)a.Hkv, (unsigned)a.B),
                                    SPLIT_THREADS, wsmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// What every call with one signature of q, k and v passes (built once per
// signature by the wrapper, kernels/flash_attention.py::_plan).
struct Plan {
  int32_t form;     // 0 SIMT, 1 MMA (bf16: hd = dv in 64 / 80 / 128 / 256, or hd 576 over
                    // dv 512 in k), 2 SPLIT ((H / Hkv) * Sq <= 16)
  int32_t dtype;    // 0 float32, 1 bfloat16 (q, k, v and out share it)
  int64_t B, Sq, Skv, H, Hkv, hd, dv;   // k is [B, Skv, Hkv, hd], v [B, Skv, Hkv, dv]
  int64_t nsplit;   // SPLIT: max(1, ceil(Skv / 32)); else 0
  int64_t strides[12];   // q, k, v, out: each batch, seq, head, in elements
};

// part: SPLIT's f32 scratch of B * Hkv * nsplit * 16 * (dv + 2) floats, else
// null. q_offset_ptr / kv_len_ptr: int32 device scalars or null (then the
// int beside them is used); kv_start: int32 [B] or null. The head dim is
// contiguous. Returns a cudaError_t (0 = success).
extern "C" int repro_flash_attention(const Plan* p, const void* q, const void* k,
                                     const void* v, void* o, int causal, int window,
                                     float softcap, int q_offset, const void* q_offset_ptr,
                                     int kv_len, const void* kv_len_ptr, const void* kv_start,
                                     void* part, void* stream) {
  const int64_t B = p->B, Sq = p->Sq, Skv = p->Skv, H = p->H, Hkv = p->Hkv, hd = p->hd,
                dv = p->dv;
  const int form = p->form, dtype = p->dtype;
  const int64_t nsplit = p->nsplit;
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || hd < 8 || hd > MAX_HD || hd % 8 != 0 || dv < 8 ||
      dv > hd || dv % 8 != 0 || B > 65535 ||
      Hkv > 65535 || (H / Hkv) * Sq > (int64_t)1 << 30 || Skv < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (H / Hkv) * Sq;
  if (form == SPLIT && (rows > SPLIT_ROWS || part == nullptr ||
                        nsplit != (Skv > SPLIT_KEYS ? (Skv + SPLIT_KEYS - 1) / SPLIT_KEYS : 1)))
    return (int)cudaErrorInvalidValue;
  const bool mla = hd == MLA_HD && dv == MLA_DV;
  if (form == MMA && (dtype != 1 || !(mla || (dv == hd && (hd == 64 || hd == 80 || hd == 128 ||
                                                              hd == 256)))))
    return (int)cudaErrorInvalidValue;
  if (form != SIMT && form != MMA && form != SPLIT) return (int)cudaErrorInvalidValue;
  const int64_t* strides = p->strides;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.qb = strides[0]; a.qs = strides[1]; a.qh = strides[2];
  a.kb = strides[3]; a.ks = strides[4]; a.kh = strides[5];
  a.vb = strides[6]; a.vs = strides[7]; a.vh = strides[8];
  a.ob = strides[9]; a.os = strides[10]; a.oh = strides[11];
  a.v_in_k = v == k && a.vb == a.kb && a.vs == a.ks && a.vh == a.kh;
  if (form == MMA && mla && !a.v_in_k) return (int)cudaErrorInvalidValue;
  a.B = (int)B; a.Sq = (int)Sq; a.Skv = (int)Skv; a.H = (int)H; a.Hkv = (int)Hkv;
  a.hd = (int)hd;
  a.dv = (int)dv;
  a.causal = causal; a.window = window;
  a.softcap = softcap;
  a.scale = (float)(1.0 / sqrt((double)hd));   // f32 of hd^-0.5, as the reference rounds it
  a.q_offset = q_offset; a.kv_len = kv_len;
  a.q_offset_ptr = static_cast<const int*>(q_offset_ptr);
  a.kv_len_ptr = static_cast<const int*>(kv_len_ptr);
  a.kv_start = static_cast<const int*>(kv_start);
  a.part = static_cast<float*>(part);
  a.nsplit = (int)nsplit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == MMA) {
    if (mla)
      return (int)launch_rows(flash_attention_mla_kernel, MLA_SMEM, MLA_THREADS, MLA_ROWS, a, st);
    if (hd == 64) return (int)launch_mma<64>(a, st);
    if (hd == 80) return (int)launch_mma<80>(a, st);
    if (hd == 128) return (int)launch_mma<128>(a, st);
    return (int)launch_mma<256>(a, st);
  }
  if (form == SPLIT)
    return (int)(dtype == 0 ? launch_split<float>(a, st) : launch_split<__nv_bfloat16>(a, st));
  return (int)(dtype == 0 ? dispatch<float>(a, st) : dispatch<__nv_bfloat16>(a, st));
}
