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
// the SIMT and SPLIT forms and MMA (MLA's kernel) read the values from the
// K tile they already hold.
//
// Four forms compute this function. The wrapper picks one from host-known
// shapes alone (kernels/flash_attention.py::_form; never from kv_len, which
// is a device scalar) and passes it in:
//
//   rows = (H / Hkv) * Sq, the query rows that share one kv head
//   rows <= 16                              -> SPLIT (decode; f32 and bf16, any hd)
//   bf16, hd in {64, 80, 128, 256}, dv = hd -> WGMMA (prefill on Hopper's warpgroup MMA)
//   bf16, hd 576, dv 512, v in k            -> MMA   (MLA's prefill: mma.sync, its own kernel)
//   otherwise                               -> SIMT  (f32 prefill, other shapes)
//
// Every form visits only the keys in [lo, hi): lo the largest of
// kv_start[b] and the window's lower edge for the block's first query, hi
// the smallest of kv_len, Skv and (causal) its last query + 1. Keys outside
// are never read (staged as zeros where a tile overhangs; WGMMA's TMA loads
// a whole last tile and zeroes its V rows from kv_len on in shared memory), and
// a key masked for one row has its probability selected to 0, so whatever
// garbage lies below kv_start or past kv_len contributes exactly nothing.
// This is exact for any row with at least one visible key, since the first
// visible key's correction exp(-1e30 - m) is exactly 0 in the reference
// too. A row with no visible key at all is out of contract (no path
// produces one): it gives 0 here and the mean of v in the reference. Query
// rows are packed s-major, row r being query s = r / G of head g = r % G (G
// = H / Hkv), so every K/V row a block reads serves all G heads.
//
// WGMMA (bf16, hd = dv in 64 / 80 / 128 / 256; FA3's structure on wgmma and
// TMA). A persistent kernel: one block of two warpgroups (256 threads) on
// each SM, two at hd 64 and 80, walks the work items, 128 query rows of
// one (batch row, kv head) each. The items run pair-major: the row tiles of
// one (batch row, kv head) read the same keys, so they run side by side and
// their K/V tiles come from L2 (one after another by kv pair, 64 pairs'
// keys at once overflowed it at 1601 keys); within a pair the last row tile
// first, as it sees the most keys under causal masking. Each warpgroup owns
// 64 rows (wgmma's M) and copies them once with cp.async, into a second Q
// buffer during the item before where shared memory allows. K and V tiles
// (128 keys at hd 128, 64 at hd 64, 80 and 256) arrive by TMA, each into a
// ring of 2 stages whose "full" mbarrier the copy's bytes complete. Each
// tensor map is 4-d over [B, Skv, Hkv, hd] with the caller's strides,
// encoded by the host for every call (cuTensorMapEncodeTiled, found through
// cudaGetDriverEntryPoint) and passed as a __grid_constant__; rows past Skv
// arrive as zeros. No warp is set aside to load: the warp that releases a
// stage last (a count in shared memory) loads the ring's next tile into it,
// from a cursor that every warp moves on alike, into the next work item
// too. (A producer warp, or warpgroup, makes 9 or 12 warps a block, and
// ptxas then caps every thread at 168 registers, setmaxnreg or not: O, S
// and P of a 128-key tile at hd 128 spilled. Eight warps take up to 255.)
// The head dim lies in 64-wide chunks of 128-byte rows under the 128-byte
// swizzle (TMA's and wgmma's shared layout) and, at hd 80, a 16-wide tail
// of 32-byte rows under the 32-byte swizzle. S = Q K^T is wgmma
// m64nBKNk16 with both operands read from shared memory through
// descriptors (4 k-steps a chunk, one for the tail); O += P V takes P from
// registers (S's f32 accumulator rounded to bf16 in place: a thread holds
// rows g and g + 8 of its warp's 16, as the m16n8k16 MMA's C, so P's C fragments
// are A fragments and the row max and sum are quad shuffles) and V as an
// MN-major operand (at hd 80 a second wgmma of N = 16 over the tail). Tile
// t's S is issued beside tile t - 1's P V, so a warpgroup's softmax runs
// under its own product, and the two warpgroups take turns at the tensor
// cores (named barriers), so one's softmax runs under the other's products.
// The softmax is MMA's in fewer instructions: scores in log2 units, one
// FFMA and one ex2 each, masks selected to -inf only on tiles that some row
// of the warp does not wholly see, O rescaled only when some row's max
// moved; the running max, sum and O stay in f32 registers, O is normalised
// in f32, cast once and staged through the item's Q rows into 16-byte
// stores.
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
// bytes, for prefill and decode alike. WGMMA keeps the K/V traffic at one
// read per 128 query rows and the math on the tensor cores at their full
// rate, with the loads off the computing warps; SPLIT spreads the decode
// keys over 32 times as many blocks as one per (batch row, kv head) would.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -split-compile=0 -shared
//     -Xcompiler -fPIC
// and called through ctypes (plain C entry point below).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int RW = 8;            // query rows per block (SIMT)
constexpr int BK = 32;           // keys per warp tile, one per lane (SIMT)
constexpr float NEG = -1e30f;    // the reference's finite mask value
constexpr unsigned FULL = 0xffffffffu;
constexpr int SPLIT_KEYS = 32;   // keys per split (SPLIT): a key per lane
constexpr int SPLIT_ROWS = 16;   // most query rows per kv head (SPLIT)
constexpr int SPLIT_THREADS = 128;
constexpr int MAX_HD = 576;              // MLA's 512 + 64
constexpr size_t MAX_SMEM = 232448;      // the dynamic shared memory a block may opt in to
enum Form { SIMT = 0, MMA = 1, SPLIT = 2, WGMMA = 3 };

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
// The tensor-core forms' shared pieces: the softmax step and the rows'
// ranges (WGMMA and MMA), and mma.sync's (MMA at MLA's shapes)
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

// softmax_step for one 64-row warpgroup tile (the WGMMA form): the same
// function in fewer instructions. The max is taken over the raw scores
// (scaling by a positive factor, and the softcap's tanh, keep the order),
// each probability is one FFMA and one ex2 (p = 2^(s * scale * log2 e - m)),
// and the max and the sum run as four independent chains a row. Returns
// whether some row of the warp has a new max (O then needs rescaling).
template <int NB>
__device__ __forceinline__ bool softmax_wg(const Args& a, float (&s)[1][NB][4], float (&m)[1][2],
                                           float (&l)[1][2], float (&corr)[1][2],
                                           const int (&rlo)[1][2], const int (&rhi)[1][2], int t0,
                                           int t4) {
  constexpr float LOG2E = 1.4426950408889634f;
  bool full = rlo[0][0] <= t0 && rhi[0][0] >= t0 + 8 * NB && rlo[0][1] <= t0 &&
              rhi[0][1] >= t0 + 8 * NB;
  full = __all_sync(FULL, full);
  const bool capped = a.softcap > 0.f;
  if (capped) {                 // a uniform branch around the loop, never per score
    const float cap_in = a.scale / a.softcap, cap_l2 = a.softcap * LOG2E;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[0][n][i] = cap_l2 * tanhf(s[0][n][i] * cap_in);
  }
  if (!full) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = t0 + n * 8 + 2 * t4 + (i & 1);
        const int hh = i >> 1;
        if (!(key >= rlo[0][hh] && key < rhi[0][hh])) s[0][n][i] = -INFINITY;
      }
  }
  // scores to log2 units: capped ones are there already
  const float sl2 = capped ? 1.f : a.scale * LOG2E;
  float mx[2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[hh][j] = -INFINITY;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1][(n & 1) * 2 + (i & 1)] =
        fmaxf(mx[i >> 1][(n & 1) * 2 + (i & 1)], s[0][n][i]);
  float nm[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float v = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
    v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
    v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
    const float mn = fmaxf(m[0][hh], v * sl2);
    corr[0][hh] = exp2_approx(m[0][hh] - mn);
    m[0][hh] = mn;
    nm[hh] = -mn;
  }
  float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = exp2_approx(fmaf(s[0][n][i], sl2, nm[i >> 1]));
      s[0][n][i] = p;
      sum[i >> 1][(n & 1) * 2 + (i & 1)] += p;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[0][hh] = l[0][hh] * corr[0][hh] + ((sum[hh][0] + sum[hh][1]) + (sum[hh][2] + sum[hh][3]));
  return __any_sync(FULL, corr[0][0] != 1.f || corr[0][1] != 1.f);
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

// ---------------------------------------------------------------------------
// WGMMA: bf16 prefill on Hopper's warpgroup MMA, K/V by TMA (see the note at
// the top)
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 256;     // two warpgroups (8 warps: up to 255 registers a thread)
constexpr int WG_ROWS = 128;        // query rows of a work item: wgmma's 64 a warpgroup
constexpr uint64_t SW128 = 1, SW32 = 3;   // wgmma descriptors' swizzled layouts

// Shared memory of the WGMMA kernel, in bytes from a 1024-aligned base: the
// Q buffers (two where they fit: the next work item's Q loads during this
// one), then the K ring, then the V ring, then the barriers. The head dim is
// cut into 64-wide chunks of 128-byte rows (the 128-byte swizzle) and, at hd
// 80, a 16-wide tail of 32-byte rows (the 32-byte swizzle); a Q buffer or a
// K or V tile is its chunks one after another, each [rows][128 B], then its
// tail [rows][32 B].
template <int HD>
struct WgTile {
  static constexpr int NCH = HD / 64;                // 64-wide chunks
  static constexpr int TAIL = HD % 64;               // 16 at hd 80, else 0
  static constexpr int BLOCKS = HD <= 80 ? 2 : 1;    // blocks an SM (128 registers a thread at 2)
  static constexpr int BKN = HD == 128 ? 128 : 64;   // keys per K / V tile
  static constexpr int STAGES = 2;                   // K and V tiles in flight, each
  static constexpr int NB = BKN / 8;                 // 8-key blocks of S
  static constexpr int CH = HD / 8;                  // 16-byte units per row
  static constexpr int QC = WG_ROWS * 128;           // one Q chunk
  static constexpr int QB = NCH * QC + WG_ROWS * TAIL * 2;   // one Q buffer
  static constexpr int KC = BKN * 128;               // one K or V chunk
  static constexpr int TILE = NCH * KC + BKN * TAIL * 2;     // one K or V tile (a TMA transaction)
  static constexpr int RING = 2 * STAGES * TILE;
  static constexpr int QBUF = (2 * QB + RING + 1024 + 64) * BLOCKS <= (int)MAX_SMEM ? 2 : 1;
  static constexpr int Q = 0, K = QBUF * QB, V = K + STAGES * TILE, BAR = V + STAGES * TILE;
  static constexpr int CNT = BAR + 2 * STAGES * 8;   // the rings' release counts
  static constexpr size_t smem = CNT + 2 * STAGES * 4 + 1024;   // + the base's alignment
  static_assert(HD == 64 * NCH + TAIL && (TAIL == 0 || TAIL == 16), "hd 64, 80, 128 or 256");
  static_assert(QB % 1024 == 0 && TILE % 1024 == 0, "chunks stay 1024-aligned");
  // an SM holds 228 KB, of which each block's own 1 KB is reserved
  static_assert((smem + 1024) * BLOCKS <= MAX_SMEM + 1024, "the WGMMA tiles must fit an SM");
};

// the byte offset of 16-byte unit c of row r of Q buffer qb, swizzled as TMA
// and wgmma lay it out: in a 64-wide chunk unit c ^ (r % 8) of the 128-byte
// row, in the 16-wide tail unit c ^ (r / 4 % 2) of the 32-byte row
template <int HD>
__device__ __forceinline__ uint32_t q_unit(int qb, int r, int c) {
  using T = WgTile<HD>;
  const uint32_t q = T::Q + qb * T::QB;
  if (c < 8 * T::NCH) return q + (c >> 3) * T::QC + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  return q + T::NCH * T::QC + r * 32 + (((c & 1) ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// a box of the 4-d map at coordinates (c0 innermost) into shared memory,
// completing bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// shared-memory writes of this thread before the async proxy's reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, layout
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of these registers across
// the asm statements around an asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (f32, m64nNk16) = or += A * B^T, A [64 x 16] and B [N x 16] both
// K-major in shared memory (descriptors); d = when !acc
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (f32, m64nNk16) += A * B, A [64 x 16] bf16 fragments in registers (as
// the m16n8k16 MMA's A: a thread's rows g and g + 8 of its warp's 16), B
// [16 x N] MN-major in shared memory (descriptor)

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// A persistent kernel: a block of 256 threads on each SM walks the work
// items, 128 query rows of one (batch row, kv head) each (s-major).
// Warpgroups 0 and 1 each own 64 rows (wgmma's M), load them by cp.async
// into the swizzled layout and, per tile of BKN keys, issue S = Q K^T (SS:
// both from shared memory), take the online softmax on S in registers (a
// thread holds rows g and g + 8 of its warp's 16, as the m16n8k16 MMA's
// C: quad shuffles), and issue O += P V (RS: P from registers, V an MN-major
// operand). Tile t's S is issued beside tile t - 1's P V, so the softmax of
// one overlaps the other's product. K and V tiles come by TMA into two
// rings of STAGES, each stage with a "full" mbarrier that the copy's bytes
// complete; the warp that releases a stage last (a count in shared memory)
// loads the ring's next tile into it, running on into the next work item.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, WgTile<HD>::BLOCKS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tkt,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tvt, const Args a) {
  using T = WgTile<HD>;
  constexpr int NCH = T::NCH, TAIL = T::TAIL, BKN = T::BKN, NB = T::NB, CH = T::CH;
  constexpr int S = T::STAGES;
  extern __shared__ uint4 wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = reinterpret_cast<uint8_t*>(wg_smem) + (base - raw);
  // "full" barriers of the K and V rings (S each), then their release counts
  const uint32_t full_k = base + T::BAR, full_v = full_k + 8 * S;
  int* const cnt_k = reinterpret_cast<int*>(sm + T::CNT);
  int* const cnt_v = cnt_k + S;

  // work item w: pair-major, so the row tiles of one (batch row, kv head),
  // which read the same keys, run side by side on neighbouring SMs and
  // their K/V tiles come from L2; within a pair the last row tile first
  // (under causal masking it sees the most keys)
  const int G = a.H / a.Hkv, rows = G * a.Sq;
  const int nrt = (rows + WG_ROWS - 1) / WG_ROWS;
  const int nwork = nrt * a.Hkv * a.B;
  auto item = [&](int w, int& b, int& hk, int& r0, int& nrows) {
    const int pair = w / nrt;
    hk = pair % a.Hkv;
    b = pair / a.Hkv;
    r0 = (nrt - 1 - (w - pair * nrt)) * WG_ROWS;
    nrows = min(WG_ROWS, rows - r0);
  };
  // The next tile a ring loads: keys from t0 (below hi) of work item w, or
  // none once w >= nwork. Every warp keeps one for each ring and moves it on
  // at each tile it releases, so all hold the same; the warp that releases
  // a stage last loads the cursor's tile into it.
  struct Cursor {
    int w, b, hk, t0, hi;
  };
  auto settle = [&](Cursor& c) {   // on to the next work item with a key, if need be
    while (c.t0 >= c.hi && (c.w += gridDim.x) < nwork) {
      int r0, nrows;
      item(c.w, c.b, c.hk, r0, nrows);
      const Span sp = span_of(a, c.b, r0, nrows, G);
      c.t0 = sp.lo;
      c.hi = sp.hi;
    }
  };
  auto step = [&](Cursor& c) {
    c.t0 += BKN;
    settle(c);
  };
  auto load = [&](const Cursor& c, int s, const CUtensorMap* map, const CUtensorMap* tail,
                  uint32_t ring, uint32_t full) {
    const uint32_t d = base + ring + s * T::TILE;
    mbar_expect_tx(full + 8 * s, T::TILE);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      tma_load(d + ch * T::KC, map, full + 8 * s, 64 * ch, c.t0, c.hk, c.b);
    if (TAIL) tma_load(d + NCH * T::KC, tail, full + 8 * s, 64 * NCH, c.t0, c.hk, c.b);
  };
  Cursor ck = {(int)blockIdx.x - (int)gridDim.x, 0, 0, 0, 0};
  settle(ck);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      cnt_k[s] = cnt_v[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {            // the rings' first tiles
    for (int s = 0; s < S && ck.w < nwork; ++s, step(ck)) {
      load(ck, s, &tk, &tkt, T::K, full_k);
      load(ck, s, &tv, &tvt, T::V, full_v);
    }
  } else {
    for (int s = 0; s < S && ck.w < nwork; ++s) step(ck);
  }
  Cursor cv = ck;

  const int cw = threadIdx.x >> 7, ct = threadIdx.x & 127;   // warpgroup, its thread
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const int wr0 = 64 * cw + 16 * (ct >> 5);                   // the warp's first row

  const bf16* q = static_cast<const bf16*>(a.q);
  auto load_q = [&](int w, int qb) {   // this warpgroup's 64 rows of item w
    int b, hk, r0, nrows;
    item(w, b, hk, r0, nrows);
    for (int e = ct; e < 64 * CH; e += 128) {
      const int rb = 64 * cw + e / CH, c = e - (e / CH) * CH;
      const int rr = r0 + min(rb, nrows - 1);
      const int sq = rr / G, h = hk * G + rr % G;
      cp_async16(sm + q_unit<HD>(qb, rb, c), q + b * a.qb + sq * a.qs + h * a.qh + c * 8,
                 rb < nrows);
    }
    cp_async_commit();
  };

  float o[NCH * 32], ot[TAIL ? 8 : 1];   // O: the chunks' 8-column blocks, the tail's two
  float s[1][NB][4];
  float(&sf)[BKN / 2] = *reinterpret_cast<float(*)[BKN / 2]>(&s[0][0][0]);
  uint32_t pa[BKN / 16][4];              // P as the A fragments of P V's k-steps
  float m[1][2], l[1][2], corr[1][2];
  int qb = 0;                            // this item's Q buffer
  auto issue_s = [&](int st) {
    const uint32_t qd = base + T::Q + qb * T::QB;   // this warpgroup's rows from 64 cw on
    const uint32_t qa = qd + cw * 64 * 128, qt = qd + NCH * T::QC + cw * 64 * 32;
    const uint32_t kd = base + T::K + st * T::TILE;
#pragma unroll
    for (int kk = 0; kk < 4 * NCH; ++kk) {
      const uint32_t c = kk >> 2, sub = (kk & 3) * 32;
      wgmma_ss(sf, gmma_desc(qa + c * T::QC + sub, 16, 1024, SW128),
               gmma_desc(kd + c * T::KC + sub, 16, 1024, SW128), kk > 0);
    }
    if constexpr (TAIL != 0)
      wgmma_ss(sf, gmma_desc(qt, 16, 256, SW32),
               gmma_desc(kd + NCH * T::KC, 16, 256, SW32), 1);
  };
  auto issue_pv = [&](int st) {
    const uint32_t vd = base + T::V + st * T::TILE;
#pragma unroll
    for (int kc = 0; kc < BKN / 16; ++kc) {
      wgmma_rs(o, pa[kc], gmma_desc(vd + kc * 2048, T::KC, 1024, SW128));
      if constexpr (TAIL != 0)
        wgmma_rs(ot, pa[kc], gmma_desc(vd + NCH * T::KC + kc * 512, 256, 256, SW32));
    }
  };
  // P's C fragments of two 8-key blocks are an A fragment of 16 keys
  auto pack_p = [&]() {
#pragma unroll
    for (int kc = 0; kc < BKN / 16; ++kc) {
      pa[kc][0] = pack_bf16(s[0][2 * kc][0], s[0][2 * kc][1]);
      pa[kc][1] = pack_bf16(s[0][2 * kc][2], s[0][2 * kc][3]);
      pa[kc][2] = pack_bf16(s[0][2 * kc + 1][0], s[0][2 * kc + 1][1]);
      pa[kc][3] = pack_bf16(s[0][2 * kc + 1][2], s[0][2 * kc + 1][3]);
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < NCH * 8; ++i) {
      o[4 * i] *= corr[0][0];
      o[4 * i + 1] *= corr[0][0];
      o[4 * i + 2] *= corr[0][1];
      o[4 * i + 3] *= corr[0][1];
    }
#pragma unroll
    for (int i = 0; i < TAIL / 8; ++i) {
      ot[4 * i] *= corr[0][0];
      ot[4 * i + 1] *= corr[0][0];
      ot[4 * i + 2] *= corr[0][1];
      ot[4 * i + 3] *= corr[0][1];
    }
  };
  // this warp is done with stage s of a ring: the 8th warp to say so
  // loads the ring's next tile into it (no warp ever waits for a stage to
  // empty, so no warp of its own is needed to load)
  auto release = [&](Cursor& c, int st, int* cnt, const CUtensorMap* map, const CUtensorMap* tail,
                     uint32_t ring, uint32_t full) {
    __syncwarp();
    if (lane == 0) {
      int seen;   // this warp's reads of the stage before the count, the count before the load
      asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                   : "=r"(seen)
                   : "r"(smem_u32(cnt + st))
                   : "memory");
      if (seen == 7) {
        cnt[st] = 0;
        if (c.w < nwork) load(c, st, map, tail, ring, full);
      }
    }
    step(c);
  };
  auto release_k = [&](int s) { release(ck, s, cnt_k, &tk, &tkt, T::K, full_k); };
  auto release_v = [&](int s) { release(cv, s, cnt_v, &tv, &tvt, T::V, full_v); };
  // the two warpgroups take turns issuing their products (named barriers
  // 4 and 5), so one's softmax runs under the other's products; in each
  // work item warpgroup 1 lets warpgroup 0 go first and skips the arrival
  // after its last turn, so every turn is matched
  auto turn = [&]() { bar_sync(4 + cw, 256); };
  auto pass = [&](bool last) {
    if (!(last && cw == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - cw) : "memory");
  };

  int it = 0;   // tiles consumed so far, over every work item
  if (blockIdx.x < nwork) load_q(blockIdx.x, 0);
  for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
    int b, hk, r0, nrows;
    item(w, b, hk, r0, nrows);
    const Span sp = span_of(a, b, r0, nrows, G);
    const int lo = sp.lo, hi = sp.hi;
    const int ntiles = hi > lo ? (hi - lo + BKN - 1) / BKN : 0;
    cp_async_wait<0>();                  // this item's Q rows
    fence_proxy_async();
    bar_sync(1 + cw, 128);
    if (T::QBUF == 2 && w + (int)gridDim.x < nwork) load_q(w + gridDim.x, qb ^ 1);

    int rlo[1][2], rhi[1][2];
    thread_rows<1>(a, sp, r0, wr0, nrows, G, g, rlo, rhi);
#pragma unroll
    for (int i = 0; i < NCH * 32; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (TAIL ? 8 : 1); ++i) ot[i] = 0.f;
    m[0][0] = m[0][1] = NEG;
    l[0][0] = l[0][1] = 0.f;

    if (ntiles > 0) {
      if (cw == 1) asm volatile("bar.arrive 4, 256;\n" ::: "memory");
      const int s0 = it % S;
      mbar_wait(full_k + 8 * s0, (it / S) & 1);
      turn();
      wg_fence();
      issue_s(s0);
      wg_commit();
      pass(false);
      wg_wait<0>();
      reg_fence(sf);
      release_k(s0);
      softmax_wg<NB>(a, s, m, l, corr, rlo, rhi, lo, t4);
      pack_p();
      for (int t = 1; t < ntiles; ++t) {
        const int st = (it + t) % S, pv = (it + t - 1) % S;
        mbar_wait(full_k + 8 * st, ((it + t) / S) & 1);
        mbar_wait(full_v + 8 * pv, ((it + t - 1) / S) & 1);
        turn();
        wg_fence();
        issue_s(st);
        wg_commit();
        issue_pv(pv);
        wg_commit();
        pass(false);
        wg_wait<1>();                    // S of tile t
        reg_fence(sf);
        release_k(st);
        const bool moved = softmax_wg<NB>(a, s, m, l, corr, rlo, rhi, lo + t * BKN, t4);
        wg_wait<0>();                    // P V of tile t - 1
        reg_fence(o);
        reg_fence(ot);
        release_v(pv);
        if (moved) rescale();
        pack_p();
      }
      const int lt = it + ntiles - 1, st = lt % S;
      mbar_wait(full_v + 8 * st, (lt / S) & 1);
      // the last tile's V rows from kv_len on may hold anything (NaN), and a
      // probability of 0 times NaN is NaN: zero them (TMA has zero-filled
      // those past Skv; the rows in [hi, kv_len) are keys, if masked ones)
      const int t0 = lo + (ntiles - 1) * BKN, z0 = max(hi, sp.kv_len) - t0,
                z1 = min(BKN, a.Skv - t0);
      if (z1 > z0) {
        const uint32_t vd = T::V + st * T::TILE;
        for (int e = ct + 128 * cw; e < (z1 - z0) * CH; e += 256) {
          const int j = z0 + e / CH, c = e - (e / CH) * CH;
          const uint32_t off = c < 8 * NCH ? vd + (c >> 3) * T::KC + j * 128 + (c & 7) * 16
                                           : vd + NCH * T::KC + j * 32 + (c & 1) * 16;
          *reinterpret_cast<uint4*>(sm + off) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        bar_sync(3, 256);                // both consumers' rows
      }
      turn();
      wg_fence();
      issue_pv(st);
      wg_commit();
      pass(true);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(ot);
      release_v(st);
      it += ntiles;
    }

    // normalise, stage the warp's rows in its own rows of this item's Q
    // buffer once every warp of the warpgroup is done reading it, store
    // 16 bytes a lane
    bar_sync(1 + cw, 128);
    float inv[2];
    inv_sums(l[0], inv);
#pragma unroll
    for (int i = 0; i < NCH * 8 + TAIL / 8; ++i) {
      const float* x = i < NCH * 8 ? o + 4 * i : ot + 4 * (i - NCH * 8);
      *reinterpret_cast<uint32_t*>(sm + q_unit<HD>(qb, wr0 + g, i) + 4 * t4) =
          pack_bf16(x[0] * inv[0], x[1] * inv[0]);
      *reinterpret_cast<uint32_t*>(sm + q_unit<HD>(qb, wr0 + g + 8, i) + 4 * t4) =
          pack_bf16(x[2] * inv[1], x[3] * inv[1]);
    }
    __syncwarp();
    bf16* out = static_cast<bf16*>(a.o);
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = e - (e / CH) * CH;
      const int rw = wr0 + r;
      if (rw < nrows) {
        const int rr = r0 + rw;
        const int sq = rr / G, h = hk * G + rr % G;
        *reinterpret_cast<uint4*>(out + b * a.ob + sq * a.os + h * a.oh + c * 8) =
            *reinterpret_cast<const uint4*>(sm + q_unit<HD>(qb, rw, c));
      }
    }
    if (T::QBUF == 2) {
      qb ^= 1;
    } else if (w + (int)gridDim.x < nwork) {
      bar_sync(1 + cw, 128);             // every warp has stored its rows
      load_q(w + gridDim.x, 0);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
typedef CUresult (*TmapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TmapEncode tmap_encode() {
  static TmapEncode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &got);
#endif
    if (e == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TmapEncode>(p);
  }
  return fn;
}

// A 4-d tensor map over k or v as [B, Skv, Hkv, hd] with the caller's
// strides (elements; innermost first: hd, Skv, Hkv, B), whose box is cols
// head dims of rows keys of one (kv head, batch row). Rows past Skv read as
// zeros. A dimension of size 1 never steps, so its stride only has to be
// legal.
bool tmap(CUtensorMap* m, const void* p, const Args& a, int64_t ss, int64_t hs, int64_t bs,
          int cols, int rows, CUtensorMapSwizzle swizzle) {
  const TmapEncode enc = tmap_encode();
  if (enc == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)a.hd, (cuuint64_t)a.Skv, (cuuint64_t)a.Hkv, (cuuint64_t)a.B};
  cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)hs * 2, (cuuint64_t)bs * 2};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1 && strides[i] == 0) strides[i] = 16;
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using T = WgTile<HD>;
  CUtensorMap tk, tkt, tv, tvt;
  memset(&tk, 0, sizeof(tk));
  tv = tkt = tvt = tk;
  if (a.Skv > 0) {   // else no block has a key to load
    if (!tmap(&tk, a.k, a, a.ks, a.kh, a.kb, 64, T::BKN, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tmap(&tv, a.v, a, a.vs, a.vh, a.vb, 64, T::BKN, CU_TENSOR_MAP_SWIZZLE_128B) ||
        (T::TAIL && (!tmap(&tkt, a.k, a, a.ks, a.kh, a.kb, T::TAIL, T::BKN,
                           CU_TENSOR_MAP_SWIZZLE_32B) ||
                     !tmap(&tvt, a.v, a, a.vs, a.vh, a.vb, T::TAIL, T::BKN,
                           CU_TENSOR_MAP_SWIZZLE_32B))))
      return cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)T::smem);
  if (e != cudaSuccess) return e;
  const int rows = a.H / a.Hkv * a.Sq;
  const int64_t work = (int64_t)((rows + WG_ROWS - 1) / WG_ROWS) * a.Hkv * a.B;
  if (work > 0x7FFFFFFF) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e2 = cudaGetDevice(&dev);
  if (e2 == cudaSuccess) e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e2 != cudaSuccess) return e2;
  const int64_t slots = (int64_t)sms * T::BLOCKS;   // persistent: every block stays resident
  const int64_t blocks = work < slots ? work : slots;
  flash_attention_wgmma_kernel<HD><<<dim3((unsigned)blocks), WG_THREADS, T::smem, stream>>>(
      tk, tkt, tv, tvt, a);
  return cudaGetLastError();
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
  // a 1-d grid, longest first over the whole grid: every (kv head, batch
  // row) of the last row tile, then of the one before, ...
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
  int32_t form;     // 0 SIMT, 1 MMA (bf16: hd 576 over dv 512 in k), 2 SPLIT ((H / Hkv) * Sq
                    // <= 16), 3 WGMMA (bf16: hd = dv in 64 / 80 / 128 / 256)
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
  const bool wide = dv == hd && (hd == 64 || hd == 80 || hd == 128 || hd == 256);
  if ((form == MMA && (dtype != 1 || !mla)) || (form == WGMMA && (dtype != 1 || !wide)))
    return (int)cudaErrorInvalidValue;
  if (form != SIMT && form != MMA && form != SPLIT && form != WGMMA)
    return (int)cudaErrorInvalidValue;
  const int64_t* strides = p->strides;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.qb = strides[0]; a.qs = strides[1]; a.qh = strides[2];
  a.kb = strides[3]; a.ks = strides[4]; a.kh = strides[5];
  a.vb = strides[6]; a.vs = strides[7]; a.vh = strides[8];
  a.ob = strides[9]; a.os = strides[10]; a.oh = strides[11];
  a.v_in_k = v == k && a.vb == a.kb && a.vs == a.ks && a.vh == a.kh;
  if (form == MMA && !a.v_in_k) return (int)cudaErrorInvalidValue;
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
  if (form == MMA)
    return (int)launch_rows(flash_attention_mla_kernel, MLA_SMEM, MLA_THREADS, MLA_ROWS, a, st);
  if (form == WGMMA) {
    if (hd == 64) return (int)launch_wgmma<64>(a, st);
    if (hd == 80) return (int)launch_wgmma<80>(a, st);
    if (hd == 128) return (int)launch_wgmma<128>(a, st);
    return (int)launch_wgmma<256>(a, st);
  }
  if (form == SPLIT)
    return (int)(dtype == 0 ? launch_split<float>(a, st) : launch_split<__nv_bfloat16>(a, st));
  return (int)(dtype == 0 ? dispatch<float>(a, st) : dispatch<__nv_bfloat16>(a, st));
}
