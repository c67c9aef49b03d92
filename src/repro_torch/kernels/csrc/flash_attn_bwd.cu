// The backward pass of prompt attention for Hopper (sm_90a): dq, dk and dv
// of the forward in csrc/flash_attn.cu, recomputed tile by tile from (q, k,
// lse) in the manner of FlashAttention-2.
//
// Replaces the reference's XLA backward of its flash-style attention
// (src/repro/nn/attention.py _flash_bwd, and _sliding_bwd, the same
// mathematics over a different grouping), which the training forward
// reaches through attend_chunked's custom VJP; the TPU kernel
// src/repro/kernels/flash_attn.py flash_attention is wired into training
// through that same VJP.
//
// flash_bwd_launch
//   q, out, dout (B, Sq, Hq, D); k, v (B, Sk, Hkv, D), all in one dtype
//   (float32 or bfloat16); lse (B, Sq, Hq) float32, the forward's m +
//   log(max(l, 1e-30)); the forward's mask (query i at absolute position
//   q_offset + i sees key j when rel = q_offset + i - j has rel < win and,
//   with causal, rel >= 0) and GQA by index (query head h reads KV head
//   h / (Hq / Hkv)).  Writes dq in q's layout and dk, dv in k's, in the
//   inputs' dtype, and uses delta (B, Sq, Hq) float32 as scratch.
//
//   The rounding order is _flash_bwd's: dout is taken in float32 (bf16
//   values widen exactly); delta = rowsum(dout * out) in float32; the
//   scores s = q.k * scale are float32 sums of exact products, masked to
//   -1e30; p = exp(s - lse); dv += p^T dout with p unrounded (the
//   reference's dout is float32 at that point); dp = dout v^T; ds = p (dp -
//   delta) scale, rounded to the inputs' dtype; dq += ds k and dk += ds^T
//   q; every accumulator float32, one cast to the dtype at the end.  A
//   group's query heads add into one dk / dv accumulator of their KV head,
//   so the transpose of the reference's repetition of K and V is a float32
//   sum here (in float32 the same value up to the order of the sum).
//
//   No atomics, and an order of every sum fixed by the shapes alone, so a
//   call is reproducible bit for bit:
//     delta_kernel   one warp per (b, i, h) row: delta over D.
//     dK/dV          one CTA per (key tile of 64, KV head, batch row, head
//                    split): the tile's K and V stay in shared memory; it
//                    loops over its run of the group's query heads and,
//                    for each, over the query tiles that meet a key of the
//                    tile (the causal / window band, so tiles outside it
//                    are never read), accumulating dk and dv in registers.
//     dQ             one CTA per (query tile of 64, head, batch row): it
//                    loops over the key tiles of 64 in the tile's band
//                    (the forward's key range), accumulating dq.
//     sum_splits     only when the heads are split: the float32 partials
//                    of the splits summed in split order, one cast.
//   Each tile kernel recomputes s and dp for its tiles.
//
//   Bound on the H100.  The backward's five products (s and dp twice, dv,
//   dk, dq: 10 D operations per kept (query, key) pair and head) at the
//   989 TFLOP/s bf16 tensor-core peak against reading q, k, v, out, dout
//   and lse and writing dq, dk, dv once over 3.35 TB/s: at stablelm-3b's
//   train step (8 x 256, 32 heads of 80) the bytes bound it, 0.025 ms; at
//   GQA 8:1 / 12:1 x 128 over 1,024 tokens and hymba-1.5b's window the
//   products, 0.026-0.044 ms.  The exp and the masks of every score tile,
//   recomputed in both tile kernels, run on the FMA pipes beside them.  So
//   the design keeps the products on the tensor cores, the tiles'
//   operands in shared memory and registers, and enough CTAs in flight.
//
//   Design, bf16 (dkdv_mma_kernel, dq_mma_kernel): mma.sync m16n8k16 (bf16
//   in, float32 out) with operands from ldmatrix, the forward's building
//   blocks (attn_common.cuh).  Four warps; rows padded to D16 + 8 elements
//   (mma_ld, D16 = D rounded up to 16), the columns [D, D16) zero.
//   dK/dV: each warp owns 16 keys.  It computes the transposed tiles
//   S^T = K Q^T and dP^T = V dout^T (keys as rows, K and V fragments by
//   ldmatrix, Q and dout by ldmatrix as the B operand), so P^T and dS^T
//   land in registers in the A-operand layout, as the forward feeds P to
//   P V; dV = P^T dout and dK = dS^T Q then read dout and Q through
//   ldmatrix.trans.  p is not rounded to one bf16 term: dV = p_hi^T dout +
//   p_lo^T dout with p_hi = bf16(p), p_lo = bf16(p - p_hi), about 16 bits
//   of p, far below dv's own bf16 rounding.  Q, dout, lse and delta tiles
//   of 64 queries (32 at D > 80, where the dk and dv accumulators take 128
//   registers a thread) arrive through a two-stage cp.async ring, so the
//   next tile loads while this one is computed.  Key tiles are dispatched
//   from tile 0 up: under a causal mask tile 0 meets every query tile.
//   dQ: each warp owns 16 queries; S = Q K^T and dP = dout V^T with the
//   queries as rows, dQ = dS K with K through ldmatrix.trans; K and V
//   tiles of 64 keys through a two-stage cp.async ring; the last query
//   tiles, which meet the most keys of a causal band, are dispatched
//   first.  The exp is the fast __expf; a masked p is exactly 0.
//
//   Design, float32 (dkdv_f32_kernel, dq_f32_kernel): FMAs on float copies
//   of the tiles in shared memory (TF32 tensor cores would break the
//   float32 contract): 256 threads, each computing a fixed 4 x 4 patch of
//   a 64 x 64 score tile (rows ty + 16 a, columns tx + 16 n) and a fixed
//   4 x 8 patch of a 64 x D accumulator (rows ty + 16 a, columns tx + 16
//   c); rows are padded to D + 1 floats so the column reads fall in
//   distinct banks.
//
//   Head split (both dtypes).  A dK/dV CTA loops over a group's query
//   heads, so under GQA the grid (key tiles x Hkv x B) can be far smaller
//   than the card (64 CTAs at GQA 12:1, 1,024 keys).  The wrapper's plan
//   (flash_attn.py bwd_head_split_plan, a function of the shapes alone)
//   then cuts each group's n_rep heads into `splits` runs of `run` whole
//   heads, one per CTA; each CTA writes float32 partial dk and dv to
//   scratch (2, splits, B, Sk, Hkv, D), and sum_splits_kernel adds them in
//   split order and casts once.  With one split the dK/dV kernel writes
//   the dtype itself.
#include "attn_common.cuh"

namespace {

using attn::from_f32;
using attn::ldsm_x4;
using attn::ldsm_x4_trans;
using attn::mma_bf16;
using attn::mma_ld;
using attn::pack_bf16;
using attn::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kB = 64;                  // keys per tile; queries per dQ tile
constexpr int kMaxD = 128;
constexpr int kThreads = 256;           // float32 tile kernels, delta
constexpr int kMmaThreads = 128;        // bf16 tile kernels: 4 warps
constexpr int kSumThreads = 256;

// float32 tile kernels
constexpr int kTX = 16;                 // thread columns
constexpr int kTY = kThreads / kTX;     // thread rows (16)
constexpr int kR = kB / kTY;            // tile rows per thread (4)
constexpr int kN = kB / kTX;            // score columns per thread (4)
constexpr int kMaxC = kMaxD / kTX;      // accumulator columns per thread (8)
constexpr int kLdS = kB + 1;            // row stride of a score tile

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float* part;    // (2, splits, B, Sk, Hkv, D) float32 partials, or null
  int B, Sq, Sk, Hq, Hkv, D, q_offset, win, causal;
  float scale;
  int splits, run;
};

// The dK/dV CTA of this block: key tiles along y from tile 0 up; x over
// (head split, KV head, batch row), the split fastest.
struct DkdvUnit {
  int k0, split, hk, b;
};
__device__ __forceinline__ DkdvUnit dkdv_unit(const Args& a) {
  const int u = blockIdx.x / a.splits;
  return {(int)blockIdx.y * kB, (int)(blockIdx.x % a.splits), u % a.Hkv,
          u / a.Hkv};
}

// The dQ CTA of this block: query tiles along y, the last first; x over
// (head, batch row).
struct DqUnit {
  int q0, h, b;
};
__device__ __forceinline__ DqUnit dq_unit(const Args& a) {
  return {(int)(gridDim.y - 1 - blockIdx.y) * kB, (int)(blockIdx.x % a.Hq),
          (int)(blockIdx.x / a.Hq)};
}

// The local query rows [lo, hi) that see a key of [k0, k0 + nk): absolute
// positions k0 (causal) or 0 up to k0 + nk - 1 + win - 1; empty when hi
// <= lo.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span query_span(const Args& a, int k0, int nk) {
  const long long pos_lo = a.causal ? k0 : 0;
  const long long pos_hi = (long long)k0 + nk - 1 + a.win - 1;
  return {(int)min((long long)a.Sq, max(0LL, pos_lo - a.q_offset)),
          (int)min((long long)a.Sq, pos_hi - a.q_offset + 1)};
}

// The forward's key band [lo, hi) of queries [q0, q0 + nq).
__device__ __forceinline__ Span key_band(const Args& a, int q0, int nq) {
  const long long p_lo = (long long)a.q_offset + q0, p_hi = p_lo + nq - 1;
  return {(int)min((long long)a.Sk, max(0LL, p_lo - a.win + 1)),
          a.causal ? (int)min((long long)a.Sk, p_hi + 1) : a.Sk};
}

// The float32 partial of split s (dk's, or with dv dv's) at element i of
// dk's layout.
__device__ __forceinline__ float* partial(const Args& a, int s, bool dv,
                                          size_t i) {
  const size_t n = (size_t)a.B * a.Sk * a.Hkv * a.D;
  return a.part + ((size_t)(dv ? a.splits : 0) + s) * n + i;
}

// delta[row] = sum_d dout[row, d] * out[row, d] in float32, one warp per
// row of R = B * Sq * Hq
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, long long R, int D) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(dout[row * D + d]), to_f32(out[row * D + d]), acc);
  acc = attn::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// out = the float32 partials summed over the splits in split order, cast
// once: four elements a thread; blockIdx.y 0 dk, 1 dv.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_splits_kernel(const Args a, long long n) {
  const long long i = ((long long)blockIdx.x * kSumThreads + threadIdx.x) * 4;
  if (i >= n) return;
  const bool dv = blockIdx.y == 1;
  float4 acc = *reinterpret_cast<const float4*>(partial(a, 0, dv, i));
  for (int s = 1; s < a.splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(partial(a, s, dv, i));
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* out = static_cast<T*>(dv ? a.dv : a.dk) + i;
  out[0] = from_f32<T>(acc.x);
  out[1] = from_f32<T>(acc.y);
  out[2] = from_f32<T>(acc.z);
  out[3] = from_f32<T>(acc.w);
}

// ---------------------------------------------------------------------------
// float32: FMAs
// ---------------------------------------------------------------------------

// rows [0, rows) of src (row stride `stride` floats, D a row, read in
// 16-byte vectors) into rows of `ld` floats; rows >= n zero
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t stride, int rows, int n, int D) {
  const int vpr = D / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = i - r * vpr;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n)
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * stride) + c);
    float* d = dst + r * ld + c * 4;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// Shared memory of the two float32 tile kernels, in floats: four 64 x (D +
// 1) tiles, two 64 x 65 score tiles, lse and delta [64] each.
size_t f32_smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)kB * (D + 1) + 2 * (size_t)kB * kLdS +
                          2 * (size_t)kB);
}

// The scores and dp of one query tile (rows i, queries q0 + i) against one
// key tile (columns j, keys k0 + j), masked, turned into p and ds, written
// to ps and dss (each [64][65]); ps may be null.
__device__ __forceinline__ void score_tile(
    const float* qs, const float* os, const float* ks, const float* vs,
    const float* ls, const float* dls, float* ps, float* dss, int ld, int D,
    long long p0, int nq, int k0, int nk, int win, int causal, float scale) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  float s[kR][kN], dp[kR][kN];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int n = 0; n < kN; ++n) s[a][n] = dp[a][n] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[kR], ov[kR], kv[kN], vv[kN];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      qv[a] = qs[(ty + kTY * a) * ld + d];
      ov[a] = os[(ty + kTY * a) * ld + d];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      kv[n] = ks[(tx + kTX * n) * ld + d];
      vv[n] = vs[(tx + kTX * n) * ld + d];
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        s[a][n] = fmaf(qv[a], kv[n], s[a][n]);
        dp[a][n] = fmaf(ov[a], vv[n], dp[a][n]);
      }
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = ty + kTY * a;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int j = tx + kTX * n;
      const long long rel = p0 + i - (k0 + j);
      const bool ok = i < nq && j < nk && rel < win && (!causal || rel >= 0);
      // masked scores are -1e30 in the reference, so their p is 0
      const float p = ok ? expf(s[a][n] * scale - ls[i]) : 0.f;
      if (ps != nullptr) ps[i * kLdS + j] = p;
      dss[i * kLdS + j] = p * (dp[a][n] - dls[i]) * scale;
    }
  }
}

// lse and delta of rows q0 .. q0 + 63 of head h into ls, dls (0 past nq)
__device__ __forceinline__ void stage_rows(float* ls, float* dls,
                                           const float* lse,
                                           const float* delta, size_t row0,
                                           int Hq, int nq) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const size_t row = row0 + (size_t)i * Hq;
    ls[i] = i < nq ? lse[row] : 0.f;
    dls[i] = i < nq ? delta[row] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
dkdv_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ld = D + 1;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kB * ld;
  float* qs = vs + kB * ld;
  float* os = qs + kB * ld;
  float* ps = os + kB * ld;
  float* dss = ps + kB * kLdS;
  float* ls = dss + kB * kLdS;
  float* dls = ls + kB;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const DkdvUnit u = dkdv_unit(a);
  const int k0 = u.k0, hk = u.hk, b = u.b;
  const int nk = min(kB, a.Sk - k0);
  const int n_rep = a.Hq / a.Hkv;
  const int r0 = u.split * a.run, r1 = min(n_rep, r0 + a.run);
  const size_t q_row = (size_t)a.Hq * D, k_row = (size_t)a.Hkv * D;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;

  const size_t kv0 = ((size_t)b * a.Sk + k0) * k_row + (size_t)hk * D;
  stage(ks, ld, k + kv0, k_row, kB, nk, D);
  stage(vs, ld, v + kv0, k_row, kB, nk, D);

  float dk[kR][kMaxC], dv[kR][kMaxC];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) dk[r][c] = dv[r][c] = 0.f;

  const Span qs_span = query_span(a, k0, nk);
  for (int r = r0; r < r1; ++r) {
    const int h = hk * n_rep + r;
    for (int q0 = (qs_span.lo / kB) * kB; q0 < qs_span.hi; q0 += kB) {
      const int nq = min(kB, a.Sq - q0);
      __syncthreads();                  // the previous tile consumed
      const size_t qoff = ((size_t)b * a.Sq + q0) * q_row + (size_t)h * D;
      stage(qs, ld, q + qoff, q_row, kB, nq, D);
      stage(os, ld, dout + qoff, q_row, kB, nq, D);
      stage_rows(ls, dls, a.lse, a.delta, ((size_t)b * a.Sq + q0) * a.Hq + h,
                 a.Hq, nq);
      __syncthreads();
      score_tile(qs, os, ks, vs, ls, dls, ps, dss, ld, D,
                 (long long)a.q_offset + q0, nq, k0, nk, a.win, a.causal,
                 a.scale);
      __syncthreads();
      // dv += p^T dout, dk += ds^T q: key rows ty + 16 r, columns tx + 16 c
      for (int i = 0; i < nq; ++i) {
        float pv[kR], sv[kR];
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) {
          pv[rr] = ps[i * kLdS + ty + kTY * rr];
          sv[rr] = dss[i * kLdS + ty + kTY * rr];
        }
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          const int d = tx + kTX * c;
          if (d < D) {
            const float o = os[i * ld + d], qq = qs[i * ld + d];
#pragma unroll
            for (int rr = 0; rr < kR; ++rr) {
              dv[rr][c] = fmaf(pv[rr], o, dv[rr][c]);
              dk[rr][c] = fmaf(sv[rr], qq, dk[rr][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int j = ty + kTY * rr;
    if (j >= nk) continue;
    const size_t row = ((size_t)b * a.Sk + k0 + j) * k_row + (size_t)hk * D;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = tx + kTX * c;
      if (d >= D) continue;
      if (a.splits == 1) {
        static_cast<float*>(a.dk)[row + d] = dk[rr][c];
        static_cast<float*>(a.dv)[row + d] = dv[rr][c];
      } else {
        *partial(a, u.split, false, row + d) = dk[rr][c];
        *partial(a, u.split, true, row + d) = dv[rr][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ld = D + 1;
  float* qs = reinterpret_cast<float*>(smem);
  float* os = qs + kB * ld;
  float* ks = os + kB * ld;
  float* vs = ks + kB * ld;
  float* dss = vs + kB * ld;
  float* ls = dss + kB * kLdS;
  float* dls = ls + kB;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const DqUnit u = dq_unit(a);
  const int q0 = u.q0, h = u.h, b = u.b;
  const int nq = min(kB, a.Sq - q0);
  const int hk = h / (a.Hq / a.Hkv);
  const size_t q_row = (size_t)a.Hq * D, k_row = (size_t)a.Hkv * D;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;

  const size_t qoff = ((size_t)b * a.Sq + q0) * q_row + (size_t)h * D;
  stage(qs, ld, q + qoff, q_row, kB, nq, D);
  stage(os, ld, dout + qoff, q_row, kB, nq, D);
  stage_rows(ls, dls, a.lse, a.delta, ((size_t)b * a.Sq + q0) * a.Hq + h,
             a.Hq, nq);

  float dq[kR][kMaxC];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) dq[r][c] = 0.f;

  const long long p_lo = (long long)a.q_offset + q0;
  const Span band = key_band(a, q0, nq);
  for (int k0 = band.lo; k0 < band.hi; k0 += kB) {
    const int nk = min(kB, band.hi - k0);
    __syncthreads();                    // the previous tile consumed
    const size_t kv0 = ((size_t)b * a.Sk + k0) * k_row + (size_t)hk * D;
    stage(ks, ld, k + kv0, k_row, kB, nk, D);
    stage(vs, ld, v + kv0, k_row, kB, nk, D);
    __syncthreads();
    score_tile(qs, os, ks, vs, ls, dls, nullptr, dss, ld, D, p_lo, nq, k0,
               nk, a.win, a.causal, a.scale);
    __syncthreads();
    // dq += ds k: query rows ty + 16 r, columns tx + 16 c
    for (int j = 0; j < nk; ++j) {
      float sv[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) sv[rr] = dss[(ty + kTY * rr) * kLdS + j];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int d = tx + kTX * c;
        if (d < D) {
          const float kk = ks[j * ld + d];
#pragma unroll
          for (int rr = 0; rr < kR; ++rr)
            dq[rr][c] = fmaf(sv[rr], kk, dq[rr][c]);
        }
      }
    }
  }
  float* dq_out = static_cast<float*>(a.dq);
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int i = ty + kTY * rr;
    if (i >= nq) continue;
    const size_t row = ((size_t)b * a.Sq + q0 + i) * q_row + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = tx + kTX * c;
      if (d < D) dq_out[row + d] = dq[rr][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async rings
// ---------------------------------------------------------------------------

// Queries per step of dkdv_mma_kernel: 64, or 32 at D > 80, where a
// thread's dk and dv accumulators alone take 128 registers.
__host__ __device__ constexpr int dkdv_bq(int KS) { return KS <= 5 ? 64 : 32; }

// Shared memory of dkdv_mma_kernel: rows of mma_ld(KS) bf16, K [64] and V
// [64], then 2 stages x (Q [BQ], dout [BQ]); then 2 stages x (lse [BQ],
// delta [BQ]) float32.
size_t dkdv_mma_smem(int KS) {
  const int BQ = dkdv_bq(KS);
  return sizeof(bf16) * (size_t)(2 * kB + 4 * BQ) * mma_ld(KS) +
         sizeof(float) * 4 * BQ;
}

// Shared memory of dq_mma_kernel: rows of mma_ld(KS) bf16, Q [64] and dout
// [64], then 2 stages x (K [64], V [64]); then lse and delta [64] float32.
size_t dq_mma_smem(int KS) {
  return sizeof(bf16) * (size_t)(6 * kB) * mma_ld(KS) +
         sizeof(float) * 2 * kB;
}

// 4 bytes global -> shared, asynchronously; src_bytes 0 fills a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// Row r of base (row stride `stride`) into the shared row dst by cp.async,
// its D = 8 vpr elements; zeros for r >= n_valid.
template <int KS>
__device__ __forceinline__ void copy_row(bf16* dst, const bf16* base,
                                         size_t stride, int r, int n_valid,
                                         int vpr) {
  const bool ok = r < n_valid;
  const bf16* src = ok ? base + (size_t)r * stride : base;
#pragma unroll
  for (int c = 0; c < 2 * KS; ++c)
    if (c < vpr) attn::cp_async16(dst + c * 8, src + c * 8, ok ? 16 : 0);
}

// Columns [D, KS x 16) of n_rows shared rows set to zero (cp.async never
// writes them).
template <int KS>
__device__ __forceinline__ void zero_pad(bf16* rows, int n_rows, int D) {
  constexpr int DP = KS * 16, LD = mma_ld(KS);
  if (DP > D) {
    const int pad = DP - D;
    for (int i = threadIdx.x; i < n_rows * pad; i += kMmaThreads)
      rows[(size_t)(i / pad) * LD + D + i % pad] = __float2bfloat16(0.f);
  }
}

// Grid (splits x Hkv x B, key tiles).
template <int KS>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(const Args a) {
  constexpr int BQ = dkdv_bq(KS), LD = mma_ld(KS), NT = 2 * KS;
  constexpr int NQ = BQ / 8, KQ = BQ / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rows = reinterpret_cast<bf16*>(smem);   // row i at rows + i*LD
  float* stats =
      reinterpret_cast<float*>(rows + (size_t)(2 * kB + 4 * BQ) * LD);

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const DkdvUnit u = dkdv_unit(a);
  const int D = a.D, n_rep = a.Hq / a.Hkv;
  const int nk = min(kB, a.Sk - u.k0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const size_t q_row = (size_t)a.Hq * D, k_row = (size_t)a.Hkv * D;
  const int vpr = D / 8;                        // 16-byte vectors per row

  zero_pad<KS>(rows, 2 * kB + 4 * BQ, D);

  // this CTA's run of the group's heads, and the query tiles of BQ that
  // meet a key of its tile, for each head
  const int r0 = u.split * a.run, r1 = min(n_rep, r0 + a.run);
  const Span span = query_span(a, u.k0, nk);
  const int first = span.lo / BQ * BQ;
  const int n_q = span.hi > span.lo ? (span.hi - first + BQ - 1) / BQ : 0;
  const int n_tiles = (r1 - r0) * n_q;

  const size_t kv0 = ((size_t)u.b * a.Sk + u.k0) * k_row + (size_t)u.hk * D;
  for (int i = tid; i < 2 * kB; i += kMmaThreads) {
    const int which = i >= kB;                  // 0: K, 1: V
    copy_row<KS>(rows + (size_t)i * LD, (which ? v : k) + kv0, k_row,
                 i - which * kB, nk, vpr);
  }
  // step t: head r0 + t / n_q, query tile t % n_q, into stage st
  auto issue = [&](int t, int st) {
    const int h = u.hk * n_rep + r0 + t / n_q;
    const int q0 = first + (t % n_q) * BQ, nq = min(BQ, a.Sq - q0);
    const size_t row0 = (size_t)u.b * a.Sq + q0;
    const size_t off = row0 * q_row + (size_t)h * D;
    bf16* dst = rows + (size_t)(2 * kB + st * 2 * BQ) * LD;
    float* sdst = stats + st * 2 * BQ;
    for (int i = tid; i < 2 * BQ; i += kMmaThreads) {
      const int which = i >= BQ, r = i - which * BQ;   // 0: Q, 1: dout
      copy_row<KS>(dst + (size_t)i * LD, (which ? dout : q) + off, q_row, r,
                   nq, vpr);
      const float* src = which ? a.delta : a.lse;
      cp_async4(sdst + i, src + (r < nq ? (row0 + r) * a.Hq + h : 0),
                r < nq ? 4 : 0);
    }
  };
  if (n_tiles > 0) issue(0, 0);
  attn::cp_async_commit();

  // this thread's key rows key_a and key_a + 8 of the warp's 16, columns
  // 2 tq, 2 tq + 1 of each 8-wide n-tile (the mma.sync C layout)
  const int key_a = warp * 16 + g;
  const bf16* ka_ptr =
      rows + (size_t)(warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* va_ptr = ka_ptr + (size_t)kB * LD;
  const size_t b_off =                          // B operand, plain
      (size_t)((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const size_t t_off =                          // B operand, transposed
      (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1, (t + 1) & 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();                            // step t (and K, V) landed
    const int q0 = first + (t % n_q) * BQ, nq = min(BQ, a.Sq - q0);
    const bf16* qs = rows + (size_t)(2 * kB + (t & 1) * 2 * BQ) * LD;
    const bf16* os = qs + (size_t)BQ * LD;
    const float* ls = stats + (t & 1) * 2 * BQ;
    const float* dls = ls + BQ;

    // S^T = K Q^T and dP^T = V dout^T: NQ n-tiles of 8 queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ka_ptr + kk * 16);
      ldsm_x4(va, va_ptr + kk * 16);
#pragma unroll
      for (int np = 0; np < KQ; ++np) {
        const size_t off = (size_t)np * 16 * LD + b_off + kk * 16;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, qs + off);
        ldsm_x4(bo, os + off);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
      }
    }
    // p^T = exp(s scale - lse), exactly 0 where masked, as p_hi + p_lo;
    // ds^T = p (dp - delta) scale rounded to bf16; all three in the A
    // layout (queries as the k dimension).  rel of (query c, key r) is
    // rel0 + c - r; a tile inside every pair's band needs no mask.
    const long long rel0 = (long long)a.q_offset + q0 - u.k0;
    const bool full = nq == BQ && nk == kB &&
                      (!a.causal || rel0 >= kB - 1) && rel0 + BQ - 1 < a.win;
    uint32_t ph[KQ][4], pl[KQ][4], dsf[KQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int col = nt * 8 + 2 * tq;
      const float2 lse2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 del2 = *reinterpret_cast<const float2*>(dls + col);
      float p[4], lo[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1), r = key_a + 8 * (e >> 1);
        const long long rel = rel0 + c - r;
        const bool ok = full || (c < nq && r < nk && rel < a.win &&
                                 (!a.causal || rel >= 0));
        p[e] = ok ? __expf(s[nt][e] * a.scale - ((e & 1) ? lse2.y : lse2.x))
                  : 0.f;
        lo[e] = p[e] - __bfloat162float(__float2bfloat16(p[e]));
        ds[e] = p[e] * (dp[nt][e] - ((e & 1) ? del2.y : del2.x)) * a.scale;
      }
      const int kq = nt >> 1, j = (nt & 1) * 2;
      ph[kq][j] = pack_bf16(p[0], p[1]);
      ph[kq][j + 1] = pack_bf16(p[2], p[3]);
      pl[kq][j] = pack_bf16(lo[0], lo[1]);
      pl[kq][j + 1] = pack_bf16(lo[2], lo[3]);
      dsf[kq][j] = pack_bf16(ds[0], ds[1]);
      dsf[kq][j + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dV += p_hi^T dout + p_lo^T dout, dK += ds^T Q: KQ k-steps of 16
    // queries, NT n-tiles of 8 columns, dout and Q by ldmatrix.trans
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        const size_t off = (size_t)kq * 16 * LD + t_off + dt * 16;
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, os + off);
        ldsm_x4_trans(bq, qs + off);
        mma_bf16(dv[2 * dt], ph[kq], bo[0], bo[1]);
        mma_bf16(dv[2 * dt + 1], ph[kq], bo[2], bo[3]);
        mma_bf16(dv[2 * dt], pl[kq], bo[0], bo[1]);
        mma_bf16(dv[2 * dt + 1], pl[kq], bo[2], bo[3]);
        mma_bf16(dk[2 * dt], dsf[kq], bq[0], bq[1]);
        mma_bf16(dk[2 * dt + 1], dsf[kq], bq[2], bq[3]);
      }
    }
    __syncthreads();                            // stage t & 1 consumed
  }
  attn::cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key_a + 8 * i;
    if (j >= nk) continue;
    const size_t row =
        ((size_t)u.b * a.Sk + u.k0 + j) * k_row + (size_t)u.hk * D;
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      const size_t c = row + dt * 8 + 2 * tq;
      if (dt * 8 + 2 * tq >= D) continue;
      if (a.splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk_out + c) =
            __floats2bfloat162_rn(dk[dt][2 * i], dk[dt][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + c) =
            __floats2bfloat162_rn(dv[dt][2 * i], dv[dt][2 * i + 1]);
      } else {
        *reinterpret_cast<float2*>(partial(a, u.split, false, c)) =
            make_float2(dk[dt][2 * i], dk[dt][2 * i + 1]);
        *reinterpret_cast<float2*>(partial(a, u.split, true, c)) =
            make_float2(dv[dt][2 * i], dv[dt][2 * i + 1]);
      }
    }
  }
}

// Grid (Hq x B, query tiles).
template <int KS>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const Args a) {
  constexpr int LD = mma_ld(KS), NT = 2 * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rows = reinterpret_cast<bf16*>(smem);   // row i at rows + i*LD
  float* ls = reinterpret_cast<float*>(rows + (size_t)6 * kB * LD);
  float* dls = ls + kB;

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const DqUnit u = dq_unit(a);
  const int D = a.D, nq = min(kB, a.Sq - u.q0);
  const int hk = u.h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const size_t q_row = (size_t)a.Hq * D, k_row = (size_t)a.Hkv * D;
  const int vpr = D / 8;                        // 16-byte vectors per row

  zero_pad<KS>(rows, 6 * kB, D);

  const Span band = key_band(a, u.q0, nq);
  const int n_tiles = band.hi > band.lo ? (band.hi - band.lo + kB - 1) / kB
                                        : 0;
  const size_t row0 = (size_t)u.b * a.Sq + u.q0;
  const size_t qoff = row0 * q_row + (size_t)u.h * D;
  for (int i = tid; i < 2 * kB; i += kMmaThreads) {
    const int which = i >= kB;                  // 0: Q, 1: dout
    copy_row<KS>(rows + (size_t)i * LD, (which ? dout : q) + qoff, q_row,
                 i - which * kB, nq, vpr);
  }
  for (int i = tid; i < kB; i += kMmaThreads) {
    const size_t row = (row0 + i) * a.Hq + u.h;
    ls[i] = i < nq ? a.lse[row] : 0.f;
    dls[i] = i < nq ? a.delta[row] : 0.f;
  }
  const size_t kv0 = (size_t)u.b * a.Sk * k_row + (size_t)hk * D;
  auto issue = [&](int t, int st) {
    const int k0 = band.lo + t * kB, nk = min(kB, band.hi - k0);
    const size_t off = kv0 + (size_t)k0 * k_row;
    bf16* dst = rows + (size_t)(2 * kB + st * 2 * kB) * LD;
    for (int i = tid; i < 2 * kB; i += kMmaThreads) {
      const int which = i >= kB;                // 0: K, 1: V
      copy_row<KS>(dst + (size_t)i * LD, (which ? v : k) + off, k_row,
                   i - which * kB, nk, vpr);
    }
  };
  if (n_tiles > 0) issue(0, 0);
  attn::cp_async_commit();

  // this thread's query rows row_a and row_a + 8 of the warp's 16
  const int row_a = warp * 16 + g;
  const bf16* qa_ptr =
      rows + (size_t)(warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* oa_ptr = qa_ptr + (size_t)kB * LD;
  const size_t b_off =
      (size_t)((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const size_t t_off =
      (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  const long long p_lo = (long long)a.q_offset + u.q0;
  float dq[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1, (t + 1) & 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();                            // tile t (and Q, dout) landed
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse_r[i] = ls[row_a + 8 * i];
        del_r[i] = dls[row_a + 8 * i];
      }
    }
    const int k0 = band.lo + t * kB;
    const bf16* ks = rows + (size_t)(2 * kB + (t & 1) * 2 * kB) * LD;
    const bf16* vs = ks + (size_t)kB * LD;

    // S = Q K^T and dP = dout V^T: 8 n-tiles of 8 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, qa_ptr + kk * 16);
      ldsm_x4(oa, oa_ptr + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const size_t off = (size_t)np * 16 * LD + b_off + kk * 16;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, ks + off);
        ldsm_x4(bv, vs + off);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }
    // p = exp(s scale - lse), exactly 0 where masked; ds = p (dp - delta)
    // scale rounded to bf16, in the A layout (keys as the k dimension).
    // rel of (query r, key c) is rel0 + r - c; rows past nq are never
    // written.
    const long long rel0 = p_lo - k0;
    const bool full = k0 + kB <= band.hi && (!a.causal || rel0 >= kB - 1) &&
                      rel0 + nq - 1 < a.win;
    uint32_t dsf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tq + (e & 1), r = row_a + 8 * (e >> 1);
        const long long rel = rel0 + r - c;
        const bool ok = full || (k0 + c < band.hi && rel < a.win &&
                                 (!a.causal || rel >= 0));
        const float p =
            ok ? __expf(s[nt][e] * a.scale - lse_r[e >> 1]) : 0.f;
        ds[e] = p * (dp[nt][e] - del_r[e >> 1]) * a.scale;
      }
      dsf[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += ds K: 4 k-steps of 16 keys, NT n-tiles of 8 columns, K by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, ks + (size_t)kk * 16 * LD + t_off + dt * 16);
        mma_bf16(dq[2 * dt], dsf[kk], bk[0], bk[1]);
        mma_bf16(dq[2 * dt + 1], dsf[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();                            // stage t & 1 consumed
  }
  attn::cp_async_wait<0>();

  bf16* dq_out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_a + 8 * i;
    if (r >= nq) continue;
    const size_t row = ((row0 + r) * a.Hq + u.h) * D;
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      const int c = dt * 8 + 2 * tq;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(dq_out + row + c) =
            __floats2bfloat162_rn(dq[dt][2 * i], dq[dt][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

dim3 dkdv_grid(const Args& a) {
  return dim3((unsigned)(a.splits * a.Hkv * a.B), (a.Sk + kB - 1) / kB);
}
dim3 dq_grid(const Args& a) {
  return dim3((unsigned)(a.Hq * a.B), (a.Sq + kB - 1) / kB);
}

template <int KS>
cudaError_t run_mma(const Args& a, cudaStream_t stream) {
  cudaError_t e = attn::allow_max_smem<dkdv_mma_kernel<KS>>();
  if (e != cudaSuccess) return e;
  e = attn::allow_max_smem<dq_mma_kernel<KS>>();
  if (e != cudaSuccess) return e;
  dkdv_mma_kernel<KS><<<dkdv_grid(a), kMmaThreads, dkdv_mma_smem(KS),
                        stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_mma_kernel<KS><<<dq_grid(a), kMmaThreads, dq_mma_smem(KS), stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_bf16(const Args& a, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
    case 1: return run_mma<1>(a, stream);
    case 2: return run_mma<2>(a, stream);
    case 3: return run_mma<3>(a, stream);
    case 4: return run_mma<4>(a, stream);
    case 5: return run_mma<5>(a, stream);
    case 6: return run_mma<6>(a, stream);
    case 7: return run_mma<7>(a, stream);
    default: return run_mma<8>(a, stream);
  }
}

cudaError_t run_f32(const Args& a, cudaStream_t stream) {
  cudaError_t e = attn::allow_max_smem<dkdv_f32_kernel>();
  if (e != cudaSuccess) return e;
  e = attn::allow_max_smem<dq_f32_kernel>();
  if (e != cudaSuccess) return e;
  const size_t smem = f32_smem_bytes(a.D);
  dkdv_f32_kernel<<<dkdv_grid(a), kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_f32_kernel<<<dq_grid(a), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_all(const Args& a, cudaStream_t stream) {
  const long long R = (long long)a.B * a.Sq * a.Hq;
  const int rows_per_block = kThreads / 32;
  delta_kernel<T><<<(unsigned)((R + rows_per_block - 1) / rows_per_block),
                    kThreads, 0, stream>>>(static_cast<const T*>(a.out),
                                           static_cast<const T*>(a.dout),
                                           a.delta, R, a.D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = sizeof(T) == 4 ? run_f32(a, stream) : run_bf16(a, stream);
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long n = (long long)a.B * a.Sk * a.Hkv * a.D;
  const long long vecs = n / 4;
  sum_splits_kernel<T><<<dim3((unsigned)((vecs + kSumThreads - 1) /
                                         kSumThreads), 2),
                         kSumThreads, 0, stream>>>(a, n);
  return cudaGetLastError();
}

size_t smem_bytes(int D, int dtype) {
  const int KS = (D + 15) / 16;
  if (dtype == 0) return f32_smem_bytes(D);
  const size_t dkdv = dkdv_mma_smem(KS), dq = dq_mma_smem(KS);
  return dkdv > dq ? dkdv : dq;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows of D elements must be whole
// 16-byte vectors, D <= 128, Hq a multiple of Hkv, every pointer 16-byte
// aligned and every tensor contiguous (the wrapper checks); delta is
// float32 scratch of B * Sq * Hq values.  Each group's n_rep = Hq / Hkv
// query heads are swept in `splits` runs of `run` heads (split s: heads
// [s run, min(n_rep, (s + 1) run)), none empty); with splits > 1, part
// is float32 scratch of 2 * splits * B * Sk * Hkv * D values.  Returns
// cudaGetLastError() after the last launch.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* out, const void* dout,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, void* part, int B,
                                int Sq, int Sk, int Hq, int Hkv, int D,
                                int q_offset, int win, int causal,
                                float scale, int dtype, int splits, int run,
                                void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const long long n_rep = Hkv > 0 ? Hq / Hkv : 0;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0 || D <= 0 || D > kMaxD || (D * elem) % 16 != 0 ||
      q_offset < 0 || win <= 0 || (dtype != 0 && dtype != 1) ||
      splits <= 0 || run <= 0 || (long long)splits * run < n_rep ||
      (long long)(splits - 1) * run >= n_rep ||
      (splits > 1 && part == nullptr) ||
      (long long)splits * Hkv * B > 0x7fffffffLL ||
      (long long)Hq * B > 0x7fffffffLL || (Sk + kB - 1) / kB > 65535 ||
      (Sq + kB - 1) / kB > 65535 ||
      (long long)B * Sq * Hq > 0x7fffffffLL * (kThreads / 32) ||
      (long long)B * Sk * Hkv * D / 4 >
          0x7fffffffLL * (long long)kSumThreads)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,  v,  out, dout, (const float*)lse, (float*)delta,
               dq,  dk, dv, (float*)part, B, Sq, Sk, Hq, Hkv, D,
               q_offset, win, causal, scale, splits, run};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? run_all<float>(a, s) : run_all<bf16>(a, s));
}

// Shared-memory bytes the larger tile kernel asks for at head width D in
// dtype (the wrapper refuses a call above the card's per-block limit).
extern "C" long long flash_bwd_smem_bytes(int D, int dtype) {
  return (long long)smem_bytes(D, dtype);
}
