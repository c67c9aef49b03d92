// Prompt attention for Hopper (sm_90a): a tiled forward flash attention
// with a float32 online softmax, on the bf16 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py
//   flash_attention (_flash_kernel)            -> flash_attn_launch
// and serves, through the same launch, the form the reference computes in
// XLA for every prompt (src/repro/nn/attention.py _flash_fwd_impl, reached
// from attend_chunked): queries at an offset into a longer key range, a
// sliding window, and GQA by index.
//
// flash_attn_launch
//   q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); out (B, Sq, Hq, D), all in one
//   dtype.  Query i of head h sits at absolute position q_offset + i and
//   reads KV head h / n_rep (n_rep = Hq / Hkv).  Key j attends when
//   rel = q_offset + i - j has rel < win and, with causal, rel >= 0.  The
//   TPU kernel's (BH, S, D) call is B = BH, Hq = Hkv = 1, Sk = Sq,
//   q_offset 0, no window.
//   Scores q.k are float32 sums of exact products (bf16 x bf16 on the
//   tensor cores, float32 FMAs in float32), times the scale; masked scores
//   are -1e30; the running max m and sum l are float32; the probabilities
//   p = exp(s - m) enter l as they are and the value product rounded to
//   v's dtype (as the TPU kernel and the reference do); the result is
//   acc / max(l, 1e-30) in v's dtype.  A key tile that holds no key in the
//   band of any of the CTA's queries is never read; inside a tile a row
//   whose keys are all masked gets p = 1 on them while its m is still
//   -1e30, exactly as in the reference, and its first real key wipes that
//   through corr = exp(-1e30 - m) = 0.  A row with no valid key at all is
//   garbage (in the reference too).  No atomics and no order that depends
//   on anything but the shapes: a call is reproducible bit for bit, which
//   the chunked prefill's resume relies on.  With lse != nullptr the launch
//   also writes each row's float32 log-sum-exp m + log(max(l, 1e-30)), (B,
//   Sq, Hq), which the backward (csrc/flash_attn_bwd.cu) reads; the output
//   does not depend on it.
//
//   Bound on the H100.  One-shot prefill of a 1,000-token prompt (32 heads
//   of 80, bf16): q, k, v and out are 20.5 MB, 6.1 us at 3.35 TB/s; the
//   causal band is 5.1 GFLOP, 5.2 us at the 989 TFLOP/s bf16 tensor-core
//   peak, so the two are even.  A fold chunk (16 queries against ~1,100
//   keys) is bound by bytes: the key range is read once per KV head, ~11 MB.
//
//   Design, bf16 (flash_mma_kernel, in the manner of FlashAttention-2):
//   one CTA per (query tile, head, batch row, key split), one warp per 16
//   query rows (tiles of 64 queries, 4 warps; 16 queries, 1 warp, when
//   Sq <= 16, the fold's chunk); the last query tiles, which meet the most
//   keys of a causal band, are scheduled first.  K and V tiles of 64 keys
//   arrive through cp.async in a two-stage ring in shared memory (a thread
//   per row), so tile j + 1 loads while tile j is computed.  Rows are
//   padded to D16 + 8 elements (D16 = D rounded up to 16; 176 bytes at
//   D = 80), an odd number of 16-byte units, so ldmatrix's eight row
//   addresses fall in distinct banks; the columns [D, D16) hold zeros.
//   S = Q K^T runs as mma.sync m16n8k16 (bf16 in, float32 out) with Q's
//   fragments held in registers and K's loaded by ldmatrix; the mask (only
//   on tiles that cross some row's band), the row max and sum (quad
//   shuffles), exp (the fast __expf) and the rescale stay in registers; P
//   is rounded to bf16 in registers and is the A operand of P V directly,
//   V's fragments coming from ldmatrix.trans.  Keys past the CTA's range
//   land as zeros (cp.async with a zero source size) and are masked.
//
//   Design, float32 (flash_attn_kernel): FMAs on float copies in shared
//   memory, as the first version of the port had it (TF32 tensor cores
//   would break the float32 contract).  128 threads; each thread scores a
//   fixed 8 x 4 (or 2 x 4) patch of the tile, a warp per row updates m and
//   l, and each thread keeps a fixed patch of the accumulator.
//
//   Split key range.  When the grid is small (the fold's 16-query chunk
//   has 32 CTAs), the wrapper splits the key band [split_lo, ...) into
//   runs of split_keys keys (whole tiles of 64), one per CTA; the plan is
//   a function of the shapes alone.  Each CTA then writes its unnormalized
//   float32 state (acc, m, l) to scratch, and a second launch
//   (attn::combine_states, attn_common.cuh) merges the splits in split
//   order and normalizes (and writes the merged rows' lse where asked).  A
//   split in which a row's keys are all masked has m = -1e30 there and
//   drops out of the merge exactly.
#include "attn_common.cuh"

namespace {

using attn::from_f32;
using attn::kNegInf;
using attn::ldsm_x4;
using attn::ldsm_x4_trans;
using attn::mma_bf16;
using attn::mma_ld;
using attn::pack_bf16;
using attn::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                 // keys per tile
constexpr int kMaxD = 128;

// ---------------------------------------------------------------------------
// float32: FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 16;                 // thread columns
constexpr int kTY = kThreads / kTX;     // thread rows (8)
constexpr int kNB = kBK / kTX;          // score columns per thread (4)
constexpr int kMaxC = kMaxD / kTX;      // accumulator columns per thread (8)

// rows of `vpr` 16-byte vectors from src (row stride `stride` elements)
// into float rows of `ld` floats; rows >= n are zero
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, size_t stride,
                                           int rows, int n, int vpr) {
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

// Shared memory, in floats: Q tile [BQ][D + 1], K tile [kBK][D + 1],
// V tile [kBK][D], scores/probabilities [BQ][kBK + 1], then m, l, corr
// [BQ] each.
size_t f32_smem_bytes(int BQ, int D) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)BQ * (kBK + 1) +
                          3 * (size_t)BQ);
}

// The key range [r_lo, r_hi) of this CTA: its queries' band cut to its
// split (split z covers [split_lo + z*split_keys, ... + split_keys)).
struct KeyRange {
  int lo, hi;
};
__device__ __forceinline__ KeyRange key_range(long long p_lo, int nq, int Sk,
                                              int win, int causal,
                                              long long split_lo,
                                              long long split_keys, int z) {
  const long long p_hi = p_lo + nq - 1;
  const long long c_lo = max(0LL, p_lo - win + 1);
  const long long c_hi = causal ? min((long long)Sk, p_hi + 1) : Sk;
  const long long s0 = split_lo + z * split_keys;
  const long long lo = max(c_lo, s0), hi = min(c_hi, s0 + split_keys);
  return {(int)min(lo, (long long)Sk), (int)max(hi, min(lo, (long long)Sk))};
}

// acc_out == nullptr: write acc / max(l, 1e-30) to out; otherwise the
// state of split z to acc_out + z*R*D, m_out + z*R, l_out + z*R (R =
// B*Sq*Hq rows).  Grid (q tiles * splits, Hq, B).
template <int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ lse_out,
                  int Sq, int Sk, int Hq, int Hkv,
                  int D, int q_offset, int win, int causal, float scale,
                  int q_tiles, int split_lo, int split_keys) {
  constexpr int A = BQ / kTY;           // rows per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = D + 1, ldk = D + 1, lds = kBK + 1;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BQ * ldq;
  float* vs = ks + kBK * ldk;
  float* ss = vs + kBK * D;
  float* ms = ss + BQ * lds;
  float* ls = ms + BQ;
  float* cs = ls + BQ;

  const int qt = blockIdx.x % q_tiles, z = blockIdx.x / q_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t q_row = (size_t)Hq * D, k_row = (size_t)Hkv * D;
  const size_t kv0 = (size_t)b * Sk * k_row + (size_t)(h / (Hq / Hkv)) * D;
  const int vpr = D / 4;

  stage_rows(qs, ldq, q + ((size_t)b * Sq + q0) * q_row + (size_t)h * D,
             q_row, BQ, nq, vpr);
  for (int r = tid; r < BQ; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  float acc[A][kMaxC];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) acc[a][c] = 0.f;

  const long long p_lo = (long long)q_offset + q0;
  const KeyRange kr = key_range(p_lo, nq, Sk, win, causal, split_lo,
                                split_keys, z);

  for (int k0 = kr.lo; k0 < kr.hi; k0 += kBK) {
    const int nk = min(kBK, kr.hi - k0);
    __syncthreads();                    // previous tile consumed
    stage_rows(ks, ldk, k + kv0 + (size_t)k0 * k_row, k_row, kBK, nk, vpr);
    stage_rows(vs, D, v + kv0 + (size_t)k0 * k_row, k_row, kBK, nk, vpr);
    __syncthreads();
    // scores: rows ty + kTY*a, keys tx + kTX*n
    float s[A][kNB];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int n = 0; n < kNB; ++n) s[a][n] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[A], kv[kNB];
#pragma unroll
      for (int a = 0; a < A; ++a) qv[a] = qs[(ty + kTY * a) * ldq + d];
#pragma unroll
      for (int n = 0; n < kNB; ++n) kv[n] = ks[(tx + kTX * n) * ldk + d];
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int n = 0; n < kNB; ++n) s[a][n] = fmaf(qv[a], kv[n], s[a][n]);
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int r = ty + kTY * a;
      const long long qp = p_lo + r;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        const int j = tx + kTX * n;
        const long long rel = qp - (k0 + j);
        const bool ok = j < nk && rel < win && (!causal || rel >= 0);
        ss[r * lds + j] = ok ? s[a][n] * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax: one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kBK; j += 32) mx = fmaxf(mx, ss[r * lds + j]);
      mx = attn::warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = expf(ss[r * lds + j] - m_new);
        sum += p;
        ss[r * lds + j] = p;
      }
      sum = attn::warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        cs[r] = c;
        ls[r] = ls[r] * c + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // value product: rows ty + kTY*a, columns tx + kTX*c; key slots past
    // nk hold zero values, so they are left out
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float c = cs[ty + kTY * a];
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) acc[a][cc] *= c;
    }
    for (int j = 0; j < nk; ++j) {
      float pv[A];
#pragma unroll
      for (int a = 0; a < A; ++a) pv[a] = ss[(ty + kTY * a) * lds + j];
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) {
        const int d = tx + kTX * cc;
        if (d < D) {
          const float x = vs[j * D + d];
#pragma unroll
          for (int a = 0; a < A; ++a) acc[a][cc] = fmaf(pv[a], x, acc[a][cc]);
        }
      }
    }
  }
  __syncthreads();
  const size_t R = (size_t)gridDim.z * Sq * Hq;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int r = ty + kTY * a;
    if (r >= nq) continue;
    const size_t row = ((size_t)b * Sq + q0 + r) * Hq + h;
    if (acc_out == nullptr) {
      const float l = fmaxf(ls[r], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) {
        const int d = tx + kTX * cc;
        if (d < D) out[row * D + d] = acc[a][cc] / l;
      }
      if (lse_out != nullptr && tx == 0) lse_out[row] = ms[r] + logf(l);
    } else {
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) {
        const int d = tx + kTX * cc;
        if (d < D) acc_out[(z * R + row) * D + d] = acc[a][cc];
      }
      if (tx == 0) {
        m_out[z * R + row] = ms[r];
        l_out[z * R + row] = ls[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async ring
// ---------------------------------------------------------------------------

// Shared memory: rows of mma_ld(KS) bf16 elements: the Q tile [BQ], then
// the ring, 2 stages x (K [kBK], V [kBK]).
size_t mma_smem_bytes(int BQ, int KS) {
  return sizeof(bf16) * (size_t)(BQ + 4 * kBK) * mma_ld(KS);
}

// KS: D rounded up to 16, in steps of 16; NW warps of 16 query rows.
// Outputs as flash_attn_kernel.
template <int KS, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ lse_out,
                 int Sq, int Sk, int Hq, int Hkv,
                 int D, int q_offset, int win, int causal, float scale,
                 int q_tiles, int split_lo, int split_keys) {
  constexpr int BQ = NW * 16, DP = KS * 16, LD = mma_ld(KS), NT = DP / 8;
  constexpr int kThr = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rows = reinterpret_cast<bf16*>(smem);   // row i at rows + i*LD

  // the last query tiles, which meet the most keys of a causal band, first
  const int qt = q_tiles - 1 - (int)(blockIdx.x % q_tiles);
  const int z = blockIdx.x / q_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_row = (size_t)Hq * D, k_row = (size_t)Hkv * D;
  const size_t kv0 = (size_t)b * Sk * k_row + (size_t)(h / (Hq / Hkv)) * D;
  const int vpr = D / 8;                        // 16-byte vectors per row

  // columns [D, DP) of every row stay zero (never written by cp.async)
  if (DP > D) {
    const int pad = DP - D;
    for (int i = tid; i < (BQ + 4 * kBK) * pad; i += kThr)
      rows[(size_t)(i / pad) * LD + D + i % pad] = __float2bfloat16(0.f);
  }

  const long long p_lo = (long long)q_offset + q0;
  const KeyRange kr = key_range(p_lo, nq, Sk, win, causal, split_lo,
                                split_keys, z);
  const int n_tiles = (kr.hi - kr.lo + kBK - 1) / kBK;

  // row r of base (stride `stride`) into smem row `row`, a thread per row;
  // zeros for r >= n_valid
  auto copy_row = [&](int row, const bf16* base, size_t stride, int r,
                      int n_valid) {
    const bool ok = r < n_valid;
    const bf16* src = ok ? base + (size_t)r * stride : base;
    bf16* dst = rows + (size_t)row * LD;
#pragma unroll
    for (int c = 0; c < 2 * KS; ++c)
      if (c < vpr) attn::cp_async16(dst + c * 8, src + c * 8, ok ? 16 : 0);
  };
  auto issue = [&](int t, int st) {
    const int k0 = kr.lo + t * kBK, nk = min(kBK, kr.hi - k0);
    const size_t off = kv0 + (size_t)k0 * k_row;
    for (int i = tid; i < 2 * kBK; i += kThr) {
      const int which = i >= kBK;                 // 0: K, 1: V
      copy_row(BQ + st * 2 * kBK + i, (which ? v : k) + off, k_row,
               i - which * kBK, nk);
    }
  };
  for (int r = tid; r < BQ; r += kThr)
    copy_row(r, q + ((size_t)b * Sq + q0) * q_row + (size_t)h * D, q_row, r,
             nq);
  if (n_tiles > 0) issue(0, 0);
  attn::cp_async_commit();

  // this thread's accumulator rows g and g + 8 of the warp's 16, columns
  // 2*tq, 2*tq + 1 of each 8-wide n-tile (the mma.sync C layout)
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = warp * 16 + g;
  const long long qp[2] = {p_lo + row_a, p_lo + row_a + 8};
  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1, (t + 1) & 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();                            // tile t (and Q) landed
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], rows + (size_t)(warp * 16 + (lane & 15)) * LD +
                            kk * 16 + (lane >> 4) * 8);
    }
    const int k0 = kr.lo + t * kBK;
    const bf16* ks = rows + (size_t)(BQ + (t & 1) * 2 * kBK) * LD;
    const bf16* vs = ks + (size_t)kBK * LD;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (size_t)(np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                             LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // scale and mask (a tile inside every row's band needs no mask); the
    // row max over the quad
    const bool full = k0 + kBK <= kr.hi &&
                      (!causal || k0 + kBK - 1 <= p_lo) &&
                      p_lo + nq - 1 - k0 < win;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (!full) {
          const int j = k0 + nt * 8 + 2 * tq + (e & 1);
          const long long rel = qp[e >> 1] - j;
          if (!(j < kr.hi && rel < win && (!causal || rel >= 0)))
            x = kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    // P = exp(S - m): unrounded into l, rounded to bf16 as P V's A operand
    float rs[2] = {0.f, 0.f};
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = __expf(s[nt][0] - m_r[0]);
      const float p1 = __expf(s[nt][1] - m_r[0]);
      const float p2 = __expf(s[nt][2] - m_r[1]);
      const float p3 = __expf(s[nt][3] - m_r[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
    // O += P V: 4 k-steps of 16 keys, NT n-tiles of 8 columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (size_t)(kk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LD +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();                            // stage t & 1 consumed
  }
  attn::cp_async_wait<0>();

  const size_t R = (size_t)gridDim.z * Sq * Hq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const int r = row_a + 8 * i;
    if (r >= nq) continue;
    const size_t row = ((size_t)b * Sq + q0 + r) * Hq + h;
    if (acc_out == nullptr) {
      const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int dt = 0; dt < NT; ++dt) {
        const int c = dt * 8 + 2 * tq;
        if (c < D)
          *reinterpret_cast<__nv_bfloat162*>(out + row * D + c) =
              __floats2bfloat162_rn(o[dt][2 * i] / l, o[dt][2 * i + 1] / l);
      }
      if (lse_out != nullptr && tq == 0) lse_out[row] = m_r[i] + logf(l);
    } else {
#pragma unroll
      for (int dt = 0; dt < NT; ++dt) {
        const int c = dt * 8 + 2 * tq;
        if (c < D)
          *reinterpret_cast<float2*>(acc_out + (z * R + row) * D + c) =
              make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
      }
      if (tq == 0) {
        m_out[z * R + row] = m_r[i];
        l_out[z * R + row] = l_r[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int tile_rows(int Sq) { return Sq <= 16 ? 16 : 64; }

struct Args {
  const void *q, *k, *v;
  void *out, *acc, *m, *l, *lse;
  int B, Sq, Sk, Hq, Hkv, D, q_offset, win, causal;
  float scale;
  int splits, split_lo, split_keys;
};

template <typename T, typename Kernel>
cudaError_t run(Kernel kernel, const Args& a, int BQ, int threads,
                size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int q_tiles = (a.Sq + BQ - 1) / BQ;
  const bool split = a.splits > 1;
  const dim3 grid(q_tiles * a.splits, a.Hq, a.B);
  kernel<<<grid, threads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out,
      split ? (float*)a.acc : nullptr, (float*)a.m, (float*)a.l,
      (float*)a.lse, a.Sq, a.Sk,
      a.Hq, a.Hkv, a.D, a.q_offset, a.win, a.causal, a.scale, q_tiles,
      a.split_lo, a.split_keys);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  const long long R = (long long)a.B * a.Sq * a.Hq;
  return attn::combine_states<T>(
      attn::stacked_states((const float*)a.acc, (const float*)a.m,
                           (const float*)a.l),
      a.splits, R, a.D, (T*)a.out, stream, (float*)a.lse);
}

template <int KS>
cudaError_t run_mma(const Args& a, cudaStream_t stream) {
  if (tile_rows(a.Sq) == 16)
    return run<bf16>(flash_mma_kernel<KS, 1>, a, 16, 32,
                     mma_smem_bytes(16, KS), stream);
  return run<bf16>(flash_mma_kernel<KS, 4>, a, 64, 128,
                   mma_smem_bytes(64, KS), stream);
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
  if (tile_rows(a.Sq) == 16)
    return run<float>(flash_attn_kernel<16>, a, 16, kThreads,
                      f32_smem_bytes(16, a.D), stream);
  return run<float>(flash_attn_kernel<64>, a, 64, kThreads,
                    f32_smem_bytes(64, a.D), stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows of D elements must be whole
// 16-byte vectors, D <= 128, Hq a multiple of Hkv, and every pointer
// 16-byte aligned (the wrapper checks).  The key band is swept in
// `splits` runs of `split_keys` keys from `split_lo` (split_keys a
// multiple of 64); with splits > 1, acc (splits, B, Sq, Hq, D), m, l
// (splits, B, Sq, Hq) float32 are the scratch the combine launch reads.
// lse: null, or (B, Sq, Hq) float32 for the rows' log-sum-exp.  Returns
// cudaGetLastError() after the last launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, void* acc, void* m, void* l,
                                 void* lse, int B, int Sq, int Sk, int Hq,
                                 int Hkv, int D, int q_offset, int win,
                                 int causal,
                                 float scale, int dtype, int splits,
                                 int split_lo, int split_keys, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hq > 65535 ||
      Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD ||
      (D * elem) % 16 != 0 || q_offset < 0 || win <= 0 ||
      (dtype != 0 && dtype != 1) || splits <= 0 || split_lo < 0 ||
      split_keys <= 0 || split_keys % kBK != 0 ||
      (long long)((Sq + tile_rows(Sq) - 1) / tile_rows(Sq)) * splits >
          0x7fffffffLL ||
      (splits > 1 && (acc == nullptr || m == nullptr || l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,   out, acc, m,        l,   lse,    B,
               Sq, Sk, Hq,  Hkv, D,   q_offset, win, causal, scale,
               splits, split_lo, split_keys};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? run_f32(a, s) : run_bf16(a, s));
}

// Shared-memory bytes flash_attn_launch asks for at these sizes (the
// wrapper refuses a call above the card's per-block limit).
extern "C" long long flash_attn_smem_bytes(int Sq, int D, int dtype) {
  const int BQ = tile_rows(Sq);
  return (long long)(dtype == 0 ? f32_smem_bytes(BQ, D)
                                : mma_smem_bytes(BQ, (D + 15) / 16));
}
