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
//   Three launches, no atomics, and an order of every sum fixed by the
//   shapes alone, so a call is reproducible bit for bit:
//     delta_kernel   one warp per (b, i, h) row: delta over D.
//     dkdv_kernel    one CTA per (key tile of 64, KV head, batch row): the
//                    tile's K and V stay in shared memory; it loops over the
//                    group's query heads and, for each, over the query
//                    tiles of 64 that meet a key of the tile (the causal /
//                    window band, so tiles outside it are never read),
//                    accumulating dk and dv in registers.
//     dq_kernel      one CTA per (query tile of 64, head, batch row): the
//                    tile's q, dout, lse and delta stay in shared memory;
//                    it loops over the key tiles of 64 in the tile's band
//                    (the forward's key range), accumulating dq.
//   Each recomputes s and dp for its tiles.  The products are float32
//   FMAs on float copies of the tiles in shared memory (bf16 inputs are
//   widened as they land): 256 threads, each computing a fixed 4 x 4 patch
//   of a 64 x 64 score tile (rows ty + 16 a, columns tx + 16 n) and a fixed
//   4 x 8 patch of a 64 x D accumulator (rows ty + 16 a, columns tx + 16 c);
//   rows are padded to D + 1 floats so the column reads fall in distinct
//   banks.  Speed is not the design's aim: tensor cores (mma.sync / wgmma)
//   would be the next step.
#include "attn_common.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kB = 64;                  // queries and keys per tile
constexpr int kThreads = 256;
constexpr int kTX = 16;                 // thread columns
constexpr int kTY = kThreads / kTX;     // thread rows (16)
constexpr int kR = kB / kTY;            // tile rows per thread (4)
constexpr int kN = kB / kTX;            // score columns per thread (4)
constexpr int kMaxD = 128;
constexpr int kMaxC = kMaxD / kTX;      // accumulator columns per thread (8)
constexpr int kLdS = kB + 1;            // row stride of a score tile

// ds in the inputs' dtype, as float
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [0, rows) of src (row stride `stride` elements, D elements a row,
// read in 16-byte vectors) into float rows of `ld` floats; rows >= n zero
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      size_t stride, int rows, int n, int D) {
  constexpr int E = 16 / sizeof(T);     // elements per vector
  const int vpr = D / E;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = i - r * vpr;
    float* d = dst + r * ld + c * E;
    if (r < n) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * stride) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < E; ++j) d[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) d[j] = 0.f;
    }
  }
}

// Shared memory of the two tile kernels, in floats: four 64 x (D + 1)
// tiles, two 64 x 65 score tiles, lse and delta [64] each.
size_t smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)kB * (D + 1) + 2 * (size_t)kB * kLdS +
                          2 * (size_t)kB);
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

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, D, q_offset, win, causal;
  float scale;
};

// The scores and dp of one query tile (rows i, queries q0 + i) against one
// key tile (columns j, keys k0 + j), masked, turned into p and the rounded
// ds, written to ps and dss (each [64][65]); ps may be null.
template <typename T>
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
      dss[i * kLdS + j] = round_to<T>(p * (dp[a][n] - dls[i]) * scale);
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

// Grid (key tiles, Hkv, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const Args a) {
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

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  const int nk = min(kB, a.Sk - k0);
  const int n_rep = a.Hq / a.Hkv;
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

  // the queries that see a key of [k0, k0 + nk): absolute positions
  // [k0 (causal) or 0, k0 + nk - 1 + win - 1]
  const long long pos_lo = a.causal ? k0 : 0;
  const long long pos_hi = (long long)k0 + nk - 1 + a.win - 1;
  const int i_lo = (int)max(0LL, pos_lo - a.q_offset);
  const int i_hi = (int)min((long long)a.Sq, pos_hi - a.q_offset + 1);

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    for (int q0 = (i_lo / kB) * kB; q0 < i_hi; q0 += kB) {
      const int nq = min(kB, a.Sq - q0);
      __syncthreads();                  // the previous tile consumed
      const size_t qoff = ((size_t)b * a.Sq + q0) * q_row + (size_t)h * D;
      stage(qs, ld, q + qoff, q_row, kB, nq, D);
      stage(os, ld, dout + qoff, q_row, kB, nq, D);
      stage_rows(ls, dls, a.lse, a.delta, ((size_t)b * a.Sq + q0) * a.Hq + h,
                 a.Hq, nq);
      __syncthreads();
      score_tile<T>(qs, os, ks, vs, ls, dls, ps, dss, ld, D,
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
  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int j = ty + kTY * rr;
    if (j >= nk) continue;
    const size_t row = ((size_t)b * a.Sk + k0 + j) * k_row + (size_t)hk * D;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = tx + kTX * c;
      if (d < D) {
        dk_out[row + d] = from_f32<T>(dk[rr][c]);
        dv_out[row + d] = from_f32<T>(dv[rr][c]);
      }
    }
  }
}

// Grid (query tiles, Hq, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ld = D + 1;
  float* qs = reinterpret_cast<float*>(smem);
  float* os = qs + kB * ld;
  float* ks = os + kB * ld;
  float* vs = ks + kB * ld;
  float* dss = vs + kB * ld;
  float* ls = dss + kB * kLdS;
  float* dls = ls + kB;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
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

  // the forward's key band of this tile
  const long long p_lo = (long long)a.q_offset + q0, p_hi = p_lo + nq - 1;
  const int k_lo = (int)min((long long)a.Sk, max(0LL, p_lo - a.win + 1));
  const int k_hi = a.causal ? (int)min((long long)a.Sk, p_hi + 1) : a.Sk;

  for (int k0 = k_lo; k0 < k_hi; k0 += kB) {
    const int nk = min(kB, k_hi - k0);
    __syncthreads();                    // the previous tile consumed
    const size_t kv0 = ((size_t)b * a.Sk + k0) * k_row + (size_t)hk * D;
    stage(ks, ld, k + kv0, k_row, kB, nk, D);
    stage(vs, ld, v + kv0, k_row, kB, nk, D);
    __syncthreads();
    score_tile<T>(qs, os, ks, vs, ls, dls, nullptr, dss, ld, D, p_lo, nq, k0,
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
  T* dq_out = static_cast<T*>(a.dq);
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int i = ty + kTY * rr;
    if (i >= nq) continue;
    const size_t row = ((size_t)b * a.Sq + q0 + i) * q_row + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = tx + kTX * c;
      if (d < D) dq_out[row + d] = from_f32<T>(dq[rr][c]);
    }
  }
}

template <typename T>
cudaError_t run(const Args& a, cudaStream_t stream) {
  cudaError_t e = attn::allow_max_smem<dkdv_kernel<T>>();
  if (e != cudaSuccess) return e;
  e = attn::allow_max_smem<dq_kernel<T>>();
  if (e != cudaSuccess) return e;
  const long long R = (long long)a.B * a.Sq * a.Hq;
  const int rows_per_block = kThreads / 32;
  delta_kernel<T><<<(unsigned)((R + rows_per_block - 1) / rows_per_block),
                    kThreads, 0, stream>>>(static_cast<const T*>(a.out),
                                           static_cast<const T*>(a.dout),
                                           a.delta, R, a.D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(a.D);
  dkdv_kernel<T><<<dim3((a.Sk + kB - 1) / kB, a.Hkv, a.B), kThreads, smem,
                   stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<T><<<dim3((a.Sq + kB - 1) / kB, a.Hq, a.B), kThreads, smem,
                 stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows of D elements must be whole
// 16-byte vectors, D <= 128, Hq a multiple of Hkv, every pointer 16-byte
// aligned and every tensor contiguous (the wrapper checks); delta is
// float32 scratch of B * Sq * Hq values.  Returns cudaGetLastError()
// after the last launch.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* out, const void* dout,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int B, int Sq, int Sk,
                                int Hq, int Hkv, int D, int q_offset,
                                int win, int causal, float scale, int dtype,
                                void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hq > 65535 ||
      Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD ||
      (D * elem) % 16 != 0 || q_offset < 0 || win <= 0 ||
      (dtype != 0 && dtype != 1) ||
      (long long)B * Sq * Hq > 0x7fffffffLL * (kThreads / 32))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  out, dout, (const float*)lse, (float*)delta,
               dq, dk, dv, B,   Sq,   Sk,  Hq,  Hkv, D,  q_offset,
               win, causal, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? run<float>(a, s) : run<bf16>(a, s));
}

// Shared-memory bytes each tile kernel asks for at head width D (the
// wrapper refuses a call above the card's per-block limit).
extern "C" long long flash_bwd_smem_bytes(int D) {
  return (long long)smem_bytes(D);
}
