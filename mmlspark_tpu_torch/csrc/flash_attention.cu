// Flash attention for Hopper (sm_90a): the forward and the two backward
// kernels of the zoo transformer's attention.
//
//   K7   fa_fwd_kernel (float32), fa_fwd_mma_kernel (bfloat16). Replaces
//        the TPU kernel `_fa_kernel` (mmlspark_tpu/ops/flash_attention.py,
//        launched by `_flash_fwd`).
//   K8a  fa_bwd_dkv_kernel (float32), fa_bwd_dkv_mma_kernel (bfloat16).
//        Replaces `_fa_bwd_dkv_kernel` (launched by `_flash_bwd_pallas`):
//        dK and dV.
//   K8b  fa_bwd_dq_kernel. Replaces `_fa_bwd_dq_kernel` (same launcher): dQ.
//
// What they compute. q, k, v, o are (BH, S, D) slabs of (B, H, S, D)
// tensors in float32 or bfloat16 (f32 arithmetic); mask is an
// optional (B, S) byte mask (nonzero = attend) shared by the H heads of a
// batch element (row b = bh / H). Key j is valid for query i when j < S,
// mask[b][j] != 0 and, when causal, j <= i. With s = (q_i . k_j) * scale:
//
//   K7   m_i = max over valid j of s (-1e30 when none), l_i = sum over
//        valid j of exp(s - m_i), o_i = sum p v_j / l_i with o_i = 0 when
//        l_i == 0 (a fully masked row gives 0, not NaN); l and m are
//        written per row (f32 (BH, S)) when the caller asks for the stats.
//   K8   p = exp(s - m_i) * linv_i on valid pairs (0 elsewhere), linv =
//        1 / l or 0 where l == 0; dp = dO_i . v_j; ds = p (dp - delta_i)
//        scale with delta = rowsum(dO * O) computed by the caller.
//        K8a: dV_j = sum_i p dO_i, dK_j = sum_i ds q_i.
//        K8b: dQ_i = sum_j ds k_j.
//
// Masked probabilities are selected to 0 by `valid`, never left to exp
// underflow: while a row has seen only masked keys its running max is
// -1e30 and exp(s - m) would be 1. Rows of K and V whose key is masked or
// past S are zero-filled on load, and so are q/dO rows past S, so a NaN
// stored in a padded row cannot reach a product (0 * NaN would).
//
// Design. The TPU kernels walk a sequential (bh, q block, k block) grid and
// carry the running (m, l, acc) in VMEM scratch from one grid step to the
// next. Here one block owns one 64-query tile (K7, K8b) or one 64-key tile
// (K8a) of one (b, h) and loops over the other axis inside the block; the
// running state stays in registers. The causal mask skips whole tiles
// that no query of the tile can see (K7, K8b: key tiles whose first key is
// past the tile's last query; K8a: query tiles whose last query is before
// the tile's first key) and is applied per element inside the diagonal
// tiles. Skipped tiles contribute exactly 0, so this agrees with the
// reference's coarser block skip. The sequence is not padded: keys and
// queries past S are masked here. K8a and K8b use no atomics: each output
// element has one owner, so the gradients are the same from run to run.
//
// What bounds them on this card: operations. At BERT-base (S = 512,
// D = 64) the forward does 4 S^2 D flops per (b, h) against 8 S D bytes
// of bf16 q/k/v/o, about 128 flops per byte, and the backward about 14 S^2
// D flops; both are far above the H100's balance point only if the flops
// run on the tensor cores (989 TFLOP/s of bf16 against 67 TFLOP/s of f32
// FMA). Two bodies:
//
// - bf16, K7 and K8a: tensor cores. A block of 4 warps owns 64 rows, 16
//   a warp. Tiles stay bf16 in shared memory (rows padded by 8 elements,
//   so that ldmatrix is free of bank conflicts) and arrive by cp.async,
//   double-buffered: tile t + 1 loads while tile t computes. Products are
//   mma.sync m16n8k16 with f32 accumulation (products of bf16 values are
//   exact in f32). The softmax runs in registers on the accumulator
//   fragments; P (and K8a's dS) is rounded to bf16 once and repacked from
//   the accumulator fragment into the A fragment of the next product, with
//   no trip through shared memory. l sums the unrounded f32 P. K8a works
//   in the key-rows form (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T
//   are A fragments as they come. A 64-key tile whose mask bytes are all
//   zero is skipped whole (K7: never loaded; K8a: writes zero dK/dV rows),
//   which is exact: it would add 0 to l and to every sum.
// - float32, and K8b in both types: plain FMA from shared memory. 256
//   threads form a 16 x 16 grid: thread (ty, tx) computes the scores of
//   rows ty + 16 i and columns tx + 16 j (i, j < 4), and owns the output
//   rows ty + 16 i and columns tx + 16 c (c < D / 16). Tiles sit in shared
//   memory as f32 rows padded to D + 1; loads are not pipelined. The f32
//   body keeps card and host results equal to 1e-5.
//
// Shared memory per block: bf16 K7 Q + 2 stages of K, V = 5 * 64 * (D + 8)
// * 2 bytes (85 KB at D = 128); bf16 K8a K, V + 2 stages of Q, dO and the
// row stats = 104 KB at D = 128; f32 (LD = D + 1): K7 3 tiles + P = 116 KB
// at D = 128, K8b 4 tiles + dS = 149 KB, K8a 4 tiles + P + dS + row stats
// = 166 KB. Above 48 KB it is dynamic memory, opted into with
// cudaFuncSetAttribute.
//
// Build: mmlspark_tpu_torch/utils/cuda_build.py runs nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC on this file
// (never --use_fast_math: 1 / l, expf and exp2f stay IEEE-accurate).
// Interface: plain C, loaded with ctypes; every entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kTile = 64;       // queries per query tile = keys per key tile
constexpr int kR = kTile / 16;  // score rows / columns per thread
constexpr int kLP = kTile + 1;  // padded row of a P or dS tile
constexpr float kNeg = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, bf16* dst) {
  *dst = __float2bfloat16(v);
}

// reductions across the 16 lanes that share a score row (a half warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load rows [r0, r0 + kTile) of a (S, HD) slab into a shared f32 tile
// [kTile][HD + 1]. A row past S, or whose mask byte is 0 (mask may be
// null), is zero-filled and never read. 16-byte vector loads, all issued
// before the first store.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int S,
                                          const uint8_t* __restrict__ mask,
                                          float* __restrict__ dst) {
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;           // chunks per row
  constexpr int ITER = kTile * CPR / kThreads;
  static_assert(kTile * CPR % kThreads == 0, "tile chunks per thread");
  constexpr int LD = HD + 1;
  uint4 buf[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int r = r0 + c / CPR;
    const bool ok = r < S && (mask == nullptr || mask[r] != 0);
    buf[it] = ok ? reinterpret_cast<const uint4*>(src + (size_t)r * HD)[c % CPR]
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const T* v = reinterpret_cast<const T*>(&buf[it]);
    float* d = dst + (c / CPR) * LD + (c % CPR) * EPC;
#pragma unroll
    for (int e = 0; e < EPC; ++e) d[e] = to_f32(v[e]);
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two shared tiles
template <int HD>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx, float (&s)[kR][kR]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float x[kR], y[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) x[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < kR; ++j) y[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

__device__ __forceinline__ bool key_valid(int key, int query, int S,
                                          const uint8_t* __restrict__ mask,
                                          int causal) {
  return key < S && (mask == nullptr || mask[key] != 0) &&
         (!causal || key <= query);
}

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * size_t(kTile) * (HD + 1) + size_t(kTile) * kLP);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * size_t(kTile) * (HD + 1) + size_t(kTile) * kLP);
}
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * size_t(kTile) * (HD + 1) + 2 * size_t(kTile) * kLP + 3 * kTile);
}

// ---- K7 ----------------------------------------------------------------------

template <typename T, int HD, bool STATS>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              T* __restrict__ o, float* __restrict__ l_out,
              float* __restrict__ m_out, int H, int S, float scale,
              int causal) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * HD;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * S : nullptr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD>(q + base, q0, S, nullptr, q_s);

  float m[kR], l[kR], acc[kR][CPT];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // a causal tile sees no key past its last query
  const int k_end = causal ? min(q0 + kTile, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the previous tile's reads of k_s / v_s are done
    load_tile<T, HD>(k + base, k0, S, mrow, k_s);
    load_tile<T, HD>(v + base, k0, S, mrow, v_s);
    __syncthreads();
    float s[kR][kR];
    tile_dot<HD>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[kR];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        ok[j] = key_valid(k0 + tx + 16 * j, row, S, mrow, causal);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kLP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = corr * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // a P row is written and read by one half warp
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pa[kR], vb[CPT];
#pragma unroll
      for (int i = 0; i < kR; ++i) pa[i] = p_s[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vb[c] = v_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float div = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(acc[i][c] / div, o + base + (size_t)row * HD + tx + 16 * c);
    if constexpr (STATS) {
      if (tx == 0) {
        l_out[(size_t)bh * S + row] = l[i];
        m_out[(size_t)bh * S + row] = m[i];
      }
    }
  }
}

// ---- K8b ---------------------------------------------------------------------

// the per-row backward inputs of query `row`: m, linv = 1 / l (0 where
// l == 0) and delta; a row past S gets linv = 0, so its p is 0
struct RowStats {
  float m, linv, delta;
};
__device__ __forceinline__ RowStats row_stats(const float* __restrict__ m,
                                              const float* __restrict__ l,
                                              const float* __restrict__ delta,
                                              size_t off, int row, int S) {
  if (row >= S) return {0.f, 0.f, 0.f};
  const float lv = l[off + row];
  return {m[off + row], lv == 0.f ? 0.f : 1.f / lv, delta[off + row]};
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 const T* __restrict__ dout, const float* __restrict__ m_in,
                 const float* __restrict__ l_in,
                 const float* __restrict__ delta_in, T* __restrict__ dq,
                 int H, int S, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * HD;
  const size_t soff = (size_t)bh * S;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * S : nullptr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD>(q + base, q0, S, nullptr, q_s);
  load_tile<T, HD>(dout + base, q0, S, nullptr, do_s);
  RowStats rs[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
    rs[i] = row_stats(m_in, l_in, delta_in, soff, q0 + ty + 16 * i, S);

  float acc[kR][CPT];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(q0 + kTile, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(k + base, k0, S, mrow, k_s);
    load_tile<T, HD>(v + base, k0, S, mrow, v_s);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    tile_dot<HD>(q_s, k_s, ty, tx, s);
    tile_dot<HD>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const bool ok = key_valid(k0 + tx + 16 * j, row, S, mrow, causal);
        const float p = ok ? expf(s[i][j] * scale - rs[i].m) * rs[i].linv
                           : 0.f;
        ds_s[(ty + 16 * i) * kLP + tx + 16 * j] =
            p * (dp[i][j] - rs[i].delta) * scale;
      }
    }
    __syncwarp();   // a dS row is written and read by one half warp
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float da[kR], kb[CPT];
#pragma unroll
      for (int i = 0; i < kR; ++i) da[i] = ds_s[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kb[c] = k_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(da[i], kb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(acc[i][c], dq + base + (size_t)row * HD + tx + 16 * c);
  }
}

// ---- K8a ---------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ mask,
                  const T* __restrict__ dout, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ delta_in, T* __restrict__ dk,
                  T* __restrict__ dv, int H, int S, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;        // [query][key]
  float* ds_s = p_s + kTile * kLP;       // [query][key]
  float* stat_s = ds_s + kTile * kLP;    // m, linv, delta of the query tile

  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * HD;
  const size_t soff = (size_t)bh * S;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * S : nullptr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD>(k + base, k0, S, mrow, k_s);
  load_tile<T, HD>(v + base, k0, S, mrow, v_s);

  // this tile's keys: rows ty + 16 i of dK / dV, columns tx + 16 c
  float adk[kR][CPT], adv[kR][CPT];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adk[i][c] = adv[i][c] = 0.f;

  // a causal key tile is seen by no query before its first key
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < S; q0 += kTile) {
    __syncthreads();   // the previous query tile's reads are done
    load_tile<T, HD>(q + base, q0, S, nullptr, q_s);
    load_tile<T, HD>(dout + base, q0, S, nullptr, do_s);
    if (threadIdx.x < kTile) {
      const RowStats r =
          row_stats(m_in, l_in, delta_in, soff, q0 + threadIdx.x, S);
      stat_s[threadIdx.x] = r.m;
      stat_s[kTile + threadIdx.x] = r.linv;
      stat_s[2 * kTile + threadIdx.x] = r.delta;
    }
    __syncthreads();
    // scores of queries ty + 16 i against keys tx + 16 j
    float s[kR][kR], dp[kR][kR];
    tile_dot<HD>(q_s, k_s, ty, tx, s);
    tile_dot<HD>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = ty + 16 * i;
      const float mi = stat_s[qi], linv = stat_s[kTile + qi],
                  delta = stat_s[2 * kTile + qi];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const bool ok = key_valid(k0 + tx + 16 * j, q0 + qi, S, mrow, causal);
        const float p = ok ? expf(s[i][j] * scale - mi) * linv : 0.f;
        p_s[qi * kLP + tx + 16 * j] = p;
        ds_s[qi * kLP + tx + 16 * j] = p * (dp[i][j] - delta) * scale;
      }
    }
    __syncthreads();   // dK / dV read P and dS by key column
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pa[kR], da[kR], ob[CPT], qb[CPT];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        pa[i] = p_s[qq * kLP + ty + 16 * i];
        da[i] = ds_s[qq * kLP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ob[c] = do_s[qq * LD + tx + 16 * c];
        qb[c] = q_s[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          adv[i][c] = fmaf(pa[i], ob[c], adv[i][c]);
          adk[i][c] = fmaf(da[i], qb[c], adk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const size_t at = base + (size_t)key * HD + tx + 16 * c;
      store(adk[i][c], dk + at);
      store(adv[i][c], dv + at);
    }
  }
}

// ---- bf16 on tensor cores: K7 and K8a --------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps, 16 rows of a 64-row tile each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously. With ok false the 16 bytes
// are zero-filled (src-size 0) and the source is never read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8, and register j receives matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
// Fragments (g = lane / 4, t = lane % 4): c[0..1] row g, columns 2 t and
// 2 t + 1, c[2..3] row g + 8; a[0] row g, k 2 t .. 2 t + 1, a[1] row
// g + 8, a[2] and a[3] the same at k + 8; b[0] k 2 t .. 2 t + 1 of column
// g, b[1] at k + 8.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half, as a fragment
// holds its lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory row of a bf16 tile: D + 8 elements, so that the 8 rows an
// ldmatrix phase reads fall on distinct banks.
template <int HD>
__host__ __device__ constexpr int mma_ld() {
  return HD + 8;
}
template <int HD>
constexpr size_t tile_bytes() {
  return size_t(kTile) * mma_ld<HD>() * sizeof(bf16);
}
template <int HD>
constexpr size_t fwd_mma_smem() {
  return 5 * tile_bytes<HD>();   // Q, and K, V in each of 2 stages
}
template <int HD>
constexpr size_t dkv_mma_smem() {
  // K, V; Q, dO in each of 2 stages; m, l, delta in each of 2 stages
  return 6 * tile_bytes<HD>() + 2 * 3 * kTile * sizeof(float);
}

// Start the async copy of rows [r0, r0 + kTile) of a bf16 (S, HD) slab
// into a shared tile [kTile][HD + 8]. A row past S, or whose mask byte is
// 0 (mask may be null), is zero-filled and never read.
template <int HD>
__device__ __forceinline__ void load_tile_async(
    const bf16* __restrict__ src, int r0, int S,
    const uint8_t* __restrict__ mask, bf16* __restrict__ dst) {
  constexpr int LDS = mma_ld<HD>();
  constexpr int CPR = HD / 8;   // 16-byte chunks per row
  constexpr int ITER = kTile * CPR / kMmaThreads;
  static_assert(kTile * CPR % kMmaThreads == 0, "tile chunks per thread");
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int c = threadIdx.x + it * kMmaThreads;
    const int r = c / CPR, cc = (c % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < S && (mask == nullptr || mask[row] != 0);
    cp_async16(dst + r * LDS + cc, ok ? src + (size_t)row * HD + cc : src,
               ok);
  }
}

// The first key tile at or after `from` (a multiple of kTile) and before
// `end` that holds a valid key, or `end`. Every thread of the block calls
// it with the same arguments; each vote is a block barrier, and at least
// one is taken whenever from < end.
__device__ __forceinline__ int next_live_tile(
    int from, int end, int S, const uint8_t* __restrict__ mask) {
  for (; from < end; from += kTile) {
    const int key = from + (threadIdx.x & (kTile - 1));
    const bool live = mask == nullptr || (key < S && mask[key] != 0);
    if (__syncthreads_or(live)) break;
  }
  return from;
}

// K7, bf16. Block: 64 queries of one (b, h); warp w owns queries 16 w ..
// 16 w + 15 and keeps their Q as A fragments in registers. Per key tile:
// S = Q K^T (K rows are the col-major B operand as stored), the online
// softmax on the accumulator fragments (a row's max reduces over the 4
// lanes of a quad; each lane keeps its part of l until the end), then
// O += bf16(P) V with V's B fragments from ldmatrix.trans. m is kept in
// log2 units (exp2 with log2(e) folded into the scale) and written back
// in natural-log units.
template <int HD, bool STATS>
__global__ void __launch_bounds__(kMmaThreads)
fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v,
                  const uint8_t* __restrict__ mask, bf16* __restrict__ o,
                  float* __restrict__ l_out, float* __restrict__ m_out,
                  int H, int S, float scale, int causal) {
  constexpr int LDS = mma_ld<HD>();
  constexpr int KS = HD / 16;    // k16 steps over the head dim
  constexpr int ON = HD / 8;     // n8 tiles of an output row
  constexpr int SN = kTile / 8;  // n8 tiles of a score row
  constexpr int CPR = HD / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + kTile * LDS;   // [stage][K, V][kTile][LDS]

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * HD;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * S : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sc = scale * kLog2e;

  load_tile_async<HD>(q + base, q0, S, nullptr, q_s);
  cp_commit();
  // a causal tile sees no key past its last query
  const int k_end = causal ? min(q0 + kTile, S) : S;
  int cur = next_live_tile(0, k_end, S, mrow);
  if (cur < k_end) {
    load_tile_async<HD>(k + base, cur, S, mrow, kv_s);
    load_tile_async<HD>(v + base, cur, S, mrow, kv_s + kTile * LDS);
  }
  cp_commit();
  cp_wait<1>();   // Q has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                        (lane >> 4) * 8);

  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};   // rows g, g + 8
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int stage = 0;
  while (cur < k_end) {
    // the vote is also the barrier after which no warp reads stage ^ 1
    const int nxt = next_live_tile(cur + kTile, k_end, S, mrow);
    if (nxt < k_end) {
      bf16* dst = kv_s + (stage ^ 1) * 2 * kTile * LDS;
      load_tile_async<HD>(k + base, nxt, S, mrow, dst);
      load_tile_async<HD>(v + base, nxt, S, mrow, dst + kTile * LDS);
    }
    cp_commit();
    cp_wait<1>();   // this tile has landed (the next may be in flight)
    __syncthreads();
    const bf16* k_s = kv_s + stage * 2 * kTile * LDS;
    const bf16* v_s = k_s + kTile * LDS;

    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // key validity of this lane's 16 columns (keys cur + 8 n + 2 t + e)
    uint32_t kbits = 0;
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = cur + 8 * n + 2 * t + e;
        if (key < S && (mrow == nullptr || mrow[key] != 0))
          kbits |= 1u << (2 * n + e);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + warp * 16 + g + 8 * hr;
      uint32_t ok = kbits;
      if (causal) {
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (cur + 8 * n + 2 * t + e > row) ok &= ~(1u << (2 * n + e));
      }
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = (ok >> (2 * n + e)) & 1u ? x * sc : kNeg;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      const float corr = exp2f(m_r[hr] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = (ok >> (2 * n + e)) & 1u ? exp2f(x - m_new) : 0.f;
          ps += x;
        }
      l_r[hr] = corr * l_r[hr] + ps;   // this lane's part of the row sum
      m_r[hr] = m_new;
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // O += bf16(P) V: the score fragments of keys 16 kk .. 16 kk + 15 are
    // the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ON / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, v_s + (kk * 16 + (lane & 15)) * LDS + dp * 16 +
                         (lane >> 4) * 8);
        mma(acc[2 * dp], a, b[0], b[1]);
        mma(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    cur = nxt;
    stage ^= 1;
  }
  cp_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 1);
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 2);
  }
  // o through this warp's own Q rows (read only by it, above), then
  // 16-byte stores
  bf16* o_s = q_s + warp * 16 * LDS;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float div = l_r[hr] == 0.f ? 1.f : l_r[hr];
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o_s + (g + 8 * hr) * LDS + 8 * n +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * hr] / div,
                                acc[n][2 * hr + 1] / div);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + base + (size_t)row * HD + cc) =
          *reinterpret_cast<const uint4*>(o_s + r * LDS + cc);
  }
  if constexpr (STATS) {
    if (t == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + warp * 16 + g + 8 * hr;
        if (row >= S) continue;
        l_out[(size_t)bh * S + row] = l_r[hr];
        m_out[(size_t)bh * S + row] =
            m_r[hr] == kNeg ? kNeg : m_r[hr] * kLn2;
      }
    }
  }
}

// K8a, bf16. Block: 64 keys of one (b, h); warp w owns keys 16 w ..
// 16 w + 15 and their dK, dV rows. The loop runs over query tiles (Q, dO
// and the row stats double-buffered by cp.async); each warp takes a tile
// 16 queries at a time in the key-rows form: S^T = K_w Q^T and dP^T =
// V_w dO^T (Q and dO rows are the col-major B operand as stored), P^T and
// dS^T on the accumulator fragments, then dV_w += bf16(P^T) dO and dK_w +=
// bf16(dS^T) Q with B fragments from ldmatrix.trans. K_w and V_w stay A
// fragments in registers up to D = 64; at D = 128 they are read from
// shared memory at each use, which leaves the registers to the dK and dV
// accumulators (128 a thread).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ m_in,
                      const float* __restrict__ l_in,
                      const float* __restrict__ delta_in,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                      int S, float scale, int causal) {
  constexpr int LDS = mma_ld<HD>();
  constexpr int KS = HD / 16;
  constexpr int ON = HD / 8;
  constexpr int CPR = HD / 8;
  constexpr bool kRegKV = HD <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile * LDS;
  bf16* qd_s = v_s + kTile * LDS;   // [stage][Q, dO][kTile][LDS]
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * kTile * LDS);
  // st_s: [stage][m, l, delta][kTile]

  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * HD;
  const size_t soff = (size_t)bh * S;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * S : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sc = scale * kLog2e;

  // a key tile with no valid key: its dK and dV rows are 0
  const int key_end = min(k0 + kTile, S);
  const int my_key = k0 + int(threadIdx.x & (kTile - 1));
  if (!__syncthreads_or(my_key < key_end &&
                        (mrow == nullptr || mrow[my_key] != 0))) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = threadIdx.x; c < (key_end - k0) * CPR; c += kMmaThreads) {
      const size_t at = base + (size_t)(k0 + c / CPR) * HD + (c % CPR) * 8;
      *reinterpret_cast<uint4*>(dk + at) = zero;
      *reinterpret_cast<uint4*>(dv + at) = zero;
    }
    return;
  }

  // one query tile's Q, dO (rows past S zero-filled) and row stats (0
  // past S, so linv = 0 there and its p is 0)
  auto fetch = [&](int qt, int st) {
    bf16* dst = qd_s + st * 2 * kTile * LDS;
    load_tile_async<HD>(q + base, qt, S, nullptr, dst);
    load_tile_async<HD>(dout + base, qt, S, nullptr, dst + kTile * LDS);
    for (int i = threadIdx.x; i < 3 * kTile; i += kMmaThreads) {
      const int which = i / kTile, r = i % kTile, row = qt + r;
      const float* src = which == 0 ? m_in : which == 1 ? l_in : delta_in;
      const bool ok = row < S;
      cp_async4(st_s + (st * 3 + which) * kTile + r,
                src + soff + (ok ? row : 0), ok);
    }
  };

  load_tile_async<HD>(k + base, k0, S, mrow, k_s);
  load_tile_async<HD>(v + base, k0, S, mrow, v_s);
  cp_commit();
  // a causal key tile is seen by no query before its first key
  int q0 = causal ? k0 : 0;
  fetch(q0, 0);
  cp_commit();
  cp_wait<1>();   // K and V have landed
  __syncthreads();

  // this warp's key rows: A fragments of K_w and V_w
  const bf16* kw_s = k_s + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  const bf16* vw_s = v_s + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  uint32_t kf[kRegKV ? KS : 1][4], vf[kRegKV ? KS : 1][4];
  if constexpr (kRegKV) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(kf[kk], kw_s + kk * 16);
      ldsm_x4(vf[kk], vw_s + kk * 16);
    }
  }
  bool key_ok[2];
  int key_row[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    key_row[hr] = k0 + warp * 16 + g + 8 * hr;
    key_ok[hr] =
        key_row[hr] < S && (mrow == nullptr || mrow[key_row[hr]] != 0);
  }

  float adk[ON][4], adv[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  int stage = 0;
  for (; q0 < S; q0 += kTile) {
    __syncthreads();   // no warp still reads stage ^ 1
    if (q0 + kTile < S) fetch(q0 + kTile, stage ^ 1);
    cp_commit();
    cp_wait<1>();   // this tile has landed
    __syncthreads();
    const bf16* q_s = qd_s + stage * 2 * kTile * LDS;
    const bf16* do_s = q_s + kTile * LDS;
    const float* m_s = st_s + stage * 3 * kTile;
    const float* l_s = m_s + kTile;
    const float* d_s = l_s + kTile;

#pragma unroll 1
    for (int qc = 0; qc < kTile / 16; ++qc) {
      // S^T and dP^T of this warp's 16 keys against queries 16 qc ..
      // 16 qc + 15: n8 tile n holds queries 16 qc + 8 n + 2 t + e
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      const int brow = (qc * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4], b[4];
        if constexpr (kRegKV) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = kf[kk][j];
        } else {
          ldsm_x4(a, kw_s + kk * 16);
        }
        ldsm_x4(b, q_s + brow + kk * 16);
        mma(s[0], a, b[0], b[1]);
        mma(s[1], a, b[2], b[3]);
        if constexpr (kRegKV) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = vf[kk][j];
        } else {
          ldsm_x4(a, vw_s + kk * 16);
        }
        ldsm_x4(b, do_s + brow + kk * 16);
        mma(dp[0], a, b[0], b[1]);
        mma(dp[1], a, b[2], b[3]);
      }
      // P^T = exp(S^T scale - m) linv and dS^T = P^T (dP^T - delta)
      // scale, selected to 0 where the pair is not valid, rounded to bf16
      // into the A fragments of the k-step over these 16 queries
      uint32_t pa[4], da[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float m2[2], linv[2], dl[2];
        int query[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qc * 16 + 8 * n + 2 * t + e;
          query[e] = q0 + qi;
          m2[e] = m_s[qi] * kLog2e;
          const float lv = l_s[qi];
          linv[e] = lv == 0.f ? 0.f : 1.f / lv;
          dl[e] = d_s[qi];
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok =
                key_ok[hr] && (!causal || key_row[hr] <= query[e]);
            p[e] = ok ? exp2f(s[n][2 * hr + e] * sc - m2[e]) * linv[e]
                      : 0.f;
            ds[e] = p[e] * (dp[n][2 * hr + e] - dl[e]) * scale;
          }
          pa[2 * n + hr] = pack_bf16(p[0], p[1]);
          da[2 * n + hr] = pack_bf16(ds[0], ds[1]);
        }
      }
      const int trow = (qc * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < ON / 2; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, do_s + trow + dn * 16);
        mma(adv[2 * dn], pa, b[0], b[1]);
        mma(adv[2 * dn + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, q_s + trow + dn * 16);
        mma(adk[2 * dn], da, b[0], b[1]);
        mma(adk[2 * dn + 1], da, b[2], b[3]);
      }
    }
    stage ^= 1;
  }
  cp_wait<0>();

  // dK, dV through this warp's own K, V rows (read only by it, above),
  // then 16-byte stores
  __syncwarp();
  bf16* dk_s = k_s + warp * 16 * LDS;
  bf16* dv_s = v_s + warp * 16 * LDS;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int at = (g + 8 * hr) * LDS + 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk_s + at) =
          __floats2bfloat162_rn(adk[n][2 * hr], adk[n][2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_s + at) =
          __floats2bfloat162_rn(adv[n][2 * hr], adv[n][2 * hr + 1]);
    }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const int key = k0 + warp * 16 + r;
    if (key >= S) continue;
    const size_t at = base + (size_t)key * HD + cc;
    *reinterpret_cast<uint4*>(dk + at) =
        *reinterpret_cast<const uint4*>(dk_s + r * LDS + cc);
    *reinterpret_cast<uint4*>(dv + at) =
        *reinterpret_cast<const uint4*>(dv_s + r * LDS + cc);
  }
}

// ---- launchers -----------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const void* dout;      // backward only
  const float* m;        // backward: the saved stats and delta
  const float* l;
  const float* delta;
  void* out0;            // o (K7), dk (K8a), dq (K8b)
  void* out1;            // dv (K8a)
  float* l_out;          // K7 with stats
  float* m_out;
  int BH, H, S;
  float scale;
  int causal;
};

template <typename K>
cudaError_t configure(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
}

// which kernel: 0 = K7, 1 = K7 with stats, 2 = K8a, 3 = K8b
template <typename T, int HD>
cudaError_t launch(int which, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.S + kTile - 1) / kTile, a.BH);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  switch (which) {
    case 0:
    case 1: {
      if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = fwd_mma_smem<HD>();
        auto kern = which == 1 ? fa_fwd_mma_kernel<HD, true>
                               : fa_fwd_mma_kernel<HD, false>;
        if ((err = configure(kern, smem)) != cudaSuccess) return err;
        kern<<<grid, kMmaThreads, smem, stream>>>(
            q, k, v, a.mask, static_cast<T*>(a.out0), a.l_out, a.m_out,
            a.H, a.S, a.scale, a.causal);
      } else {
        constexpr size_t smem = fwd_smem<HD>();
        auto kern = which == 1 ? fa_fwd_kernel<T, HD, true>
                               : fa_fwd_kernel<T, HD, false>;
        if ((err = configure(kern, smem)) != cudaSuccess) return err;
        kern<<<grid, kThreads, smem, stream>>>(
            q, k, v, a.mask, static_cast<T*>(a.out0), a.l_out, a.m_out,
            a.H, a.S, a.scale, a.causal);
      }
      break;
    }
    case 2: {
      if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = dkv_mma_smem<HD>();
        auto kern = fa_bwd_dkv_mma_kernel<HD>;
        if ((err = configure(kern, smem)) != cudaSuccess) return err;
        kern<<<grid, kMmaThreads, smem, stream>>>(
            q, k, v, a.mask, dout, a.m, a.l, a.delta,
            static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.S,
            a.scale, a.causal);
      } else {
        constexpr size_t smem = dkv_smem<HD>();
        auto kern = fa_bwd_dkv_kernel<T, HD>;
        if ((err = configure(kern, smem)) != cudaSuccess) return err;
        kern<<<grid, kThreads, smem, stream>>>(
            q, k, v, a.mask, dout, a.m, a.l, a.delta,
            static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.S,
            a.scale, a.causal);
      }
      break;
    }
    case 3: {
      constexpr size_t smem = dq_smem<HD>();
      auto kern = fa_bwd_dq_kernel<T, HD>;
      if ((err = configure(kern, smem)) != cudaSuccess) return err;
      kern<<<grid, kThreads, smem, stream>>>(
          q, k, v, a.mask, dout, a.m, a.l, a.delta, static_cast<T*>(a.out0),
          a.H, a.S, a.scale, a.causal);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, int which, const Args& a, cudaStream_t s) {
  if (hd == 32) return launch<T, 32>(which, a, s);
  if (hd == 64) return launch<T, 64>(which, a, s);
  if (hd == 128) return launch<T, 128>(which, a, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and every output but the
// f32 stats)
cudaError_t dispatch(int dtype, int hd, int which, const Args& a,
                     void* stream) {
  if (a.BH <= 0 || a.H <= 0 || a.S <= 0 || a.BH % a.H != 0 ||
      a.BH > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_hd<float>(hd, which, a, s);
  if (dtype == 1) return by_hd<bf16>(hd, which, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K7. q, k, v, o (BH, S, hd); mask (B, S) bytes or null; l, m (BH, S) f32
// written when both are non-null, else K7 runs without stats.
int mmlspark_fa_fwd(int dtype, int hd, const void* q, const void* k,
                    const void* v, const void* mask, void* o, void* l,
                    void* m, int BH, int H, int S, float scale, int causal,
                    void* stream) {
  Args a{q, k, v, static_cast<const uint8_t*>(mask), nullptr, nullptr,
         nullptr, nullptr, o, nullptr, static_cast<float*>(l),
         static_cast<float*>(m), BH, H, S, scale, causal};
  const bool stats = l != nullptr && m != nullptr;
  return int(dispatch(dtype, hd, stats ? 1 : 0, a, stream));
}

// K8a. dO (BH, S, hd) in the io dtype; m, l, delta (BH, S) f32; writes
// dk, dv (BH, S, hd).
int mmlspark_fa_bwd_dkv(int dtype, int hd, const void* q, const void* k,
                        const void* v, const void* mask, const void* dout,
                        const void* m, const void* l, const void* delta,
                        void* dk, void* dv, int BH, int H, int S, float scale,
                        int causal, void* stream) {
  Args a{q, k, v, static_cast<const uint8_t*>(mask), dout,
         static_cast<const float*>(m), static_cast<const float*>(l),
         static_cast<const float*>(delta), dk, dv, nullptr, nullptr, BH, H,
         S, scale, causal};
  return int(dispatch(dtype, hd, 2, a, stream));
}

// K8b. As K8a; writes dq (BH, S, hd).
int mmlspark_fa_bwd_dq(int dtype, int hd, const void* q, const void* k,
                       const void* v, const void* mask, const void* dout,
                       const void* m, const void* l, const void* delta,
                       void* dq, int BH, int H, int S, float scale, int causal,
                       void* stream) {
  Args a{q, k, v, static_cast<const uint8_t*>(mask), dout,
         static_cast<const float*>(m), static_cast<const float*>(l),
         static_cast<const float*>(delta), dq, nullptr, nullptr, nullptr, BH,
         H, S, scale, causal};
  return int(dispatch(dtype, hd, 3, a, stream));
}

const char* mmlspark_fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
