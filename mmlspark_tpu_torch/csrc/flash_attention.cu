// Flash attention for Hopper (sm_90a): the forward and the two backward
// kernels of the zoo transformer's attention.
//
//   K7   fa_fwd_kernel. Replaces the TPU kernel `_fa_kernel`
//        (mmlspark_tpu/ops/flash_attention.py, launched by `_flash_fwd`).
//   K8a  fa_bwd_dkv_kernel. Replaces `_fa_bwd_dkv_kernel` (launched by
//        `_flash_bwd_pallas`): dK and dV.
//   K8b  fa_bwd_dq_kernel. Replaces `_fa_bwd_dq_kernel` (same launcher): dQ.
//
// What they compute. q, k, v, o are (BH, S, D) slabs of (B, H, S, D)
// tensors in float32 or bfloat16 (upcast to f32 on load); mask is an
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
// next. Here one block of 256 threads owns one 64-query tile (K7, K8b) or
// one 64-key tile (K8a) of one (b, h) and loops over the other axis inside
// the block; the running state stays in registers. The 256 threads form a
// 16 x 16 grid: thread (ty, tx) computes the scores of rows ty + 16 i and
// columns tx + 16 j (i, j < 4), and owns the output rows ty + 16 i and
// columns tx + 16 c (c < D / 16), so each row's softmax reduction is a
// shuffle across the 16 lanes of a half warp and the rescale of the
// accumulator needs no exchange. Tiles sit in shared memory as f32 rows
// padded to D + 1 so that column reads are conflict-free; K/V rows arrive
// as 16-byte vector loads. The causal mask skips whole tiles that no query
// of the tile can see (K7, K8b: key tiles whose first key is past the
// tile's last query; K8a: query tiles whose last query is before the
// tile's first key) and is applied per element inside the diagonal tiles.
// Skipped tiles contribute exactly 0, so this agrees with the reference's
// coarser block skip. The sequence is not padded: keys and queries past S
// are masked here. K8a and K8b use no atomics: each output element has
// one owner, so the gradients are the same from run to run.
//
// What bounds them on this card: operations. At BERT-base (S = 512,
// D = 64) the forward does 4 S^2 D flops per (b, h) against 8 S D bytes
// of bf16 q/k/v/o, about 128 flops per byte, and the backward about 14 S^2
// D flops; both are far above the H100's balance point only if the flops
// run on the tensor cores. These kernels do plain f32 FMA from shared
// memory (the card's f32 rate is 67 TFLOP/s against 989 TFLOP/s of bf16
// tensor-core work), loads are not pipelined across tiles, and K8a keeps
// four D-wide tiles resident (one block per SM at D = 128). Tensor cores
// (mma.sync / wgmma) with TMA-fed tiles are later work.
//
// Shared memory per block (f32, LD = D + 1): K7 3 tiles + P = 116 KB at
// D = 128; K8b 4 tiles + dS = 149 KB; K8a 4 tiles + P + dS + row stats =
// 166 KB. Above 48 KB it is dynamic memory, opted into with
// cudaFuncSetAttribute.
//
// Build: mmlspark_tpu_torch/utils/cuda_build.py runs nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC on this file
// (never --use_fast_math: 1 / l and expf stay IEEE-accurate). Interface:
// plain C, loaded with ctypes; every entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
      constexpr size_t smem = fwd_smem<HD>();
      auto kern = which == 1 ? fa_fwd_kernel<T, HD, true>
                             : fa_fwd_kernel<T, HD, false>;
      if ((err = configure(kern, smem)) != cudaSuccess) return err;
      kern<<<grid, kThreads, smem, stream>>>(
          q, k, v, a.mask, static_cast<T*>(a.out0), a.l_out, a.m_out, a.H,
          a.S, a.scale, a.causal);
      break;
    }
    case 2: {
      constexpr size_t smem = dkv_smem<HD>();
      auto kern = fa_bwd_dkv_kernel<T, HD>;
      if ((err = configure(kern, smem)) != cudaSuccess) return err;
      kern<<<grid, kThreads, smem, stream>>>(
          q, k, v, a.mask, dout, a.m, a.l, a.delta, static_cast<T*>(a.out0),
          static_cast<T*>(a.out1), a.H, a.S, a.scale, a.causal);
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
