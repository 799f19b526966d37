// Paged attention over the KV page pool for Hopper (sm_90a): one kernel
// body, instantiated six ways.
//
//   K1  fused window + scatter, pages in the query dtype. Replaces the TPU
//       kernel `_pa_fused_kernel` (mmlspark_tpu/ops/paged_attention.py,
//       launched by `_pa_fused_call`).
//   K2  fused window + scatter, int8 or fp8-e4m3 pages with one bf16 scale
//       per (page, head, position). Replaces `_pa_fused_kernel_q`
//       (launched by `_pa_fused_call_q`).
//   K3  read-only sweep, pages in the query dtype. Replaces
//       `_pa_read_kernel` (launched by `_pa_read_call`).
//   K4  read-only sweep over int8 or fp8 pages. Replaces
//       `_pa_read_kernel_q` (launched by `_pa_read_call_q`).
//   K5a window read-only, pages in the query dtype: K1's attention with
//       its scatter compiled out. Replaces `_pa_window_kernel` (launched
//       by `_pa_window_read_call`), the kernel a tensor-parallel mesh
//       runs on each rank's head shard.
//   K5b K5a over int8 or fp8 pages. Replaces `_pa_window_kernel_q`
//       (launched by `_pa_window_read_call_q`).
//
// What they compute. Fused (K1, K2): row b's W queries sit at absolute
// positions pos[b] .. pos[b]+W-1. Query j attends
//   * every cached key strictly below pos[b], read in place from the
//     (N, H, page, hd) pools through block_tables[b, key / page], and
//   * the window's own fresh keys k_new[b, :, j'] for j' <= j (as given,
//     never quantized),
// with an online softmax in f32 (masked logits -1e30, l == 0 -> 0). In
// the same launch the fresh K/V rows are written into their pages: K1
// copies them in the pool dtype, K2 quantizes each (position, head) row
// by the rules of ops/kv_quant.py `quantize_kv` and writes its codes and
// scale. A row with wlo[b] > whi[b] (inactive) writes nothing.
// Read-only (K3, K4): row b's W queries all attend its first lengths[b]
// cached keys; no window, no causal mask, no writes; lengths[b] == 0
// gives zeros. Window read-only (K5a, K5b): K1/K2's attention, bounded by
// pos[b], with no scatter: the pools are only read (the mesh path writes
// the fresh rows outside the kernel, ops/paged_attention.py
// `_pool_write_rows`), and every row computes its context, active or not.
//
// Dequant (K2, K4, K5b): a key row is f32(code) * f32(scale); the product is
// exact in f32 (an int8 or e4m3 code times a bf16 scale fits in 24 bits),
// so the kernels and their plain versions differ only in summation order.
//
// Quantizing (K2's scatter), bitwise as `quantize_kv`: amax over hd of
// the f32 row (a warp reduction), scale = bf16_rn(amax / qmax) or 1 when
// amax == 0, y = x / f32(scale) as an IEEE division (this file must never
// build with --use_fast_math), then int8: rint and clamp to +-127; fp8:
// clamp to +-448 and round to nearest even with saturation.
//
// What bounds them on this card: bytes. A decode tick (W = 1) does about
// 4 flops per byte of K/V it reads, far below the ~295 flops/byte at which
// the H100's compute would be the limit, so the least time is the live
// pages and their scales (each read once) over the 3.35 TB/s of HBM.
// Quantized pages halve those bytes: at hd 64 a key row is 64 bytes of
// codes plus a 2-byte scale against 128 bytes of bf16.
//
// What the design does about that. The TPU kernels swept a sequential
// (b, page) grid with scratch carried across grid steps; here one block
// owns (query tile, head, row) and loops only over the row's LIVE keys
// (ceil(bound / 32) tiles of 32 keys, never the block table's full
// width). The block's warps split the key tiles between them so that a
// W = 1 tick still keeps four warps per (row, head) reading, each warp
// keeps its own running (m, l, acc) in registers, and the partial softmax
// states merge once through shared memory at the end. Each lane looks its
// key's page up once (and, quantized, loads that key's K and V scales
// beside it); then the tile's K and V rows arrive as 16-byte vector loads,
// all issued before the first is used: one memory round trip per tile,
// not one per element. Keys at or past the bound are never loaded (their
// tile slots are zero-filled and their scales never read), so garbage
// codes or scales in unwritten page slots cannot reach p * v, and the
// reads never touch the slots this launch writes. The math is plain f32
// FMA loops; tensor cores, TMA, loads pipelined across tiles and CUDA
// graphs are later work.
//
// Page-size rule: none. Tiles are 32 keys wide in the logical key space
// and each key's page is looked up on its own, so any page size >= 1
// works (the TPU sublane rounding does not apply here).
//
// Build: mmlspark_tpu_torch/utils/cuda_build.py runs nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC on this file.
// Interface: plain C, loaded with ctypes; every entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;     // warps per block
constexpr int kTile = 32;     // keys per tile (one per lane)
constexpr float kNeg = -1e30f;

// the kernel's modes: what bounds the cached keys and what is written
enum Mode : int {
  kFused = 0,    // K1, K2: keys < pos, window keys causal, scatter
  kRead = 1,     // K3, K4: keys < lengths, no window, no writes
  kWindow = 2,   // K5a, K5b: keys < pos, window keys causal, no writes
};

using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(fp8 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, bf16* dst) {
  *dst = __float2bfloat16(v);
}

// the quantized store types: clip bound and the code of y = x / scale
template <typename S>
struct Quant;
template <>
struct Quant<int8_t> {
  static constexpr float qmax = 127.f;
  __device__ static int8_t code(float y) {
    return static_cast<int8_t>(fminf(fmaxf(rintf(y), -qmax), qmax));
  }
};
template <>
struct Quant<fp8> {
  static constexpr float qmax = 448.f;
  __device__ static fp8 code(float y) {
    fp8 r;
    r.__x = __nv_cvt_float_to_fp8(fminf(fmaxf(y, -qmax), qmax),
                                  __NV_SATFINITE, __NV_E4M3);
    return r;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp loads a 32-key tile of K (or V) rows into shared memory as
// f32. Lane t owns key t and passes its row offset (`row`, in elements;
// -1 = past the limit, zero-filled) and, when SCALED, its key's scale
// (0 past the limit, so a zero-filled slot stays 0). Rows are read as
// 16-byte vectors (HD * sizeof(S) is a multiple of 16; the wrapper checks
// the base pointers' alignment), and every load of the tile is issued
// before any is used, so a tile costs one memory round trip, not one per
// element.
template <typename S, int HD, bool SCALED>
__device__ __forceinline__ void load_tile(const S* __restrict__ src,
                                          long long row, float sc, int lane,
                                          float* __restrict__ dst) {
  constexpr int EPC = 16 / sizeof(S);     // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;           // chunks per key row
  constexpr int CPL = kTile * CPR / 32;   // chunks per lane
  constexpr int LD = HD + 1;
  uint4 buf[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    const long long r = __shfl_sync(0xffffffffu, row, c / CPR);
    buf[i] = r >= 0 ? reinterpret_cast<const uint4*>(src + r)[c % CPR]
                    : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    const S* v = reinterpret_cast<const S*>(&buf[i]);
    float* d = dst + (c / CPR) * LD + (c % CPR) * EPC;
    if constexpr (SCALED) {
      const float s = __shfl_sync(0xffffffffu, sc, c / CPR);
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = to_f32(v[e]) * s;
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = to_f32(v[e]);
    }
  }
}

// Quantize one (position, head) row of HD values with one warp and write
// its codes and its scale (see the header for the rules).
template <typename T, typename S, int HD>
__device__ __forceinline__ void quant_row(const T* __restrict__ x,
                                          S* __restrict__ dst,
                                          bf16* __restrict__ sdst,
                                          int lane) {
  constexpr int DPL = HD / 32;
  float v[DPL];
  float amax = 0.f;
#pragma unroll
  for (int r = 0; r < DPL; ++r) {
    v[r] = to_f32(x[lane + 32 * r]);
    amax = fmaxf(amax, fabsf(v[r]));
  }
  amax = warp_max(amax);
  const bf16 s16 = __float2bfloat16_rn(amax > 0.f ? amax / Quant<S>::qmax
                                                  : 1.f);
  const float s = __bfloat162float(s16);
#pragma unroll
  for (int r = 0; r < DPL; ++r) dst[lane + 32 * r] = Quant<S>::code(v[r] / s);
  if (lane == 0) *sdst = s16;
}

// The fused kernels' in-launch scatter of one query tile's fresh rows
// (rows of an inactive row, wlo > whi, write nothing).
template <typename T, typename S, int HD, int QT>
__device__ __forceinline__ void fused_scatter(
    const T* __restrict__ kn, const T* __restrict__ vn, S* __restrict__ kpool,
    S* __restrict__ vpool, bf16* __restrict__ kscale,
    bf16* __restrict__ vscale, const int32_t* __restrict__ bt, int pos,
    int wlo, int whi, size_t row_off, int q0, int h, int H, int W, int P,
    int page, int warp, int lane, int tid) {
  constexpr bool kQuant = !std::is_same<S, T>::value;
  if (wlo > whi) return;   // inactive row: writes nothing
  if constexpr (kQuant) {
    // one warp per fresh row: quantize K and V, write codes and scales
    for (int i = warp; i < QT; i += kWarps) {
      const int j = q0 + i;
      if (j >= W) break;
      const int t = pos + j;
      const int lp = t / page;
      if (lp < wlo || lp > whi || lp >= P) continue;
      const long long slot = ((long long)bt[lp] * H + h) * page + t % page;
      const size_t src = (row_off + j) * HD;
      quant_row<T, S, HD>(kn + src, kpool + slot * HD, kscale + slot, lane);
      quant_row<T, S, HD>(vn + src, vpool + slot * HD, vscale + slot, lane);
    }
  } else {
    // copies in the pool dtype (no f32 round trip, so the bytes equal the
    // gather path's writeback)
    for (int e = tid; e < QT * HD; e += blockDim.x) {
      int i = e / HD, d = e % HD;
      int j = q0 + i;
      if (j >= W) continue;
      int t = pos + j;
      int lp = t / page;
      if (lp < wlo || lp > whi || lp >= P) continue;
      size_t dst = ((size_t(bt[lp]) * H + h) * page + t % page) * HD + d;
      size_t src = (row_off + j) * HD + d;
      kpool[dst] = kn[src];
      vpool[dst] = vn[src];
    }
  }
}

// Shared memory, dynamic:
//   q_s   [QT][HD]                 queries of this tile, f32
//   kv_s  [kWarps][2][kTile][HD+1] each warp's K and V tile, f32
//   m_s   [kWarps][QT], l_s [kWarps][QT], a_s [kWarps][QT][HD]
template <int HD, int QT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(QT) * HD + size_t(kWarps) * 2 * kTile * (HD + 1) +
          size_t(kWarps) * QT * (HD + 2));
}

struct Args {
  const void* q;
  const void* kn;         // fused, window: the window's fresh K / V rows
  const void* vn;
  void* kp;               // (N, H, page, hd) pools, store type S
  void* vp;
  void* ks;               // (N, H, page) bf16 scales, quantized only
  void* vs;
  const int32_t* bt;      // (B, P)
  const int32_t* bound;   // (B,): pos (fused, window) or lengths (read)
  const int32_t* wlo;     // (B,), fused only
  const int32_t* whi;
  void* out;
  int B, H, W, P, page;
  float scale;
};

// T: query / k_new / v_new / output type (float or bf16). S: page store
// type: T itself (K1, K3, K5a), int8_t or fp8 (K2, K4, K5b). MODE: see
// `Mode`. QT: queries per block.
template <typename T, typename S, int MODE, int HD, int QT>
__global__ void __launch_bounds__(kWarps * 32)
pa_kernel(const T* __restrict__ q, const T* __restrict__ kn,
          const T* __restrict__ vn, S* __restrict__ kpool,
          S* __restrict__ vpool, bf16* __restrict__ kscale,
          bf16* __restrict__ vscale,
          const int32_t* __restrict__ block_tables,
          const int32_t* __restrict__ bound_v,
          const int32_t* __restrict__ wlo_v,
          const int32_t* __restrict__ whi_v, T* __restrict__ out, int H,
          int W, int P, int page, float scale) {
  constexpr bool kQuant = !std::is_same<S, T>::value;
  constexpr bool READ = MODE == kRead;
  constexpr int DPL = HD / 32;   // output dims owned by each lane
  constexpr int LD = HD + 1;     // padded row: conflict-free column reads
  extern __shared__ float smem[];
  float* q_s = smem;
  float* kv_s = q_s + QT * HD;
  float* m_s = kv_s + kWarps * 2 * kTile * LD;
  float* l_s = m_s + kWarps * QT;
  float* a_s = l_s + kWarps * QT;

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // cached keys [0, bound) are visible: pos (fused, window) or lengths
  // (read-only, held inside the block table's width)
  const int bound = READ ? min(bound_v[b], P * page) : bound_v[b];
  const int32_t* bt = block_tables + size_t(b) * P;
  const size_t row_off = (size_t(b) * H + h) * W;   // (b, h, 0, 0) / HD

  // queries of this tile, f32 (rows past W are zero: never written out)
  for (int e = tid; e < QT * HD; e += blockDim.x) {
    int i = e / HD, d = e % HD;
    int j = q0 + i;
    q_s[e] = j < W ? to_f32(q[(row_off + j) * HD + d]) : 0.f;
  }
  __syncthreads();

  float m[QT], l[QT], acc[QT][DPL];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int r = 0; r < DPL; ++r) acc[i][r] = 0.f;
  }

  // the live key tiles: cached keys [0, bound), then (fused, window) the
  // window keys this query tile can see, [0, min(q0 + QT, W))
  const int n_page_tiles = (bound + kTile - 1) / kTile;
  const int w_end = READ ? 0 : min(q0 + QT, W);
  const int n_win_tiles = (w_end + kTile - 1) / kTile;
  float* k_t = kv_s + warp * 2 * kTile * LD;
  float* v_t = k_t + kTile * LD;

  for (int tile = warp; tile < n_page_tiles + n_win_tiles; tile += kWarps) {
    const bool win = tile >= n_page_tiles;
    const int base = (win ? tile - n_page_tiles : tile) * kTile;
    const int limit = win ? w_end : bound;
    const int key = base + lane;
    // each lane looks up its own key's row once (one block-table read)
    // and, quantized, that key's K and V scales beside it
    long long row = -1;   // element offset of this lane's key row
    float sk = 0.f, sv = 0.f;
    if (key < limit) {
      if (win) {
        row = (long long)(row_off + key) * HD;
      } else {
        const long long slot =
            ((long long)bt[key / page] * H + h) * page + key % page;
        row = slot * HD;
        if constexpr (kQuant) {
          sk = __bfloat162float(kscale[slot]);
          sv = __bfloat162float(vscale[slot]);
        }
      }
    }
    if constexpr (kQuant) {
      // warp-uniform: a tile is either all window keys or all page keys
      if (win) {
        load_tile<T, HD, false>(kn, row, 0.f, lane, k_t);
        load_tile<T, HD, false>(vn, row, 0.f, lane, v_t);
      } else {
        load_tile<S, HD, true>(kpool, row, sk, lane, k_t);
        load_tile<S, HD, true>(vpool, row, sv, lane, v_t);
      }
    } else {
      load_tile<T, HD, false>(win ? kn : kpool, row, 0.f, lane, k_t);
      load_tile<T, HD, false>(win ? vn : vpool, row, 0.f, lane, v_t);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float* qi = q_s + i * HD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qi[d], k_t[lane * LD + d], s);
      s *= scale;
      // cached keys are all visible (key < bound); a window key j is
      // visible to query q0 + i when j <= q0 + i (and j < W)
      const bool valid = win ? (key < W && key <= q0 + i) : (key < bound);
      s = valid ? s : kNeg;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + warp_sum(p);
#pragma unroll
      for (int r = 0; r < DPL; ++r) acc[i][r] *= corr;
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int r = 0; r < DPL; ++r)
          acc[i][r] = fmaf(pt, v_t[t * LD + lane + 32 * r], acc[i][r]);
      }
      m[i] = m_new;
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    if (lane == 0) {
      m_s[warp * QT + i] = m[i];
      l_s[warp * QT + i] = l[i];
    }
#pragma unroll
    for (int r = 0; r < DPL; ++r)
      a_s[(warp * QT + i) * HD + lane + 32 * r] = acc[i][r];
  }
  __syncthreads();
  for (int e = tid; e < QT * HD; e += blockDim.x) {
    int i = e / HD, d = e % HD;
    int j = q0 + i;
    if (j >= W) continue;
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * QT + i]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      float c = expf(m_s[w * QT + i] - mm);
      ll += l_s[w * QT + i] * c;
      aa += a_s[(w * QT + i) * HD + d] * c;
    }
    from_f32(aa / (ll == 0.f ? 1.f : ll), &out[(row_off + j) * HD + d]);
  }

  if constexpr (MODE == kFused) {
    // scatter this tile's fresh rows into their pages. Writes land at
    // positions >= pos; every read above was < pos.
    fused_scatter<T, S, HD, QT>(kn, vn, kpool, vpool, kscale, vscale, bt,
                                bound, wlo_v[b], whi_v[b], row_off, q0, h,
                                H, W, P, page, warp, lane, tid);
  }
}

template <typename T, typename S, int MODE, int HD, int QT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, QT>();
  auto kern = pa_kernel<T, S, MODE, HD, QT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.W + QT - 1) / QT, a.H, a.B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn),
      static_cast<const T*>(a.vn), static_cast<S*>(a.kp),
      static_cast<S*>(a.vp), static_cast<bf16*>(a.ks),
      static_cast<bf16*>(a.vs), a.bt, a.bound, a.wlo, a.whi,
      static_cast<T*>(a.out), a.H, a.W, a.P, a.page, a.scale);
  return cudaGetLastError();
}

template <typename T, typename S, int MODE>
cudaError_t dispatch(int hd, const Args& a, cudaStream_t s) {
  if (a.B <= 0 || a.H <= 0 || a.W <= 0 || a.P <= 0 || a.page <= 0)
    return cudaErrorInvalidValue;
  // only the head dim of the models served so far; another one is
  // instantiated with the slice that brings a model needing it
  if (hd != 64) return cudaErrorInvalidValue;
  if (a.W == 1) return launch<T, S, MODE, 64, 1>(a, s);
  return launch<T, S, MODE, 64, 8>(a, s);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new and out)
template <typename S, int MODE>
cudaError_t by_dtype(int dtype, int hd, const Args& a, cudaStream_t s) {
  if (dtype == 0) return dispatch<float, S, MODE>(hd, a, s);
  if (dtype == 1) return dispatch<bf16, S, MODE>(hd, a, s);
  return cudaErrorInvalidValue;
}

// pools in the query dtype (K1, K3, K5a)
template <int MODE>
cudaError_t plain_pools(int dtype, int hd, const Args& a, cudaStream_t s) {
  if (dtype == 0) return dispatch<float, float, MODE>(hd, a, s);
  if (dtype == 1) return dispatch<bf16, bf16, MODE>(hd, a, s);
  return cudaErrorInvalidValue;
}

// store: 0 = int8, 1 = float8_e4m3fn (K2, K4, K5b)
template <int MODE>
cudaError_t quant_pools(int dtype, int store, int hd, const Args& a,
                        cudaStream_t s) {
  if (store == 0) return by_dtype<int8_t, MODE>(dtype, hd, a, s);
  if (store == 1) return by_dtype<fp8, MODE>(dtype, hd, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1. dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, pools and out
// share it). All int32 arrays are (B,) except block_tables (B, P).
// Returns the launch's cudaError_t (0 on success).
int mmlspark_pa_window_fused(int dtype, int hd, const void* q,
                             const void* k_new, const void* v_new,
                             void* k_pages, void* v_pages,
                             const int32_t* block_tables,
                             const int32_t* pos, const int32_t* wlo,
                             const int32_t* whi, void* out, int B, int H,
                             int W, int P, int page, float scale,
                             void* stream) {
  Args a{q, k_new, v_new, k_pages, v_pages, nullptr, nullptr, block_tables,
         pos, wlo, whi, out, B, H, W, P, page, scale};
  return int(plain_pools<kFused>(dtype, hd, a,
                                static_cast<cudaStream_t>(stream)));
}

// K2. As K1, with int8 (store 0) or fp8-e4m3 (store 1) pools and their
// (N, H, page) bf16 scale pools, all updated in place.
int mmlspark_pa_window_fused_q(int dtype, int store, int hd, const void* q,
                               const void* k_new, const void* v_new,
                               void* k_pages, void* v_pages, void* k_scale,
                               void* v_scale, const int32_t* block_tables,
                               const int32_t* pos, const int32_t* wlo,
                               const int32_t* whi, void* out, int B, int H,
                               int W, int P, int page, float scale,
                               void* stream) {
  Args a{q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, block_tables,
         pos, wlo, whi, out, B, H, W, P, page, scale};
  return int(quant_pools<kFused>(dtype, store, hd, a,
                                static_cast<cudaStream_t>(stream)));
}

// K3. Read-only: q (B, H, W, hd) attends the first lengths[b] keys; pools
// in q's dtype; nothing is written but out.
int mmlspark_pa_read(int dtype, int hd, const void* q, const void* k_pages,
                     const void* v_pages, const int32_t* block_tables,
                     const int32_t* lengths, void* out, int B, int H, int W,
                     int P, int page, float scale, void* stream) {
  Args a{q, nullptr, nullptr, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), nullptr, nullptr, block_tables,
         lengths, nullptr, nullptr, out, B, H, W, P, page, scale};
  return int(plain_pools<kRead>(dtype, hd, a,
                               static_cast<cudaStream_t>(stream)));
}

// K4. K3 over int8 (store 0) or fp8-e4m3 (store 1) pools with their
// (N, H, page) bf16 scale pools.
int mmlspark_pa_read_q(int dtype, int store, int hd, const void* q,
                       const void* k_pages, const void* v_pages,
                       const void* k_scale, const void* v_scale,
                       const int32_t* block_tables, const int32_t* lengths,
                       void* out, int B, int H, int W, int P, int page,
                       float scale, void* stream) {
  Args a{q, nullptr, nullptr, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), const_cast<void*>(k_scale),
         const_cast<void*>(v_scale), block_tables, lengths, nullptr,
         nullptr, out, B, H, W, P, page, scale};
  return int(quant_pools<kRead>(dtype, store, hd, a,
                               static_cast<cudaStream_t>(stream)));
}

// K5a. Window read-only: K1's attention (keys < pos[b] from the pools,
// the window's own k_new / v_new rows under the in-window causal mask)
// with nothing written but out; pools in q's dtype.
int mmlspark_pa_window_read(int dtype, int hd, const void* q,
                            const void* k_new, const void* v_new,
                            const void* k_pages, const void* v_pages,
                            const int32_t* block_tables, const int32_t* pos,
                            void* out, int B, int H, int W, int P, int page,
                            float scale, void* stream) {
  Args a{q, k_new, v_new, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), nullptr, nullptr, block_tables, pos,
         nullptr, nullptr, out, B, H, W, P, page, scale};
  return int(plain_pools<kWindow>(dtype, hd, a,
                                  static_cast<cudaStream_t>(stream)));
}

// K5b. K5a over int8 (store 0) or fp8-e4m3 (store 1) pools with their
// (N, H, page) bf16 scale pools, all only read.
int mmlspark_pa_window_read_q(int dtype, int store, int hd, const void* q,
                              const void* k_new, const void* v_new,
                              const void* k_pages, const void* v_pages,
                              const void* k_scale, const void* v_scale,
                              const int32_t* block_tables,
                              const int32_t* pos, void* out, int B, int H,
                              int W, int P, int page, float scale,
                              void* stream) {
  Args a{q, k_new, v_new, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), const_cast<void*>(k_scale),
         const_cast<void*>(v_scale), block_tables, pos, nullptr, nullptr,
         out, B, H, W, P, page, scale};
  return int(quant_pools<kWindow>(dtype, store, hd, a,
                                  static_cast<cudaStream_t>(stream)));
}

const char* mmlspark_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
