// Paged attention over the KV page pool for Hopper (sm_90a): six kernels
// from three bodies, an f32 FMA body for f32 windows (pa_kernel), a bf16
// tensor-core body for windows (pa_mma_kernel) and a body split over the
// keys for the decode tick and the read-only sweep (pa_split_kernel).
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
// Which body each instantiation takes (`dispatch`; the C entries report
// it in their `int* body`: 1 tensor-core, 2 split, left 0 for FMA):
//   * pa_mma_kernel: K1, K2 (kFused) and K5a, K5b (kWindow) with bf16
//     queries and W > 1, the chunked-prefill chunks and prefix-suffix
//     windows of bf16 serving, on one device or on a mesh's head shard;
//   * pa_split_kernel: K1, K2, K5a and K5b at W = 1, f32 or bf16 queries:
//     the decode tick, single-device (kFused, the page scatter in the
//     fresh key's block) or on a mesh's head shard (kWindow); and the
//     read-only sweep K3/K4 (kRead), one query a block at W = 1 and
//     groups of kReadGroup = 4 at W > 1 (`read_group`);
//   * pa_kernel: f32 windows (W > 1) of K1, K2, K5a and K5b.
//
// What bounds them on this card. A decode tick (W = 1) does about 4 flops
// per byte of K/V it reads, far below the ~295 flops/byte at which the
// H100's compute would be the limit: bytes bound it, the live pages and
// their scales (each read once) over the 3.35 TB/s of HBM. Quantized pages
// halve those bytes: at hd 64 a key row is 64 bytes of codes plus a 2-byte
// scale against 128 bytes of bf16. A window of W queries does W times the
// flops on the same cached bytes; an extend chunk (W = 256 at pos 384)
// does about 500 MFLOP on 3.5 MB in and out (~140 flops a byte), still
// bytes on the tensor cores' roofline, but 7.5 us of flops at f32 FMA's
// 67 TFLOP/s against 1 us of bytes: at W > 1 the scalar math, not the
// bytes, bounds an FMA body, which is why the window has the tensor-core
// body.
//
// pa_kernel, the f32 FMA body. The TPU kernels swept a sequential (b,
// page) grid with scratch carried across grid steps; here one block owns
// (query tile, head, row) and loops only over the row's LIVE keys
// (ceil(bound / 32) tiles of 32 keys, never the block table's full
// width). The block's warps split the key tiles between them so that a
// short window still keeps four warps per (row, head) reading, each warp
// keeps its own running (m, l, acc) in registers, and the partial softmax
// states merge once through shared memory at the end. Each lane looks its
// key's page up once (and, quantized, loads that key's K and V scales
// beside it); then the tile's K and V rows arrive as 16-byte vector loads,
// all issued before the first is used: one memory round trip per tile,
// not one per element. Tiles sit in shared memory as f32 (dequantized on
// load), and each query's score is a 64-long fmaf chain per lane.
//
// pa_mma_kernel, the bf16 tensor-core body. One block owns 16 queries
// (one m16 tile) of one (row, head), so an extend chunk of W = 256 at B =
// 1, H = 12 is a 192-block grid. Its 4 warps split the 32-key tiles as
// above and all hold the block's Q as A fragments in registers. Per tile:
// S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32 accumulate),
// the online softmax on the accumulator fragments (m in log2 units), P
// rounded to bf16 and repacked from the score fragments into the A
// fragment of the next product, never through shared memory; l sums the
// unrounded f32 p. Each warp double-buffers its own tiles with cp.async
// (each 16-byte chunk of a key row takes its address from that key's own
// block-table entry, so there is still no page-size rule) and reads the
// block-table entries two tiles ahead, so the next tile's copies are in
// flight while this one computes. bf16 tiles are padded by 8 elements a
// row for conflict-free ldmatrix. Window tiles skip whole past the
// block's last query; the diagonal tile masks element by element. The
// warps' (m, l, acc) merge through shared memory; then the block runs the
// same fused_scatter as the FMA body, so pages and scales are bitwise the
// same (kFused only: under kWindow, K5a/K5b, the scatter is compiled out
// and wlo/whi are never read).
//
// K2 in the tensor-core body: page tiles arrive as codes (64 bytes a row
// at hd 64, half a bf16 tile, rows padded to hd + 16 bytes) and are
// widened to bf16 as the B fragments are built, which is exact (|int8| <=
// 127 and every e4m3 value fit bf16's 8-bit significand). The scales
// cannot ride inside a bf16 operand without a rounding, so they go where
// they cost none: the K scale multiplies each score column after the
// product, in f32, s = scale * sk * (q . code_k), equal to the FMA body's
// q . (f32(code) * f32(sk)) up to the order of the sums; the V scale is
// folded into P, P' = bf16(p * sv), the only rounding it takes, with l
// still summed from the unrounded p. A scale is loaded only for a live
// key; a dead key keeps sk = sv = 0 (an unwritten slot's scale may be NaN,
// and NaN * 0 is NaN). Window tiles (fresh rows, never quantized) are
// plain bf16 tiles; a tile is either all window keys or all page keys.
//
// Error bound of the tensor-core body: q, k_new, v_new and bf16 pages are
// bf16 already and codes widen exactly, so its one extra rounding is of
// each p (K1) or p * sv (K2) to bf16 before P V: relative 2^-8 a term, so
// the context lies within 2^-8 * R (plus the output's own bf16 rounding)
// of the plain f32 result, where R is the same attention taken over |V|
// (ops/paged_attention.py `paged_rounding_scale`).
//
// Both bodies never load a key at or past its bound (its tile slots are
// zero-filled, by cp.async src-size 0 in the tensor-core body, and its
// scales never read), so garbage codes or scales in unwritten page slots
// cannot reach p * v, and the reads never touch the slots this launch
// writes. TMA and wgmma are later work.
//
// pa_split_kernel, the decode body (W = 1) of K1, K2, K5a and K5b and the
// body of the read-only sweep K3/K4. In the FMA body one block owns a
// (query tile, row, head) and its 4 warps split the row's 32-key tiles, so
// the longest row sets the time: at 1023 keys each warp walks 8 tiles,
// each a chain of a block-table read, the dependent row loads and the
// math, nothing fetched ahead, and at H = 6, B = 16 the 96 blocks leave a
// third of the 132 SMs idle (and a sweep of W = 4 leaves half of its
// 8-query tile empty). The split body cuts each (row, head)'s keys into
// chunks of kChunk = 256 keys, one block each, so no warp walks more than
// two tiles and a 1023-key row is 4 blocks side by side; the sweep's W
// queries go in groups of QG = 4, a block each. The grid, (ceil(P * page /
// kChunk) * ceil(W / QG), H, B), comes from the block table's width, so
// the host never reads pos or lengths; a block whose chunk starts at or
// past the bound exits at once, and a decode row's fresh key rides in its
// last live chunk.
// Per warp: lane t owns key t of a tile (its QG scores 64-long fmaf
// chains over the staged row, the queries broadcast from shared memory)
// and output dims 2 t, 2 t + 1 of each query; tiles are staged as stored
// (f32, bf16 or codes, rows padded by 16 bytes), double-buffered with
// cp.async, the block-table entries of the next tile read while this
// one's copies fly and a quantized key's scales loaded with its copies.
// Codes are dequantized as f32(code) * scale (exact) at each use, so the
// math is the FMA body's, in f32. The warps' (m, l, acc) merge in shared
// memory; a row with one live chunk writes its context there and then.
// Otherwise each block writes its partial (m, l, acc) per query to the
// caller's f32 workspace, and the last block of the (row, head, group) to
// arrive (a __threadfence, then an atomicAdd on its counter) merges the
// partials in chunk order, writes the context and resets the counter to
// 0: one launch a call, no memset. The merge reorders the sums only, so
// the context stays within the plain version's bound. The workspace and
// counters are the wrapper's, cached per device (ops/paged_attention.py
// `_split_workspace`), which assumes one stream per device. K3/K4 (kRead)
// read keys below min(lengths, P * page) and write nothing but out;
// lengths == 0 leaves one live chunk with no tile, whose context is
// exactly 0. K1/K2 (kFused) add the page scatter: the block of the row's
// last live chunk, the one that reads the fresh key, writes the fresh row
// into its page with the other bodies' fused_scatter (so pages and scales
// are bitwise theirs) before it can return; no other block writes, and no
// block races it: every block reads keys below pos, and the write lands
// at pos. An inactive row (wlo > whi) writes nothing and
// still computes its context.
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

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;   // the tensor-core tile helpers

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
  int* body;              // set to 1 when the tensor-core body launched,
                          // 2 the split body (the caller zeroes it)
  float* work;            // the split body's partials and its
  int* counters;          // per-(row, head, group) arrival counters
};

// T: query / k_new / v_new / output type (float or bf16). S: page store
// type: T itself (K1, K5a), int8_t or fp8 (K2, K5b). MODE: kFused or
// kWindow (see `Mode`). QT: queries per block.
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
  static_assert(MODE != kRead, "the read-only sweep runs split");
  constexpr bool kQuant = !std::is_same<S, T>::value;
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
  // cached keys [0, bound) are visible: pos
  const int bound = bound_v[b];
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

  // the live key tiles: cached keys [0, bound), then the window keys this
  // query tile can see, [0, min(q0 + QT, W))
  const int n_page_tiles = (bound + kTile - 1) / kTile;
  const int w_end = min(q0 + QT, W);
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

// ---- the bf16 window body on the tensor cores (K1, K2, K5a, K5b, W > 1) ---
//
// The tile helpers (cp.async, ldmatrix, mma.sync, pack_bf16) are K7's,
// from mma_sm90.cuh.

constexpr int kMq = 16;   // queries per block: one m16 tile
constexpr int kMk = 32;   // keys per tile

// Two codes (the low byte is the lower k) widened to one register of two
// bf16. Exact: |int8| <= 127 and every e4m3 value fit bf16's 8-bit
// significand and its exponent range.
template <typename S>
__device__ __forceinline__ uint32_t widen2(uint32_t v);
template <>
__device__ __forceinline__ uint32_t widen2<int8_t>(uint32_t v) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(v & 0xffu)),
                   static_cast<float>(static_cast<int8_t>((v >> 8) & 0xffu)));
}
template <>
__device__ __forceinline__ uint32_t widen2<fp8>(uint32_t v) {
  fp8 lo, hi;
  lo.__x = static_cast<__nv_fp8_storage_t>(v & 0xffu);
  hi.__x = static_cast<__nv_fp8_storage_t>((v >> 8) & 0xffu);
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// Shared rows: a bf16 tile row is mma_ld = HD + 8 elements and a code
// tile row HD + 16 bytes, so that the 8 rows an ldmatrix phase reads, and
// the rows a code fragment gathers, fall on distinct banks.
template <int HD>
__host__ __device__ constexpr int code_ld() {
  return HD + 16;
}
// one stage of one warp: its K and V tiles, bf16 or codes
template <int HD>
__host__ __device__ constexpr size_t mma_stage_bytes() {
  return 2 * size_t(kMk) * mma_ld<HD>() * sizeof(bf16);
}
// Shared memory, dynamic: the block's Q tile [kMq][HD + 8] bf16, then 2
// stages per warp. After its last tile a warp's stages hold its partial
// softmax state for the merge: m [kMq], l [kMq], acc [kMq][HD + 8] f32.
template <int HD>
constexpr size_t mma_smem() {
  return size_t(kMq) * mma_ld<HD>() * sizeof(bf16) +
         size_t(kWarps) * 2 * mma_stage_bytes<HD>();
}
static_assert(2 * kMk * code_ld<64>() <= mma_stage_bytes<64>(),
              "a code stage fits a bf16 stage");
static_assert(sizeof(float) * (2 * kMq + kMq * mma_ld<64>()) <=
                  2 * mma_stage_bytes<64>(),
              "the merge state fits a warp's stages");

// K1 and K5a (S = bf16), K2 and K5b (S = int8 / fp8) at W > 1 with bf16
// queries; MODE kFused (K1, K2) scatters the fresh rows at the end,
// kWindow (K5a, K5b) only reads. Block: kMq queries of one (row b, head
// h). Its 4 warps split the key tiles (32 keys each: the cached keys < pos
// through the block table, then the window keys the block's queries can
// see) and each keeps the block's Q as A fragments in registers and its
// own running (m, l, acc) on the accumulator fragments; the partial
// states merge once through shared memory. Per tile: S = Q K^T on mma.sync, the online softmax in f32 (m
// in log2 units), then O += P V with P repacked in registers. Each warp
// double-buffers its own tiles with cp.async and reads the block-table
// entries two tiles ahead. Quantized page tiles arrive as codes and are
// widened to bf16 as the B fragments are built; the K scale multiplies
// the score column after the product and the V scale is folded into P.
template <typename S, int HD, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
pa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
              const bf16* __restrict__ vn, S* __restrict__ kpool,
              S* __restrict__ vpool, bf16* __restrict__ kscale,
              bf16* __restrict__ vscale,
              const int32_t* __restrict__ block_tables,
              const int32_t* __restrict__ pos_v,
              const int32_t* __restrict__ wlo_v,
              const int32_t* __restrict__ whi_v, bf16* __restrict__ out,
              int H, int W, int P, int page, float scale) {
  constexpr bool kQuant = !std::is_same<S, bf16>::value;
  constexpr int LDS = mma_ld<HD>();
  constexpr int LDC = code_ld<HD>();
  constexpr int KS = HD / 16;   // k16 steps over the head dim
  constexpr int ON = HD / 8;    // n8 tiles of an output row
  constexpr int SN = kMk / 8;   // n8 tiles of a score row
  constexpr int CPR = HD / 8;   // 16-byte chunks of a bf16 row
  constexpr int CPC = HD / 16;  // 16-byte chunks of a code row
  constexpr int LDA = HD + 8;   // row of the merge's acc
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stages = smem_raw + kMq * LDS * sizeof(bf16);

  const int q0 = blockIdx.x * kMq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pos = pos_v[b];
  const int32_t* bt = block_tables + size_t(b) * P;
  const size_t row_off = (size_t(b) * H + h) * W;   // (b, h, 0, 0) / HD
  const float sc = scale * kLog2e;
  unsigned char* wbuf = stages + warp * 2 * mma_stage_bytes<HD>();

  // the key tiles: cached keys [0, pos), then the window keys this
  // block's queries can see, [0, w_end)
  const int n_page = (pos + kMk - 1) / kMk;
  const int w_end = min(q0 + kMq, W);
  const int n_tiles = n_page + (w_end + kMk - 1) / kMk;

  // this lane's key in tile ti: its block-table entry (page tiles; read
  // ahead) and its row (pool slot, or window row of k_new / v_new; -1 past
  // the tile's limit, never loaded)
  auto bt_entry = [&](int ti) -> int {
    const int key = ti * kMk + lane;
    return ti < n_page && key < pos ? bt[key / page] : 0;
  };
  auto key_row = [&](int ti, int btv) -> long long {
    if (ti >= n_page) {
      const int key = (ti - n_page) * kMk + lane;
      return key < w_end ? (long long)(row_off + key) : -1;
    }
    const int key = ti * kMk + lane;
    return key < pos ? ((long long)btv * H + h) * page + key % page : -1;
  };
  // start tile ti's K and V rows into a stage; window tiles and K1's
  // pages are bf16 tiles, K2's pages code tiles (warp-uniform)
  auto start_copies = [&](int ti, long long row, unsigned char* buf) {
    if (!kQuant || ti >= n_page) {
      const bool win = ti >= n_page;
      const bf16* ks = win ? kn : reinterpret_cast<const bf16*>(kpool);
      const bf16* vs = win ? vn : reinterpret_cast<const bf16*>(vpool);
      bf16* kd = reinterpret_cast<bf16*>(buf);
      bf16* vd = kd + kMk * LDS;
#pragma unroll
      for (int i = 0; i < kMk * CPR / 32; ++i) {
        const int c = lane + 32 * i;
        const int r = c / CPR, cc = (c % CPR) * 8;
        const long long src = __shfl_sync(0xffffffffu, row, r);
        const bool ok = src >= 0;
        cp_async16(kd + r * LDS + cc, ok ? ks + src * HD + cc : ks, ok);
        cp_async16(vd + r * LDS + cc, ok ? vs + src * HD + cc : vs, ok);
      }
    } else {
      const unsigned char* ks = reinterpret_cast<const unsigned char*>(kpool);
      const unsigned char* vs = reinterpret_cast<const unsigned char*>(vpool);
      unsigned char* kd = buf;
      unsigned char* vd = buf + kMk * LDC;
#pragma unroll
      for (int i = 0; i < kMk * CPC / 32; ++i) {
        const int c = lane + 32 * i;
        const int r = c / CPC, cc = (c % CPC) * 16;
        const long long src = __shfl_sync(0xffffffffu, row, r);
        const bool ok = src >= 0;
        cp_async16(kd + r * LDC + cc, ok ? ks + src * HD + cc : ks, ok);
        cp_async16(vd + r * LDC + cc, ok ? vs + src * HD + cc : vs, ok);
      }
    }
  };
  // this lane's key's K and V scales: loaded for a live page key only (a
  // dead key keeps 0, as an unwritten slot's scale may be NaN)
  auto load_scales = [&](int ti, long long row, float& sk, float& sv) {
    sk = sv = 0.f;
    if (kQuant && ti < n_page && row >= 0) {
      sk = __bfloat162float(kscale[row]);
      sv = __bfloat162float(vscale[row]);
    }
  };

  // Q, then this warp's first tile; rows past W are zero-filled
  for (int c = tid; c < kMq * CPR; c += blockDim.x) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = q0 + r < W;
    cp_async16(q_s + r * LDS + cc, ok ? q + (row_off + q0 + r) * HD + cc : q,
               ok);
  }
  cp_commit();
  int ti = warp;
  float sk = 0.f, sv = 0.f;   // the current tile's scales of this lane's key
  if (ti < n_tiles) {
    const long long row = key_row(ti, bt_entry(ti));
    start_copies(ti, row, wbuf);
    load_scales(ti, row, sk, sv);
  }
  cp_commit();
  int bt_next = bt_entry(ti + kWarps);
  cp_wait<1>();   // Q has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], q_s + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8);

  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};   // rows g, g + 8
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int stage = 0;
  while (ti < n_tiles) {
    // start the next tile (its block-table entries were read a tile ago)
    // and read the entries of the one after it
    const int nx = ti + kWarps;
    float sk_n = 0.f, sv_n = 0.f;
    if (nx < n_tiles) {
      const long long row = key_row(nx, bt_next);
      start_copies(nx, row, wbuf + (stage ^ 1) * mma_stage_bytes<HD>());
      load_scales(nx, row, sk_n, sv_n);
      bt_next = bt_entry(nx + kWarps);
    }
    cp_commit();
    cp_wait<1>();   // this tile has landed (the next may be in flight)
    __syncwarp();
    const unsigned char* buf = wbuf + stage * mma_stage_bytes<HD>();
    const bool win = ti >= n_page;
    const bool codes = kQuant && !win;   // warp-uniform
    const int base = (win ? ti - n_page : ti) * kMk;

    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if (codes) {
      // B fragment of n8 tile n at k-step kk: key 8 n + g, dims
      // 16 kk + 2 t (+1) and + 8, widened from the codes
      if constexpr (kQuant) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int n = 0; n < SN; ++n) {
            const unsigned char* p =
                buf + (8 * n + g) * LDC + kk * 16 + 2 * t;
            mma(s[n], qf[kk],
                widen2<S>(*reinterpret_cast<const uint16_t*>(p)),
                widen2<S>(*reinterpret_cast<const uint16_t*>(p + 8)));
          }
      }
    } else {
      // K rows as stored are the col-major B operand
      const bf16* k_s = reinterpret_cast<const bf16*>(buf);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, k_s + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma(s[2 * np], qf[kk], bb[0], bb[1]);
          mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
        }
    }

    // the score columns' scales: sc, times the K scale of each column's
    // key (held by the lane that owns that key) on a code tile
    float cs[SN][2], vsc[SN][2];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cs[n][e] = sc;
        vsc[n][e] = 1.f;
        if (codes) {
          const int src = 8 * n + 2 * t + e;
          cs[n][e] = sc * __shfl_sync(0xffffffffu, sk, src);
          vsc[n][e] = __shfl_sync(0xffffffffu, sv, src);
        }
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int query = q0 + g + 8 * hr;
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = base + 8 * n + 2 * t + e;
          const bool ok = win ? (key < W && key <= query) : key < pos;
          float& x = s[n][2 * hr + e];
          x = ok ? x * cs[n][e] : kNeg;
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
          const int key = base + 8 * n + 2 * t + e;
          const bool ok = win ? (key < W && key <= query) : key < pos;
          float& x = s[n][2 * hr + e];
          x = ok ? exp2f(x - m_new) : 0.f;
          ps += x;                 // l sums the unrounded p
          x *= vsc[n][e];          // P' = p * sv, rounded once below
        }
      l_r[hr] = corr * l_r[hr] + ps;   // this lane's part of the row sum
      m_r[hr] = m_new;
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // O += bf16(P') V: the score fragments of keys 16 kk .. 16 kk + 15 are
    // the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      if (codes) {
        // B fragment of n8 tile n: keys 16 kk + 2 t (+1) and + 8 (+9) of
        // dim 8 n + g, one code from each of four rows
        if constexpr (kQuant) {
          const unsigned char* v_c = buf + kMk * LDC;
#pragma unroll
          for (int n = 0; n < ON; ++n) {
            const unsigned char* p =
                v_c + (kk * 16 + 2 * t) * LDC + 8 * n + g;
            mma(acc[n], a, widen2<S>(p[0] | (uint32_t(p[LDC]) << 8)),
                widen2<S>(p[8 * LDC] | (uint32_t(p[9 * LDC]) << 8)));
          }
        }
      } else {
        // V's B fragments from ldmatrix.trans
        const bf16* v_s = reinterpret_cast<const bf16*>(buf) + kMk * LDS;
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t bb[4];
          ldsm_x4_t(bb, v_s + (kk * 16 + (lane & 15)) * LDS + dn * 16 +
                            (lane >> 4) * 8);
          mma(acc[2 * dn], a, bb[0], bb[1]);
          mma(acc[2 * dn + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncwarp();   // every lane is done with this stage before it refills
    sk = sk_n;
    sv = sv_n;
    ti = nx;
    stage ^= 1;
  }
  cp_wait<0>();
  __syncwarp();

  // this warp's partial state into its own stages, then the merge
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 1);
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 2);
  }
  {
    float* m_w = reinterpret_cast<float*>(wbuf);
    float* l_w = m_w + kMq;
    float* a_w = l_w + kMq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr;
      if (t == 0) {
        m_w[r] = m_r[hr];
        l_w[r] = l_r[hr];
      }
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        a_w[r * LDA + 8 * n + 2 * t] = acc[n][2 * hr];
        a_w[r * LDA + 8 * n + 2 * t + 1] = acc[n][2 * hr + 1];
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < kMq * CPR; c += blockDim.x) {
    const int r = c / CPR, d0 = (c % CPR) * 8;
    if (q0 + r >= W) continue;
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, reinterpret_cast<const float*>(
                         stages + w * 2 * mma_stage_bytes<HD>())[r]);
    float ll = 0.f, aa[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) aa[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* m_w = reinterpret_cast<const float*>(
          stages + w * 2 * mma_stage_bytes<HD>());
      const float cw = exp2f(m_w[r] - mm);
      ll += m_w[kMq + r] * cw;
      const float* a_w = m_w + 2 * kMq + r * LDA + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) aa[e] += a_w[e] * cw;
    }
    const float div = ll == 0.f ? 1.f : ll;
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ow[e] = pack_bf16(aa[2 * e] / div, aa[2 * e + 1] / div);
    *reinterpret_cast<uint4*>(out + (row_off + q0 + r) * HD + d0) = o;
  }

  if constexpr (MODE == kFused) {
    // scatter this tile's fresh rows into their pages. Writes land at
    // positions >= pos; every read above was < pos (or of k_new / v_new).
    fused_scatter<bf16, S, HD, kMq>(kn, vn, kpool, vpool, kscale, vscale,
                                    bt, pos, wlo_v[b], whi_v[b], row_off, q0,
                                    h, H, W, P, page, warp, lane, tid);
  }
}

// ---- the body split over the keys (K1, K2, K5a, K5b at W = 1; K3, K4) ----
//
// A row's keys are cut into chunks of kChunk keys, one block each, and
// its W queries into groups of QG (QG = 1 for a decode tick, W = 1): the
// grid is (ceil(P * page / kChunk) * ceil(W / QG), H, B), sized from the
// block table's width so that the host never reads pos or lengths, with
// the groups of one (row, head) side by side in x, so that the groups
// re-reading a chunk run close together and find it in L2. A
// block whose chunk starts at or past the row's bound exits at once; the
// live ones (the first max(1, ceil(bound / kChunk))) each walk at most
// kSplitTiles tiles a warp, a decode row's own fresh key riding in the
// last live chunk. Each writes its group's partial (m, l, acc) in f32 to
// the workspace; the last to arrive (a __threadfence, then an atomicAdd
// on the (row, head, group)'s counter) merges them in the same launch and
// resets the counter to 0 for the next launch. A row with one live chunk
// writes its context straight away and never touches the workspace or
// its counter. Under kFused (K1, K2) the last live chunk's block also
// writes the row's fresh K/V row into its page, before it can return;
// under kRead (K3, K4) there is no fresh key and nothing but out is
// written.

constexpr int kSplitTiles = 2;                         // tiles a warp walks
constexpr int kChunk = kWarps * kSplitTiles * kTile;   // keys a block reads
constexpr int kReadGroup = 4;   // queries a block of the sweep holds, W > 1

// A staged key row: HD values as stored (f32, bf16 or codes), padded by
// 16 bytes so that the rows a quarter-warp reads side by side (lane =
// key) fall on distinct banks.
template <typename S, int HD>
__host__ __device__ constexpr int split_row() {
  return HD * int(sizeof(S)) + 16;
}
// one stage of one warp: its K and V tiles
template <typename S, int HD>
__host__ __device__ constexpr size_t split_stage() {
  return 2 * size_t(kTile) * split_row<S, HD>();
}
// Shared memory, dynamic: the group's queries [HD][QG] f32 (the QG
// queries of one dim side by side), then 2 stages per warp. After its
// last tile a warp's first stage holds its partial states for the
// block's merge: QG times (m, l, acc [HD]) f32.
template <typename S, int HD, int QG>
constexpr size_t split_smem() {
  return sizeof(float) * HD * QG + size_t(kWarps) * 2 * split_stage<S, HD>();
}
// The group's QG scores q_j . row over HD: the queries from shared f32
// (every lane reads the same address; four queries a 16-byte read), the
// row as staged, 16 bytes a read; quantized, each code is dequantized as
// f32(code) * sk (exact) before its products, so each sum is the FMA
// body's in the same order.
template <typename S, int HD, int QG, bool SCALED>
__device__ __forceinline__ void split_dot(const float* __restrict__ q_s,
                                          const unsigned char* row, float sk,
                                          float (&s)[QG]) {
  constexpr int EPC = 16 / int(sizeof(S));
#pragma unroll
  for (int j = 0; j < QG; ++j) s[j] = 0.f;
#pragma unroll
  for (int c = 0; c < HD / EPC; ++c) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * c);
    const S* e = reinterpret_cast<const S*>(&v);
#pragma unroll
    for (int i = 0; i < EPC; ++i) {
      const float k = SCALED ? to_f32(e[i]) * sk : to_f32(e[i]);
      const float* qd = q_s + (c * EPC + i) * QG;
      if constexpr (QG % 4 == 0) {
#pragma unroll
        for (int j = 0; j < QG; j += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qd + j);
          s[j] = fmaf(qq.x, k, s[j]);
          s[j + 1] = fmaf(qq.y, k, s[j + 1]);
          s[j + 2] = fmaf(qq.z, k, s[j + 2]);
          s[j + 3] = fmaf(qq.w, k, s[j + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < QG; ++j) s[j] = fmaf(qd[j], k, s[j]);
      }
    }
  }
}

// dims 2 lane and 2 lane + 1 of a staged row, as f32
template <typename S>
__device__ __forceinline__ float2 split_pair(const unsigned char* row,
                                             int lane) {
  const S* e = reinterpret_cast<const S*>(row) + 2 * lane;
  return make_float2(to_f32(e[0]), to_f32(e[1]));
}

// T: query / k_new / v_new / output type (float or bf16); S: page store
// type, T itself (K1, K3, K5a) or int8_t / fp8 (K2, K4, K5b). Block:
// chunk c of (row b = blockIdx.z, head h = blockIdx.y) for the group g of
// QG queries, blockIdx.x = g * chunks + c (QG = 1 at W = 1). Lane t of a
// warp owns key t of each of its tiles (its QG scores are its row's dots
// with the group's queries) and output dims 2 t, 2 t + 1 of each query
// (P V reads each V row once, the p's and the V scale shuffled from the
// key's lane at QG = 1, read from its staged K row at QG > 1). Each warp
// double-buffers its tiles with cp.async, reads the block-table entries
// of its next tile while this one's copies fly and loads a quantized
// key's scales with its copies. MODE kFused (K1, K2) folds in the row's
// fresh key and scatters it, kWindow (K5a, K5b) folds it in and only
// reads, kRead (K3, K4) has no fresh key: keys below min(lengths[b],
// P * page), nothing written but out.
template <typename T, typename S, int MODE, int HD, int QG>
__global__ void __launch_bounds__(kWarps * 32)
pa_split_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                const T* __restrict__ vn, S* __restrict__ kpool,
                S* __restrict__ vpool, bf16* __restrict__ kscale,
                bf16* __restrict__ vscale,
                const int32_t* __restrict__ block_tables,
                const int32_t* __restrict__ bound_v,
                const int32_t* __restrict__ wlo_v,
                const int32_t* __restrict__ whi_v, T* __restrict__ out,
                float* __restrict__ work, int* __restrict__ counters, int H,
                int W, int P, int page, float scale) {
  static_assert(MODE == kRead || QG == 1,
                "a decode row's fresh key belongs to its one query");
  static_assert(HD == 64, "lane t owns output dims 2 t and 2 t + 1");
  static_assert(QG == 1 || (QG % 4 == 0 && 4 * QG + 4 <= HD * sizeof(S)),
                "a group's p's and V scale fit a staged K row, float4s");
  static_assert(sizeof(float) * QG * (HD + 2) <= split_stage<S, HD>(),
                "the merge state fits a warp's first stage");
  constexpr bool kQuant = !std::is_same<S, T>::value;
  constexpr bool kFresh = MODE != kRead;   // a decode row's own key
  constexpr int RB = split_row<S, HD>();
  constexpr int CPR = HD * int(sizeof(S)) / 16;   // 16-byte chunks a row
  constexpr int NT = kWarps * 32;
  constexpr int EPT = (QG * HD + NT - 1) / NT;   // merged outputs a thread
  constexpr int PS = QG * (HD + 2);              // floats of one partial
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* stages = smem_raw + sizeof(float) * HD * QG;

  const int G = (W + QG - 1) / QG;             // query groups of a row
  const int n_chunks = gridDim.x / G;          // chunks of the block table
  const int c = blockIdx.x % n_chunks, g = blockIdx.x / n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // cached keys [0, bound) are visible (none past the block table, as in
  // the plain versions): pos (fused, window) or lengths (read)
  const int bound = min(bound_v[b], P * page);
  const int n_live = max(1, (bound + kChunk - 1) / kChunk);
  if (c >= n_live) return;   // past the bound: nothing to read
  const int k0 = c * kChunk;
  const int k1 = min(k0 + kChunk, bound);   // this chunk's keys [k0, k1)
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;
  const bool fresh = kFresh && c == n_live - 1;   // the fresh key is here
  const int32_t* bt = block_tables + size_t(b) * P;
  const size_t row = size_t(b) * H + h;   // (b, h)
  const size_t rg = row * G + g;          // (b, h, g): partials, counter
  const int nq = min(QG, W - g * QG);     // the group's queries in W
  const size_t q_off = (row * W + size_t(g) * QG) * HD;   // its first one
  unsigned char* wbuf = stages + warp * 2 * split_stage<S, HD>();
  const unsigned char* kbytes = reinterpret_cast<const unsigned char*>(kpool);
  const unsigned char* vbytes = reinterpret_cast<const unsigned char*>(vpool);

  // the group's queries, f32 (slots past W are zero: never written out)
  for (int e = tid; e < QG * HD; e += NT) {
    const int j = e / HD, d = e % HD;
    q_s[d * QG + j] = j < nq ? to_f32(q[q_off + e]) : 0.f;
  }
  // the fresh key and value, dims 2 lane and 2 lane + 1 (warp 0 reads
  // them; their loads fly while the tiles are walked)
  float2 kf = make_float2(0.f, 0.f), vf = kf;
  if constexpr (kFresh) {
    if (fresh && warp == 0) {
      kf = make_float2(to_f32(kn[row * HD + 2 * lane]),
                       to_f32(kn[row * HD + 2 * lane + 1]));
      vf = make_float2(to_f32(vn[row * HD + 2 * lane]),
                       to_f32(vn[row * HD + 2 * lane + 1]));
    }
  }

  // this lane's key in tile ti: its block-table entry (read a tile
  // ahead) and its pool slot (-1 past the chunk: never loaded)
  auto bt_entry = [&](int ti) -> int {
    const int key = k0 + ti * kTile + lane;
    return ti < n_tiles && key < k1 ? bt[key / page] : 0;
  };
  auto key_slot = [&](int ti, int btv) -> long long {
    const int key = k0 + ti * kTile + lane;
    return key < k1 ? ((long long)btv * H + h) * page + key % page : -1;
  };
  // tile ti's K and V rows into a stage, 16 bytes a copy, each from the
  // slot of its own key (dead keys zero-filled, their bytes never read)
  auto start_copies = [&](long long slot, unsigned char* buf) {
#pragma unroll
    for (int i = 0; i < kTile * CPR / 32; ++i) {
      const int e = lane + 32 * i;
      const int r = e / CPR, cc = (e % CPR) * 16;
      const long long src = __shfl_sync(0xffffffffu, slot, r);
      const bool ok = src >= 0;
      const size_t off = ok ? size_t(src) * HD * sizeof(S) + cc : 0;
      cp_async16(buf + r * RB + cc, kbytes + off, ok);
      cp_async16(buf + (kTile + r) * RB + cc, vbytes + off, ok);
    }
  };
  // a live key's K and V scales (a dead key keeps 0: an unwritten slot's
  // scale may be NaN)
  auto load_scales = [&](long long slot, float& sk, float& sv) {
    sk = sv = 0.f;
    if (kQuant && slot >= 0) {
      sk = __bfloat162float(kscale[slot]);
      sv = __bfloat162float(vscale[slot]);
    }
  };

  int ti = warp;
  float sk = 0.f, sv = 0.f;   // the current tile's scales of this lane's key
  if (ti < n_tiles) {
    const long long slot = key_slot(ti, bt_entry(ti));
    start_copies(slot, wbuf);
    load_scales(slot, sk, sv);
  }
  cp_commit();
  int bt_next = bt_entry(ti + kWarps);
  __syncthreads();   // the queries are in shared memory

  float m[QG], l[QG];   // warp-uniform
  float2 acc[QG];
#pragma unroll
  for (int j = 0; j < QG; ++j) {
    m[j] = kNeg;
    l[j] = 0.f;
    acc[j] = make_float2(0.f, 0.f);
  }
  int stage = 0;
  while (ti < n_tiles) {
    // start the next tile (its block-table entries were read a tile ago)
    const int nx = ti + kWarps;
    float sk_n = 0.f, sv_n = 0.f;
    if (nx < n_tiles) {
      const long long slot = key_slot(nx, bt_next);
      start_copies(slot, wbuf + (stage ^ 1) * split_stage<S, HD>());
      load_scales(slot, sk_n, sv_n);
      bt_next = bt_entry(nx + kWarps);
    }
    cp_commit();
    cp_wait<1>();   // this tile has landed (the next may be in flight)
    __syncwarp();
    const unsigned char* k_t = wbuf + stage * split_stage<S, HD>();
    const unsigned char* v_t = k_t + kTile * RB;
    const bool valid = k0 + ti * kTile + lane < k1;
    float p[QG];
    split_dot<S, HD, QG, kQuant>(q_s, k_t + lane * RB, sk, p);
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      const float s = valid ? p[j] * scale : kNeg;
      const float m_new = fmaxf(m[j], warp_max(s));
      p[j] = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[j] - m_new);
      l[j] = corr * l[j] + warp_sum(p[j]);
      acc[j].x *= corr;
      acc[j].y *= corr;
      m[j] = m_new;
    }
    if constexpr (QG == 1) {
      // key t's p and V scale shuffled from its lane
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        float2 v = split_pair<S>(v_t + t * RB, lane);
        if constexpr (kQuant) {
          const float st = __shfl_sync(0xffffffffu, sv, t);
          v.x *= st;   // f32(code) * sv, exact
          v.y *= st;
        }
        const float pt = __shfl_sync(0xffffffffu, p[0], t);
        acc[0].x = fmaf(pt, v.x, acc[0].x);
        acc[0].y = fmaf(pt, v.y, acc[0].y);
      }
    } else {
      // each lane's QG p's (and V scale) written over its own staged K
      // row, which only it read: key t's p's are then broadcast 16-byte
      // loads, not QG shuffles (4-7% off the sweep at W > 1 on the H100)
      unsigned char* mine = wbuf + stage * split_stage<S, HD>() + lane * RB;
#pragma unroll
      for (int j = 0; j < QG; j += 4)
        *reinterpret_cast<float4*>(mine + 4 * j) =
            make_float4(p[j], p[j + 1], p[j + 2], p[j + 3]);
      if constexpr (kQuant) *reinterpret_cast<float*>(mine + 4 * QG) = sv;
      __syncwarp();
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const unsigned char* kt = k_t + t * RB;
        float2 v = split_pair<S>(v_t + t * RB, lane);
        if constexpr (kQuant) {
          const float st = *reinterpret_cast<const float*>(kt + 4 * QG);
          v.x *= st;   // f32(code) * sv, exact
          v.y *= st;
        }
#pragma unroll
        for (int j = 0; j < QG; j += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(kt + 4 * j);
          acc[j].x = fmaf(pp.x, v.x, acc[j].x);
          acc[j].y = fmaf(pp.x, v.y, acc[j].y);
          acc[j + 1].x = fmaf(pp.y, v.x, acc[j + 1].x);
          acc[j + 1].y = fmaf(pp.y, v.y, acc[j + 1].y);
          acc[j + 2].x = fmaf(pp.z, v.x, acc[j + 2].x);
          acc[j + 2].y = fmaf(pp.z, v.y, acc[j + 2].y);
          acc[j + 3].x = fmaf(pp.w, v.x, acc[j + 3].x);
          acc[j + 3].y = fmaf(pp.w, v.y, acc[j + 3].y);
        }
      }
    }
    __syncwarp();   // every lane is done with this stage before it refills
    sk = sk_n;
    sv = sv_n;
    ti = nx;
    stage ^= 1;
  }
  cp_wait<0>();
  __syncwarp();

  if constexpr (kFresh) {
    if (fresh && warp == 0) {
      // the row's own fresh key, never quantized, visible to its query
      const float s =
          warp_sum(fmaf(q_s[2 * lane + 1], kf.y, q_s[2 * lane] * kf.x)) *
          scale;
      const float m_new = fmaxf(m[0], s);
      const float p = expf(s - m_new);
      const float corr = expf(m[0] - m_new);
      l[0] = corr * l[0] + p;
      acc[0].x = fmaf(p, vf.x, corr * acc[0].x);
      acc[0].y = fmaf(p, vf.y, corr * acc[0].y);
      m[0] = m_new;
    }
  }
  if constexpr (MODE == kFused) {
    // the fresh row into its page, by the block that read the fresh key
    // and before any block returns. It lands at pos; every read of this
    // launch was below pos.
    if (fresh)
      fused_scatter<T, S, HD, 1>(kn, vn, kpool, vpool, kscale, vscale, bt,
                                 bound_v[b], wlo_v[b], whi_v[b], row, 0, h,
                                 H, 1, P, page, warp, lane, tid);
  }

  // the warps' partial states into their own first stages, query j's
  // (m, l, acc [HD]) at j * (HD + 2), then merged into the block's
  // (output e = j * HD + d of thread e % NT)
  {
    float* st = reinterpret_cast<float*>(wbuf);
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      if (lane == 0) {
        st[j * (HD + 2)] = m[j];
        st[j * (HD + 2) + 1] = l[j];
      }
      st[j * (HD + 2) + 2 + 2 * lane] = acc[j].x;
      st[j * (HD + 2) + 3 + 2 * lane] = acc[j].y;
    }
  }
  __syncthreads();
  float mm[EPT], ll[EPT], aa[EPT];
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int e = tid + r * NT, j = e / HD, d = e % HD;
    mm[r] = kNeg;
    ll[r] = aa[r] = 0.f;
    if (e >= QG * HD) continue;
    auto state = [&](int w) {   // warp w's (m, l, acc) of query j
      return reinterpret_cast<const float*>(
                 stages + w * 2 * split_stage<S, HD>()) + j * (HD + 2);
    };
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm[r] = fmaxf(mm[r], state(w)[0]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = state(w);
      const float cw = expf(st[0] - mm[r]);
      ll[r] += st[1] * cw;
      aa[r] += st[2 + d] * cw;
    }
  }
  if (n_live == 1) {
    // the whole row in this block: no partials, no counter
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int e = tid + r * NT;
      if (e < QG * HD && e / HD < nq)
        from_f32(aa[r] / (ll[r] == 0.f ? 1.f : ll[r]), &out[q_off + e]);
    }
    return;
  }

  // this chunk's partial: QG times (m, l, acc [HD]), f32, unnormalised
  float* part = work + (rg * n_chunks + c) * PS;
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int e = tid + r * NT, j = e / HD, d = e % HD;
    if (e >= QG * HD) continue;
    part[j * (HD + 2) + 2 + d] = aa[r];
    if (d == 0) {
      part[j * (HD + 2)] = mm[r];
      part[j * (HD + 2) + 1] = ll[r];
    }
  }
  __threadfence();   // the partial is visible before the arrival counts
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[rg], 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  // the last block of (b, h, g) to arrive merges every live chunk's
  // partial, in chunk order
  __threadfence();
  const float* p0 = work + rg * n_chunks * PS;
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int e = tid + r * NT, j = e / HD, d = e % HD;
    if (e >= QG * HD || j >= nq) continue;
    float M = kNeg;
    for (int k = 0; k < n_live; ++k)
      M = fmaxf(M, __ldcg(p0 + k * PS + j * (HD + 2)));
    float L = 0.f, A = 0.f;
    for (int k = 0; k < n_live; ++k) {
      const float* pk = p0 + k * PS + j * (HD + 2);
      const float ck = expf(__ldcg(pk) - M);
      L += __ldcg(pk + 1) * ck;
      A += __ldcg(pk + 2 + d) * ck;
    }
    from_f32(A / (L == 0.f ? 1.f : L), &out[q_off + e]);
  }
  if (tid == 0) counters[rg] = 0;   // ready for the next launch
}

// One launch of the FMA or the tensor-core body: KERN's dynamic shared
// memory raised to SMEM once, then a (ceil(W / QT), H, B) grid of 4-warp
// blocks. Both take the same arguments; T is the query type, S the page
// store type.
template <auto KERN, typename T, typename S, int QT, size_t SMEM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.W + QT - 1) / QT, a.H, a.B);
  KERN<<<grid, kWarps * 32, SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn),
      static_cast<const T*>(a.vn), static_cast<S*>(a.kp),
      static_cast<S*>(a.vp), static_cast<bf16*>(a.ks),
      static_cast<bf16*>(a.vs), a.bt, a.bound, a.wlo, a.whi,
      static_cast<T*>(a.out), a.H, a.W, a.P, a.page, a.scale);
  return cudaGetLastError();
}

// One launch of the split body with QG queries a block: a
// (ceil(P * page / kChunk) * ceil(W / QG), H, B) grid over the caller's
// workspace, (B, H, ceil(W / QG), chunks, QG, HD + 2) f32 partials, and
// (B, H, ceil(W / QG)) int counters that are 0 on entry and left 0.
template <typename T, typename S, int MODE, int QG>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  constexpr size_t SMEM = split_smem<S, 64, QG>();
  if (a.work == nullptr || a.counters == nullptr) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        pa_split_kernel<T, S, MODE, 64, QG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (a.body != nullptr) *a.body = 2;
  const int groups = (a.W + QG - 1) / QG;
  dim3 grid((a.P * a.page + kChunk - 1) / kChunk * groups, a.H, a.B);
  pa_split_kernel<T, S, MODE, 64, QG><<<grid, kWarps * 32, SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn),
      static_cast<const T*>(a.vn), static_cast<S*>(a.kp),
      static_cast<S*>(a.vp), static_cast<bf16*>(a.ks),
      static_cast<bf16*>(a.vs), a.bt, a.bound, a.wlo, a.whi,
      static_cast<T*>(a.out), a.work, a.counters, a.H, a.W, a.P, a.page,
      a.scale);
  return cudaGetLastError();
}

// The sweep's queries a block (K3, K4): one at W = 1, kReadGroup at
// W > 1, every group re-reading its row's chunks (from L2: its groups run
// side by side). No W goes back to the FMA body: on the H100 the split
// body beat it at every W timed, 1, 4, 5, 16 and 64 (time_read.py, both
// trees in one call: at W = 64, 0.153 against 0.262 ms on bf16 pages).
int read_group(int W) { return W == 1 ? 1 : kReadGroup; }

template <typename T, typename S, int MODE>
cudaError_t dispatch(int hd, const Args& a, cudaStream_t s) {
  if (a.B <= 0 || a.H <= 0 || a.W <= 0 || a.P <= 0 || a.page <= 0)
    return cudaErrorInvalidValue;
  // only the head dim of the models served so far; another one is
  // instantiated with the slice that brings a model needing it
  if (hd != 64) return cudaErrorInvalidValue;
  if constexpr (MODE == kRead) {
    // the sweep (K3, K4): split over the keys and the queries
    if (read_group(a.W) == 1) return launch_split<T, S, kRead, 1>(a, s);
    return launch_split<T, S, kRead, kReadGroup>(a, s);
  } else {
    // the decode tick (K1, K2, K5a, K5b): split over the keys
    if (a.W == 1) return launch_split<T, S, MODE, 1>(a, s);
    // windows with bf16 queries: the tensor-core body
    if constexpr (std::is_same<T, bf16>::value) {
      if (a.body != nullptr) *a.body = 1;
      return launch<pa_mma_kernel<S, 64, MODE>, bf16, S, kMq,
                    mma_smem<64>()>(a, s);
    } else {
      return launch<pa_kernel<T, S, MODE, 64, 8>, T, S, 8,
                    smem_bytes<64, 8>()>(a, s);
    }
  }
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
// share it). All int32 arrays are (B,) except block_tables (B, P). At W
// = 1 the split decode body runs over `work` and `counters`, as in
// mmlspark_pa_window_read; both may be null at W > 1. *body (may be
// null; the caller zeroes it) is set to 1 when the launch ran the
// tensor-core body, 2 the split decode body. Returns the launch's
// cudaError_t (0 on success).
int mmlspark_pa_window_fused(int dtype, int hd, const void* q,
                             const void* k_new, const void* v_new,
                             void* k_pages, void* v_pages,
                             const int32_t* block_tables,
                             const int32_t* pos, const int32_t* wlo,
                             const int32_t* whi, void* out, void* work,
                             void* counters, int B, int H, int W, int P,
                             int page, float scale, void* stream,
                             int* body) {
  Args a{q, k_new, v_new, k_pages, v_pages, nullptr, nullptr, block_tables,
         pos, wlo, whi, out, B, H, W, P, page, scale, body,
         static_cast<float*>(work), static_cast<int*>(counters)};
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
                               const int32_t* whi, void* out, void* work,
                               void* counters, int B, int H, int W, int P,
                               int page, float scale, void* stream,
                               int* body) {
  Args a{q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, block_tables,
         pos, wlo, whi, out, B, H, W, P, page, scale, body,
         static_cast<float*>(work), static_cast<int*>(counters)};
  return int(quant_pools<kFused>(dtype, store, hd, a,
                                static_cast<cudaStream_t>(stream)));
}

// K3. Read-only: q (B, H, W, hd) attends the first lengths[b] keys; pools
// in q's dtype; nothing is written but out. The split body runs over
// `work`, at least (B, H, groups, ceil(P * page / chunk), group, hd + 2)
// f32, and `counters`, (B, H, groups) int32, zero on entry and left zero,
// with group = mmlspark_pa_read_group(W) queries a block and groups =
// ceil(W / group). *body (may be null; the caller zeroes it) is set to 2,
// the split body.
int mmlspark_pa_read(int dtype, int hd, const void* q, const void* k_pages,
                     const void* v_pages, const int32_t* block_tables,
                     const int32_t* lengths, void* out, void* work,
                     void* counters, int B, int H, int W, int P, int page,
                     float scale, void* stream, int* body) {
  Args a{q, nullptr, nullptr, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), nullptr, nullptr, block_tables,
         lengths, nullptr, nullptr, out, B, H, W, P, page, scale, body,
         static_cast<float*>(work), static_cast<int*>(counters)};
  return int(plain_pools<kRead>(dtype, hd, a,
                               static_cast<cudaStream_t>(stream)));
}

// K4. K3 over int8 (store 0) or fp8-e4m3 (store 1) pools with their
// (N, H, page) bf16 scale pools.
int mmlspark_pa_read_q(int dtype, int store, int hd, const void* q,
                       const void* k_pages, const void* v_pages,
                       const void* k_scale, const void* v_scale,
                       const int32_t* block_tables, const int32_t* lengths,
                       void* out, void* work, void* counters, int B, int H,
                       int W, int P, int page, float scale, void* stream,
                       int* body) {
  Args a{q, nullptr, nullptr, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), const_cast<void*>(k_scale),
         const_cast<void*>(v_scale), block_tables, lengths, nullptr,
         nullptr, out, B, H, W, P, page, scale, body,
         static_cast<float*>(work), static_cast<int*>(counters)};
  return int(quant_pools<kRead>(dtype, store, hd, a,
                               static_cast<cudaStream_t>(stream)));
}

// K5a. Window read-only: K1's attention (keys < pos[b] from the pools,
// the window's own k_new / v_new rows under the in-window causal mask)
// with nothing written but out; pools in q's dtype. At W = 1 the split
// decode body runs over `work`, (B, H, ceil(P * page / chunk), hd + 2)
// f32, and `counters`, (B, H) int32, zero on entry and left zero (chunk
// from mmlspark_pa_split_chunk); both may be null at W > 1. *body (may be
// null; the caller zeroes it) is set to 1 when the launch ran the
// tensor-core body, 2 the split decode body.
int mmlspark_pa_window_read(int dtype, int hd, const void* q,
                            const void* k_new, const void* v_new,
                            const void* k_pages, const void* v_pages,
                            const int32_t* block_tables, const int32_t* pos,
                            void* out, void* work, void* counters, int B,
                            int H, int W, int P, int page, float scale,
                            void* stream, int* body) {
  Args a{q, k_new, v_new, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), nullptr, nullptr, block_tables, pos,
         nullptr, nullptr, out, B, H, W, P, page, scale, body,
         static_cast<float*>(work), static_cast<int*>(counters)};
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
                              const int32_t* pos, void* out, void* work,
                              void* counters, int B, int H, int W, int P,
                              int page, float scale, void* stream,
                              int* body) {
  Args a{q, k_new, v_new, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), const_cast<void*>(k_scale),
         const_cast<void*>(v_scale), block_tables, pos, nullptr, nullptr,
         out, B, H, W, P, page, scale, body, static_cast<float*>(work),
         static_cast<int*>(counters)};
  return int(quant_pools<kWindow>(dtype, store, hd, a,
                                  static_cast<cudaStream_t>(stream)));
}

// Keys a block of the split body reads (the workspace's chunk).
int mmlspark_pa_split_chunk(void) { return kChunk; }

// Queries a block of the read-only sweep holds at W queries a row (1 at
// W = 1, else 4), for the workspace the caller passes.
int mmlspark_pa_read_group(int W) { return read_group(W); }

const char* mmlspark_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
