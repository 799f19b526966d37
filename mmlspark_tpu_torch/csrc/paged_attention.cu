// Fused paged decode-window attention + page scatter for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pa_fused_kernel` (mmlspark_tpu/ops/
// paged_attention.py, launched by `_pa_fused_call`), the single-device
// bf16 branch of `paged_attention_window`.
//
// What it computes. Row b's W queries sit at absolute positions
// pos[b] .. pos[b]+W-1. Query j attends
//   * every cached key strictly below pos[b], read in place from the
//     (N, H, page, hd) pools through block_tables[b, key / page], and
//   * the window's own fresh keys k_new[b, :, j'] for j' <= j,
// with an online softmax in f32 (masked logits -1e30, l == 0 -> 0).
// In the same launch the fresh K/V rows are written into their pages in
// the pool dtype (no f32 round trip, so the bytes equal the gather
// path's writeback). A row with wlo[b] > whi[b] (inactive) writes
// nothing.
//
// What bounds it on this card: bytes. A decode tick (W = 1) does about
// 4 flops per byte of K/V it reads, far below the ~295 flops/byte at
// which the H100's compute would be the limit, so the least time is the
// live pages (each read once) over the 3.35 TB/s of HBM.
//
// What the design does about that. The TPU kernel swept a sequential
// (b, page) grid with scratch carried across grid steps; here one block
// owns (query tile, head, row) and loops only over the row's LIVE keys
// (ceil(pos / 32) tiles of 32 keys, never the block table's full width).
// The block's warps split the key tiles between them so that a W = 1
// tick still keeps four warps per (row, head) reading, each warp keeps
// its own running (m, l, acc) in registers, and the partial softmax
// states merge once through shared memory at the end. A tile's K and V
// rows arrive as 16-byte vector loads, all issued before the first is
// used, after one block-table read per key: one memory round trip per
// tile, not one per element. Keys at or past pos[b] are never loaded
// (their tile slots are zero-filled), so garbage in unwritten page slots
// cannot reach p * v, and the reads never touch the slots this launch
// writes. The math is plain f32 FMA loops; tensor cores, TMA, loads
// pipelined across tiles and CUDA graphs are later work.
//
// Page-size rule: none. Tiles are 32 keys wide in the logical key space
// and each key's page is looked up on its own, so any page size >= 1
// works (the TPU sublane rounding does not apply here).
//
// Build: mmlspark_tpu_torch/utils/cuda_build.py runs nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC on this file.
// Interface: plain C, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // warps per block
constexpr int kTile = 32;     // keys per tile (one per lane)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

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
// -1 = past the limit, zero-filled). Rows are read as 16-byte vectors
// (HD * sizeof(T) is a multiple of 16; the wrapper checks the base
// pointers' alignment), and every load of the tile is issued before any
// is used, so a tile costs one memory round trip, not one per element.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long row, int lane,
                                          float* __restrict__ dst) {
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte chunk
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
    const T* v = reinterpret_cast<const T*>(&buf[i]);
    float* d = dst + (c / CPR) * LD + (c % CPR) * EPC;
#pragma unroll
    for (int e = 0; e < EPC; ++e) d[e] = to_f32(v[e]);
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

template <typename T, int HD, int QT>
__global__ void __launch_bounds__(kWarps * 32)
pa_window_fused_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                       const T* __restrict__ vn, T* __restrict__ kpool,
                       T* __restrict__ vpool,
                       const int32_t* __restrict__ block_tables,
                       const int32_t* __restrict__ pos_v,
                       const int32_t* __restrict__ wlo_v,
                       const int32_t* __restrict__ whi_v,
                       T* __restrict__ out, int H, int W, int P, int page,
                       float scale) {
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
  const int pos = pos_v[b];
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

  // the live key tiles: cached keys [0, pos), then the window keys this
  // query tile can see, [0, min(q0 + QT, W))
  const int n_page_tiles = (pos + kTile - 1) / kTile;
  const int w_end = min(q0 + QT, W);
  const int n_win_tiles = (w_end + kTile - 1) / kTile;
  float* k_t = kv_s + warp * 2 * kTile * LD;
  float* v_t = k_t + kTile * LD;

  for (int tile = warp; tile < n_page_tiles + n_win_tiles; tile += kWarps) {
    const bool win = tile >= n_page_tiles;
    const int base = (win ? tile - n_page_tiles : tile) * kTile;
    const int limit = win ? w_end : pos;
    const int key = base + lane;
    // each lane looks up its own key's row once (one block-table read)
    long long row = -1;   // element offset of this lane's key row
    if (key < limit) {
      row = win ? (long long)(row_off + key) * HD
                : ((long long)bt[key / page] * H + h) * page * HD +
                      (long long)(key % page) * HD;
    }
    load_tile<T, HD>(win ? kn : kpool, row, lane, k_t);
    load_tile<T, HD>(win ? vn : vpool, row, lane, v_t);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float* qi = q_s + i * HD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qi[d], k_t[lane * LD + d], s);
      s *= scale;
      // cached keys are all visible (key < pos); a window key j is
      // visible to query q0 + i when j <= q0 + i (and j < W)
      const bool valid = win ? (key < W && key <= q0 + i) : (key < pos);
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

  // scatter this tile's fresh rows into their pages, in the pool dtype.
  // Writes land at positions >= pos; every read above was < pos.
  const int wlo = wlo_v[b], whi = whi_v[b];
  if (wlo > whi) return;   // inactive row: writes nothing
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

template <typename T, int HD, int QT>
cudaError_t launch(const void* q, const void* kn, const void* vn,
                   void* kpool, void* vpool, const int32_t* bt,
                   const int32_t* pos, const int32_t* wlo,
                   const int32_t* whi, void* out, int B, int H, int W,
                   int P, int page, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, QT>();
  auto kern = pa_window_fused_kernel<T, HD, QT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((W + QT - 1) / QT, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kpool),
      static_cast<T*>(vpool), bt, pos, wlo, whi, static_cast<T*>(out), H,
      W, P, page, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_qt(const void* q, const void* kn, const void* vn,
                        void* kp, void* vp, const int32_t* bt,
                        const int32_t* pos, const int32_t* wlo,
                        const int32_t* whi, void* out, int B, int H, int W,
                        int P, int page, float scale, cudaStream_t s) {
  if (W == 1)
    return launch<T, HD, 1>(q, kn, vn, kp, vp, bt, pos, wlo, whi, out, B, H,
                            W, P, page, scale, s);
  return launch<T, HD, 8>(q, kn, vn, kp, vp, bt, pos, wlo, whi, out, B, H,
                          W, P, page, scale, s);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kn,
                        const void* vn, void* kp, void* vp,
                        const int32_t* bt, const int32_t* pos,
                        const int32_t* wlo, const int32_t* whi, void* out,
                        int B, int H, int W, int P, int page, float scale,
                        cudaStream_t s) {
  // only the head dim of the models served so far; another one is
  // instantiated with the slice that brings a model needing it
  if (hd == 64)
    return dispatch_qt<T, 64>(q, kn, vn, kp, vp, bt, pos, wlo, whi, out, B,
                              H, W, P, page, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, pools and out share
// it). All int32 arrays are (B,) except block_tables (B, P). Returns the
// launch's cudaError_t (0 on success).
int mmlspark_pa_window_fused(int dtype, int hd, const void* q,
                             const void* k_new, const void* v_new,
                             void* k_pages, void* v_pages,
                             const int32_t* block_tables,
                             const int32_t* pos, const int32_t* wlo,
                             const int32_t* whi, void* out, int B, int H,
                             int W, int P, int page, float scale,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || P <= 0 || page <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k_new, v_new, k_pages, v_pages,
                             block_tables, pos, wlo, whi, out, B, H, W, P,
                             page, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k_new, v_new, k_pages, v_pages,
                                     block_tables, pos, wlo, whi, out, B, H,
                                     W, P, page, scale, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* mmlspark_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
