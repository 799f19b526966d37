// K6: the per-level GBDT histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` (mmlspark_tpu/ops/pallas_kernels.py,
// launched by `_level_histogram_pallas`). One launch per tree level:
//
//   hist[node, f, bin, s] = sum of stat_s(row) over the rows r with
//                           node[r] == node and bins[f, r] == bin,
//   s in (g, h, w),
//
// added into the zeroed (n_nodes, F, n_bins, 3) f32 output the wrapper
// allocates (mmlspark_tpu_torch/ops/histogram.py). Bins are feature-major
// (F, n), uint8 or the raw bits of uint16; node ids are int32; g, h and w
// are (n,) f32, rounded to bf16 on load when the caller asks for bf16
// stats (`kBf16`: the intrinsic torch's own conversion uses on this card,
// so the values summed are bitwise what `.to(torch.bfloat16)` gives).
//
// Multiclass (K classes): the JAX package vmaps its tree build over the
// classes, which puts a class axis on the TPU kernel's grid. Here the
// class is the grid's second axis: plane k of blocks (blockIdx.y = k)
// sums class k's node ids, g and h (rows k of (K, n) arrays) over the
// shared bins and count weights into histogram k of the (K, n_nodes, F,
// n_bins, 3) output, so one launch builds a level for all K classes.
// Each plane reads the bins again (K * F * n bytes where the bound counts
// F * n once); the alternative, a block adding each row it reads into all
// K classes' tables, needs K tables in one block's shared memory, which
// at 255 bins holds the lanes body's tables for one class only.
//
// The TPU kernel turned the scatter into a one-hot matmul on the MXU
// because the TPU has no fast scatter; that does ~n_bins times the work.
// Here the scatter is a scatter, into shared-memory tables.
//
// What bounds it. Each input read once and the output written once is
// n*F*itemsize + n*16 + n_nodes*F*n_bins*12 bytes: ~485 MB at n = 11M,
// F = 28, uint8 and 16 nodes, 0.145 ms at 3.35 TB/s. What the first body
// (one feature a block, 512 threads) spent, measured on the card with
// throwaway variants of it (PERF.md §6, K6): a shared f32 atomicAdd is a
// CAS loop (LDS, FADD, ATOMS.CAST.SPIN, branch), and its three loops a row
// and feature took ~0.8-0.9 of 2.2 ms a HIGGS level; an int32 atomicAdd is
// one native ATOMS instruction (moving the count onto it saved 0.4 ms);
// reading node ids and stats once per feature took ~0.2 ms; the lanes of
// a warp on one slot (a 2-bin feature) serialise in the CAS loop
// (+2.8 ms); and at 256 nodes the slot chunks' re-reads of every row and
// the flushes of 896 blocks cost more than one `index_add_` even with no
// atomics at all. The redesign's own variants then showed shared-memory
// traffic (random slots meeting in banks) and load latency set the pace.
// So, each mechanism against one of those:
//
//   * the launch plan is `hist_launch_plan` in the wrapper (pure Python,
//     tested on the CPU) and comes in as arguments; this file computes
//     none. Blocks of 1024 threads, two an SM where their tables fit half
//     its shared memory (64 warps hide the loads' latency), row blocks
//     filling one wave and no more, so each slot is flushed from few
//     blocks;
//   * the count is an int32 add (native, warp-aggregated by the compiler
//     into ATOMS.POPC.INC for + 1), exact; a count weight other than 0 or
//     1 goes to the output's count with a global f32 add instead. g and
//     h stay f32 adds (the compiler's CAS loops): a 64-bit CAS on a
//     (g, h) pair measured slower;
//   * tables are planes of g, h and counts, not (g, h, w) triples
//     (interleaved pairs put every g on an even bank);
//   * `hist_lanes_kernel` (1-4 nodes at 255 bins): lane l of a warp sums
//     feature l % W of the block's group for row l / W into tables laid
//     out [slot][W], W = 32 or 16, so a warp's adds meet in a bank at most
//     32 / W at a time, and a few-valued feature's lanes are spread over
//     rows, not stacked on one slot;
//   * `hist_rows_kernel<kTable>` (from 8 nodes at 255 bins, and uint16
//     bins): a thread takes 4 rows at a time (16-byte loads of node ids
//     and stats, one 32-bit load of 4 bins, the next feature's bins in
//     flight) and sums a group of features, so node ids and stats are
//     read once per group; past one block's shared memory, up to four
//     slot chunks of whole nodes, each block skipping the other rows;
//   * `hist_rows_kernel<!kTable>` (levels that would need more than four
//     slot chunks, e.g. 256 nodes): no table; each row and feature adds
//     into the output directly, in one float4 atomic add where the slot's
//     alignment allows it;
//   * rows with g = h = w = 0 (bagged out) add nothing and are skipped;
//     out-of-range node ids and bins are dropped (the wrapper cannot check
//     values without stalling the card).
//
// Numbers. Counts are exact (integers below 2^24, as the f32 output needs
// anyway). g and h are added in an order that changes from run to run, so
// they are not bitwise reproducible: each block sums its rows' share of a
// slot in f32, then adds that partial into the output with global atomics.
// A deterministic, fixed-order mode is later work.
//
// Build: mmlspark_tpu_torch/utils/cuda_build.py runs nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC on this file.
// Interface: plain C, loaded with ctypes; the entry returns the launch's
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;    // HIST_THREADS in ops/histogram.py
constexpr int kDead = -(1 << 30); // a row's slot base when it adds nothing
constexpr unsigned kFull = 0xffffffffu;

template <bool kBf16>
__device__ __forceinline__ float round_stat(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// out[idx, :] += (g, h, c) for the output's slot `idx` (the 3 floats at
// out + 3 * idx; `total` slots, out 16-byte aligned), in as few global
// atomics as the slot's alignment allows: one float4 add when the slot
// starts a 16-byte window (the window's fourth float, the next slot's g,
// gets + 0) or ends one (the previous slot's count gets + 0), else a
// float2 add on the 8-byte aligned pair and one float add. Zeros are
// not added.
__device__ __forceinline__ void add_out(float* out, long long idx,
                                        long long total, float g, float h,
                                        float c) {
  if (g == 0.f && h == 0.f && c == 0.f) return;
  float* o = out + 3 * idx;
  switch (idx & 3) {
    case 0:
      if (idx + 1 < total) {
        atomicAdd(reinterpret_cast<float4*>(o), make_float4(g, h, c, 0.f));
        return;
      }
      atomicAdd(reinterpret_cast<float2*>(o), make_float2(g, h));
      if (c != 0.f) atomicAdd(o + 2, c);
      return;
    case 3:
      atomicAdd(reinterpret_cast<float4*>(o - 1), make_float4(0.f, g, h, c));
      return;
    case 1:
      if (g != 0.f) atomicAdd(o, g);
      if (h != 0.f || c != 0.f)
        atomicAdd(reinterpret_cast<float2*>(o + 1), make_float2(h, c));
      return;
    default:
      if (g != 0.f || h != 0.f)
        atomicAdd(reinterpret_cast<float2*>(o), make_float2(g, h));
      if (c != 0.f) atomicAdd(o + 2, c);
  }
}

// The bins of rows r .. r + 3 of one column, packed a byte (uint8) or two
// (uint16) a row: `load` issues the loads, `get` reads a row's bin once
// they arrive, so a caller keeps the next column's loads in flight
// meanwhile. A uint8 quad inside the block's rows loads one aligned 32-bit
// word, two when the column is not 4-byte aligned (n % 4 != 0); the last,
// short quad and uint16 bins load row by row.
template <typename B>
struct Quad {
  uint32_t lo, hi;
  __device__ __forceinline__ void load(const B* col, long long r,
                                       long long r1) {
    if (sizeof(B) == 1 && r + 4 <= r1) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(col + r);
      const uint32_t* p = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
      lo = __ldg(p);
      hi = (a & 3) ? __ldg(p + 1) : 0u;
    } else {
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = r + k < r1 ? (uint32_t)col[r + k] : 0xffffu;
      lo = v[0] | (v[1] << 16);
      hi = v[2] | (v[3] << 16);
    }
  }
  // bin of row r + k, for k in 0..3 (0xffff for a row past the block's end)
  __device__ __forceinline__ unsigned get(const B* col, long long r,
                                          long long r1, int k) const {
    if (sizeof(B) == 1 && r + 4 <= r1) {
      const unsigned mis = reinterpret_cast<uintptr_t>(col + r) & 3u;
      const uint32_t word = mis ? __funnelshift_r(lo, hi, 8 * mis) : lo;
      return (word >> (8 * k)) & 0xffu;
    }
    return ((k < 2 ? lo : hi) >> (16 * (k & 1))) & 0xffffu;
  }
};

// Block i: feature group gi = i % groups (features [gi * group, ...)),
// slot chunk ci = (i / groups) % chunks (slots [ci * chunk_slots, ...)),
// row block rb = i / (groups * chunks) (rows [rb * rows_per_block, ...)).
// kTable: the block sums into shared-memory tables, planes of g, h (f32)
// and counts (int32), each [group][chunk_slots], and flushes them at its
// end; otherwise (the direct body: one group of every feature, one chunk
// of every slot) every row and feature adds into the output directly.
template <typename B, bool kBf16, bool kTable>
__global__ void __launch_bounds__(kThreads, 2)
hist_rows_kernel(const B* __restrict__ bins,
                 const int32_t* __restrict__ node,
                 const float* __restrict__ g, const float* __restrict__ h,
                 const float* __restrict__ w, float* __restrict__ out,
                 long long n, int F, int n_nodes, int n_bins, int group,
                 int groups, int chunk_slots, int chunks,
                 long long rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = group * chunk_slots;
  float* tg = reinterpret_cast<float*>(smem);
  float* th = tg + plane;
  int* tc = reinterpret_cast<int*>(th + plane);
  // this block's class: its rows of node, g and h, its histogram's first
  // slot in the output (slots are numbered over all classes, so add_out's
  // alignment rule holds in every class's histogram)
  const long long per_class = (long long)n_nodes * F * n_bins;
  const long long obase = (long long)blockIdx.y * per_class;
  const long long total = per_class * gridDim.y;
  node += (long long)blockIdx.y * n;
  g += (long long)blockIdx.y * n;
  h += (long long)blockIdx.y * n;
  // 16-byte loads need 16-byte aligned class rows (n % 4 == 0, or K = 1)
  const bool vec = ((reinterpret_cast<uintptr_t>(node) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(h)) & 15) == 0;

  const unsigned gi = blockIdx.x % (unsigned)groups;
  const unsigned rest = blockIdx.x / (unsigned)groups;
  const int f0 = (int)gi * group;
  const int nf = min(group, F - f0);
  const int s0 = (int)(rest % (unsigned)chunks) * chunk_slots;
  const int ns = min(chunk_slots, n_nodes * n_bins - s0);
  const long long r0 = (long long)(rest / (unsigned)chunks) * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  // the nodes whose slots meet this chunk (in [0, n_nodes))
  const int nd_lo = s0 / n_bins;
  const int nd_hi = (s0 + ns - 1) / n_bins;

  if (kTable) {
    for (int i = threadIdx.x; i < nf * chunk_slots; i += kThreads) {
      tg[i] = th[i] = 0.f;
      tc[i] = 0;
    }
    __syncthreads();
  }

  // a thread takes 4 consecutive rows at a time (rows_per_block is a
  // multiple of 4, and w is 16-byte aligned)
  for (long long r = r0 + 4LL * threadIdx.x; r < r1; r += 4LL * kThreads) {
    int nd[4];
    float gv[4], hv[4], wv[4];
    if (vec && r + 4 <= r1) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(node + r));
      const float4 b = __ldg(reinterpret_cast<const float4*>(g + r));
      const float4 c = __ldg(reinterpret_cast<const float4*>(h + r));
      const float4 d = __ldg(reinterpret_cast<const float4*>(w + r));
      nd[0] = a.x; nd[1] = a.y; nd[2] = a.z; nd[3] = a.w;
      gv[0] = b.x; gv[1] = b.y; gv[2] = b.z; gv[3] = b.w;
      hv[0] = c.x; hv[1] = c.y; hv[2] = c.z; hv[3] = c.w;
      wv[0] = d.x; wv[1] = d.y; wv[2] = d.z; wv[3] = d.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = r + k < r1;
        nd[k] = in ? node[r + k] : -1;
        gv[k] = in ? g[r + k] : 0.f;
        hv[k] = in ? h[r + k] : 0.f;
        wv[k] = in ? w[r + k] : 0.f;
      }
    }
    // per row: its slot base nd * n_bins - s0 (kDead when it adds nothing)
    // and, in a table block, its count bit (w = 1); a weight other than 0
    // or 1 goes to the output's count directly
    int rel[4];
    unsigned ones = 0u, other = 0u, lives = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gv[k] = round_stat<kBf16>(gv[k]);
      hv[k] = round_stat<kBf16>(hv[k]);
      wv[k] = round_stat<kBf16>(wv[k]);
      const bool live = nd[k] >= nd_lo && nd[k] <= nd_hi &&
                        (gv[k] != 0.f || hv[k] != 0.f || wv[k] != 0.f);
      rel[k] = live ? nd[k] * n_bins - s0 : kDead;
      lives |= (unsigned)live << k;
      if (live && wv[k] == 1.f) ones |= 1u << k;
      else if (live && wv[k] != 0.f) other |= 1u << k;
    }
    if (kTable && other) {          // rare: the count added in place
      for (int f = 0; f < nf; ++f) {
        const B* col = bins + (long long)(f0 + f) * n;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(other >> k & 1u)) continue;
          const unsigned b = (unsigned)col[r + k];
          const int s = rel[k] + (int)b;
          if (b < (unsigned)n_bins && (unsigned)s < (unsigned)ns)
            add_out(out, obase + ((long long)nd[k] * F + f0 + f) * n_bins + b,
                    total, 0.f, 0.f, wv[k]);
        }
      }
    }
    if (!lives) continue;

    Quad<B> cur, nxt;
    nxt.lo = nxt.hi = 0u;
    cur.load(bins + (long long)f0 * n, r, r1);
    for (int f = 0; f < nf; ++f) {
      const B* col = bins + (long long)(f0 + f) * n;
      if (f + 1 < nf) nxt.load(col + n, r, r1);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned b = cur.get(col, r, r1, k);
        const int s = rel[k] + (int)b;
        if (b >= (unsigned)n_bins || (unsigned)s >= (unsigned)ns) continue;
        if (kTable) {
          const int i = f * chunk_slots + s;
          if (gv[k] != 0.f) atomicAdd(tg + i, gv[k]);
          if (hv[k] != 0.f) atomicAdd(th + i, hv[k]);
          if (ones >> k & 1u) atomicAdd(tc + i, 1);
        } else {
          add_out(out, obase + ((long long)nd[k] * F + f0 + f) * n_bins + b,
                  total, gv[k], hv[k], wv[k]);
        }
      }
      cur = nxt;
    }
  }

  if (kTable) {
    __syncthreads();
    // flush: out[node, f, bin, :] += the block's non-zero partials
    for (int i = threadIdx.x; i < nf * ns; i += kThreads) {
      const int f = i / ns;
      const int slot = s0 + (i - f * ns);
      const int nd = slot / n_bins;
      const int j = f * chunk_slots + (i - f * ns);
      add_out(out,
              obase + ((long long)nd * F + f0 + f) * n_bins +
                  (slot - nd * n_bins),
              total, tg[j], th[j], (float)tc[j]);
    }
  }
}

// The lanes body, for levels whose slots fit W = 32, 16, 8 or 4 times
// over in shared memory: a warp takes K = 32 / W rows at a time, lane l
// summing feature f0 + l % W of the block's group (up to W features) for
// row l / W, walking its 32-row tiles (each row's node id and stats
// broadcast from the lane that loaded them) into tables laid out
// [slot][W]. Lane l then only touches banks l % W + W * i: at W = 32 a
// warp's adds never meet in a bank, at W = 4 eight rows share each bank
// group (as the table body's 32 rows share all 32 banks). A feature with
// few distinct bins costs little more than any other: its lanes are
// spread over the rows of a tile, not stacked on one slot.
template <int W, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
hist_lanes_kernel(const uint8_t* __restrict__ bins,
                  const int32_t* __restrict__ node,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const float* __restrict__ w, float* __restrict__ out,
                  long long n, int F, int n_nodes, int n_bins, int group,
                  int groups, long long rows_per_block) {
  constexpr int K = 32 / W;       // rows a warp takes at a time
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_slots = n_nodes * n_bins;
  float* tg = reinterpret_cast<float*>(smem);
  float* th = tg + W * n_slots;
  int* tc = reinterpret_cast<int*>(th + W * n_slots);
  // this block's class (as in hist_rows_kernel)
  const long long per_class = (long long)n_slots * F;
  const long long obase = (long long)blockIdx.y * per_class;
  const long long total = per_class * gridDim.y;
  node += (long long)blockIdx.y * n;
  g += (long long)blockIdx.y * n;
  h += (long long)blockIdx.y * n;
  const int f0 = (int)(blockIdx.x % (unsigned)groups) * group;
  const int nf = min(group, F - f0);
  const long long r0 = (long long)(blockIdx.x / (unsigned)groups) *
                       rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);

  for (int i = threadIdx.x; i < W * n_slots; i += kThreads) {
    tg[i] = th[i] = 0.f;
    tc[i] = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int fl = lane % W;        // this lane's feature in the group
  const int o = lane / W;         // and its row among the K
  const bool mine = fl < nf;
  const uint8_t* col = bins + (long long)(f0 + (mine ? fl : 0)) * n;
  // the tile loop is the warp's, so its lanes stay converged for the
  // shuffles (rows_per_block is a multiple of 32)
  for (long long t = r0 + 32 * (threadIdx.x >> 5); t < r1;
       t += 32 * (kThreads / 32)) {
    const long long r = t + lane;
    int nd = -1;
    float gv = 0.f, hv = 0.f, wv = 0.f;
    if (r < r1) {
      nd = node[r];
      gv = round_stat<kBf16>(g[r]);
      hv = round_stat<kBf16>(h[r]);
      wv = round_stat<kBf16>(w[r]);
    }
    const unsigned lives = __ballot_sync(
        kFull, nd >= 0 && nd < n_nodes && (gv != 0.f || hv != 0.f ||
                                            wv != 0.f));
    if (!lives) continue;
    // this lane's feature's bins of the tile: two 16-byte loads, or byte
    // by byte when the column is not 16-byte aligned or the tile is short
    uint32_t wd[8];
    const uint8_t* p = col + t;
    if (t + 32 <= r1 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
      wd[0] = a.x; wd[1] = a.y; wd[2] = a.z; wd[3] = a.w;
      wd[4] = b.x; wd[5] = b.y; wd[6] = b.z; wd[7] = b.w;
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t v = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t + 4 * q + e < r1) v |= (uint32_t)p[4 * q + e] << (8 * e);
        wd[q] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (!((lives >> (j * K)) & ((1ull << K) - 1u))) continue;
      const int src = j * K + o;  // the tile row this lane adds
      const int ndj = __shfl_sync(kFull, nd, src);
      const float gj = __shfl_sync(kFull, gv, src);
      const float hj = __shfl_sync(kFull, hv, src);
      const float wj = __shfl_sync(kFull, wv, src);
      // byte src of wd: word (j * K) / 4 (+ 1 for o >= 4 when K = 8)
      const uint32_t word = (K == 8 && (o & 4)) ? wd[(j * K) / 4 + 1]
                                                : wd[(j * K) / 4];
      const unsigned b = (word >> (8 * (src & 3))) & 0xffu;
      if (!mine || !(lives >> src & 1u) || b >= (unsigned)n_bins) continue;
      const int a = (ndj * n_bins + (int)b) * W + fl;
      if (gj != 0.f) atomicAdd(tg + a, gj);
      if (hj != 0.f) atomicAdd(th + a, hj);
      if (wj == 1.f)
        atomicAdd(tc + a, 1);
      else if (wj != 0.f)         // rare: a count weight other than 0 / 1
        add_out(out, obase + ((long long)ndj * F + f0 + fl) * n_bins + b,
                total, 0.f, 0.f, wj);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < W * n_slots; i += kThreads) {
    const int l = i % W;
    if (l >= nf) continue;
    const int slot = i / W;
    const int nd = slot / n_bins;
    add_out(out,
            obase + ((long long)nd * F + f0 + l) * n_bins +
                (slot - nd * n_bins),
            total, tg[i], th[i], (float)tc[i]);
  }
}

template <typename K, typename... Args>
cudaError_t launch(K kern, unsigned blocks, unsigned classes, int smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // two blocks an SM need the whole carveout for shared memory
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<dim3(blocks, classes), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_lanes(int width, const uint8_t* bins, const int32_t* node,
                         const float* g, const float* h, const float* w,
                         float* out, long long n, int F, int n_nodes,
                         int n_bins, int group, int groups,
                         long long rows_per_block, unsigned blocks,
                         unsigned classes, int smem, cudaStream_t stream) {
#define MMLSPARK_HIST_LANES(WIDTH)                                          \
  return launch(hist_lanes_kernel<WIDTH, kBf16>, blocks, classes, smem,     \
                stream, bins, node, g, h, w, out, n, F, n_nodes, n_bins,    \
                group, groups, rows_per_block)
  if (width == 32) MMLSPARK_HIST_LANES(32);
  if (width == 16) MMLSPARK_HIST_LANES(16);
  if (width == 8) MMLSPARK_HIST_LANES(8);
  if (width == 4) MMLSPARK_HIST_LANES(4);
#undef MMLSPARK_HIST_LANES
  return cudaErrorInvalidValue;
}

template <typename B, bool kBf16>
cudaError_t launch_rows(bool table, const void* bins, const int32_t* node,
                        const float* g, const float* h, const float* w,
                        float* out, long long n, int F, int n_nodes,
                        int n_bins, int group, int groups, int chunk_slots,
                        int chunks, long long rows_per_block,
                        unsigned blocks, unsigned classes, int smem,
                        cudaStream_t stream) {
  const B* b = static_cast<const B*>(bins);
  if (table)
    return launch(hist_rows_kernel<B, kBf16, true>, blocks, classes, smem,
                  stream, b, node, g, h, w, out, n, F, n_nodes, n_bins,
                  group, groups, chunk_slots, chunks, rows_per_block);
  return launch(hist_rows_kernel<B, kBf16, false>, blocks, classes, smem,
                stream, b, node, g, h, w, out, n, F, n_nodes, n_bins, group,
                groups, chunk_slots, chunks, rows_per_block);
}

}  // namespace

extern "C" {

// K6. body: 0 direct, 1 table, 2 lanes (`hist_launch_plan`'s `body`);
// width: the lanes body's W (32, 16, 8 or 4), else 1.
// bin_bytes: 1 (uint8 bins) or 2 (uint16 bits); bf16_stats: 1 rounds g, h,
// w to bf16 on load. bins (F, n); node (classes, n) int32; g, h (classes,
// n) float32; w (n,) float32; node, g, h, w 16-byte aligned; out (classes,
// n_nodes, F, n_bins, 3) float32, 16-byte aligned, zeroed by the caller
// and added into. The plan (group, groups, chunk_slots, chunks,
// rows_per_block, blocks a class, classes, smem) is `hist_launch_plan`'s;
// it is checked for consistency, not made here. Returns cudaError_t.
int mmlspark_level_histogram(int body, int width, int bin_bytes,
                             int bf16_stats,
                             const void* bins, const void* node,
                             const void* g, const void* h, const void* w,
                             void* out, long long n, int F, int n_nodes,
                             int n_bins, int group, int groups,
                             int chunk_slots, int chunks,
                             long long rows_per_block, long long blocks,
                             int classes, int smem, void* stream) {
  if (n <= 0 || F <= 0 || n_nodes <= 0 || n_bins <= 0 || group <= 0 ||
      groups <= 0 || chunk_slots <= 0 || chunks <= 0 || rows_per_block <= 0 ||
      classes <= 0 || classes > 65535)
    return int(cudaErrorInvalidValue);
  const long long n_slots = (long long)n_nodes * n_bins;
  const long long row_blocks = (n + rows_per_block - 1) / rows_per_block;
  const long long want_smem = body == 0   ? 0
                              : body == 1 ? (long long)group * chunk_slots * 12
                                          : n_slots * width * 12;
  if (n_slots >= (1LL << 31) || (long long)group * groups < F ||
      (long long)group * (groups - 1) >= F ||
      (long long)chunk_slots * chunks < n_slots ||
      (long long)chunk_slots * (chunks - 1) >= n_slots ||
      blocks != (long long)groups * chunks * row_blocks ||
      blocks > 0x7fffffffLL || (long long)smem != want_smem ||
      (body == 2 && (group > width || chunks != 1 || bin_bytes != 1 ||
                     rows_per_block % 32 != 0)) ||
      (body != 2 && width != 1) ||
      (body != 2 && rows_per_block % 4 != 0) || body < 0 || body > 2)
    return int(cudaErrorInvalidValue);
  const int32_t* nd = static_cast<const int32_t*>(node);
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  const unsigned nc = (unsigned)classes;
  if (body == 2) {
    const uint8_t* b8 = static_cast<const uint8_t*>(bins);
    if (bf16_stats)
      return int(launch_lanes<true>(width, b8, nd, gf, hf, wf, o, n, F,
                                    n_nodes, n_bins, group, groups,
                                    rows_per_block, nb, nc, smem, s));
    return int(launch_lanes<false>(width, b8, nd, gf, hf, wf, o, n, F,
                                   n_nodes, n_bins, group, groups,
                                   rows_per_block, nb, nc, smem, s));
  }
  const bool table = body == 1;
#define MMLSPARK_HIST_ROWS(B, BF16)                                         \
  return int(launch_rows<B, BF16>(table, bins, nd, gf, hf, wf, o, n, F,      \
                                  n_nodes, n_bins, group, groups,           \
                                  chunk_slots, chunks, rows_per_block, nb,  \
                                  nc, smem, s))
  if (bin_bytes == 1 && bf16_stats) MMLSPARK_HIST_ROWS(uint8_t, true);
  if (bin_bytes == 1) MMLSPARK_HIST_ROWS(uint8_t, false);
  if (bin_bytes == 2 && bf16_stats) MMLSPARK_HIST_ROWS(uint16_t, true);
  if (bin_bytes == 2) MMLSPARK_HIST_ROWS(uint16_t, false);
#undef MMLSPARK_HIST_ROWS
  return int(cudaErrorInvalidValue);
}

const char* mmlspark_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
