// K6: the per-level GBDT histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` (mmlspark_tpu/ops/pallas_kernels.py,
// launched by `_level_histogram_pallas`). One launch per tree level:
//
//   hist[node, f, bin, s] = sum of stat_s(row) over the rows r with
//                           node[r] == node and bins[f, r] == bin,
//   s in (g, h, w),
//
// written into the zeroed (n_nodes, F, n_bins, 3) f32 output the wrapper
// allocates (mmlspark_tpu_torch/ops/histogram.py). Bins are feature-major
// (F, n), uint8 or the raw bits of uint16; node ids are int32; g, h and w
// are (n,) f32 (bf16-rounded by the wrapper when asked).
//
// The TPU kernel turned the scatter into a one-hot matmul on the MXU
// because the TPU has no fast scatter; that does ~n_bins times the work.
// Hopper has fast shared-memory atomics, so this kernel is the scatter:
//
//   * grid (feature, row chunk, slot chunk), feature fastest: the F blocks
//     of one row chunk run together and read that chunk's node ids and
//     stats from L2, not from HBM F times over. A slot is one (node, bin)
//     pair, slot = node * n_bins + bin; a slot chunk is as many slots as
//     fit 3 f32 each in the block's dynamic shared memory (up to 227 KB
//     on H100, raised with cudaFuncSetAttribute). 16 nodes x 255 bins =
//     4,080 slots = 49 KB take one chunk; deeper levels and uint16 bins
//     take several, and each block skips the rows outside its chunk.
//   * body: zero the shared histogram; stride over the chunk's rows, four
//     rows per thread per step with their loads issued before the first
//     atomic; atomicAdd (g, h, w) into the row's shared slot; synchronise;
//     flush the non-zero slots into the output with global atomicAdd.
//     Offsets are 64-bit (n * F reaches 3e8 at HIGGS scale).
//   * rows whose node id or bin is out of range are dropped (the wrapper
//     cannot check values without stalling the card).
//
// Numbers. Counts are exact: w is 0/1 and every count is below 2^24. The
// g and h sums are taken in an order that changes from run to run (the
// atomics), so they are not bitwise reproducible; each block sums at most
// 131072 rows of one feature before its one flush, which keeps the f32
// rounding error near the one of a two-level sum. A deterministic,
// fixed-order mode is later work (it matters once shards must agree).
//
// What bounds it on this card: bytes, in principle. Each input read once
// and the output written once is n*F*itemsize + n*(4 + 12) +
// n_nodes*F*n_bins*12 bytes; at n = 11M, F = 28, uint8 and 16 nodes that is
// ~485 MB, ~0.145 ms at 3.35 TB/s. In practice the n*F*3 shared-memory
// atomics (~0.92 G per level at that shape) and the F-fold re-reads of
// node ids and stats from L2 set the pace. A low-cardinality feature
// (2-3 bins) sends a warp's lanes to the same slot and serialises them;
// warp-aggregated or per-warp sub-histograms are later work, as are
// vectorised bin loads.
//
// Build: mmlspark_tpu_torch/utils/cuda_build.py runs nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC on this file.
// Interface: plain C, loaded with ctypes; the entry returns the launch's
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr long long kMaxRowsPerBlock = 131072;
constexpr long long kMinRowsPerBlock = 8192;

// B: uint8_t or uint16_t (the raw bits of the 2-byte layout)
template <typename B>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const B* __restrict__ bins, const int32_t* __restrict__ node,
            const float* __restrict__ g, const float* __restrict__ h,
            const float* __restrict__ w, float* __restrict__ out,
            long long n, int F, int n_nodes, int n_bins, int n_slots,
            int chunk_slots, long long rows_per_block) {
  extern __shared__ float sh[];                  // (ns, 3), slot-major
  const int f = blockIdx.x;
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const int s0 = blockIdx.z * chunk_slots;
  const int ns = min(n_slots - s0, chunk_slots);
  for (int i = threadIdx.x; i < 3 * ns; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const B* col = bins + (long long)f * n;
  const long long step = (long long)blockDim.x * kUnroll;
  for (long long base = r0 + threadIdx.x; base < r1; base += step) {
    int rel[kUnroll];
    float gv[kUnroll], hv[kUnroll], wv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long r = base + (long long)k * blockDim.x;
      rel[k] = -1;
      gv[k] = hv[k] = wv[k] = 0.f;
      if (r < r1) {
        const unsigned b = (unsigned)col[r];
        const unsigned nd = (unsigned)node[r];
        if (b < (unsigned)n_bins && nd < (unsigned)n_nodes) {
          const int s = (int)(nd * (unsigned)n_bins + b) - s0;
          if (s >= 0 && s < ns) {
            rel[k] = s;
            gv[k] = g[r];
            hv[k] = h[r];
            wv[k] = w[r];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (rel[k] >= 0) {
        float* p = sh + 3 * rel[k];
        atomicAdd(p, gv[k]);
        atomicAdd(p + 1, hv[k]);
        atomicAdd(p + 2, wv[k]);
      }
    }
  }
  __syncthreads();

  // flush: out[node, f, bin, :] += sh[slot, :] for the non-zero slots
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int slot = s0 + i;
    const int nd = slot / n_bins;
    const int b = slot - nd * n_bins;
    float* o = out + (((long long)nd * F + f) * n_bins + b) * 3;
    const float* p = sh + 3 * i;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (p[k] != 0.f) atomicAdd(o + k, p[k]);
    }
  }
}

template <typename B>
cudaError_t launch(const void* bins, const int32_t* node, const float* g,
                   const float* h, const float* w, float* out, long long n,
                   int F, int n_nodes, int n_bins, cudaStream_t stream) {
  if (n <= 0 || F <= 0 || n_nodes <= 0 || n_bins <= 0)
    return cudaErrorInvalidValue;
  const long long slots64 = (long long)n_nodes * n_bins;
  if (slots64 >= (1LL << 31)) return cudaErrorInvalidValue;
  const int n_slots = (int)slots64;

  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;

  // slot chunks of equal size, each within the shared-memory limit
  const int max_slots = optin / (3 * (int)sizeof(float));
  const int n_chunks = (n_slots + max_slots - 1) / max_slots;
  const int chunk_slots = (n_slots + n_chunks - 1) / n_chunks;
  const size_t smem = (size_t)chunk_slots * 3 * sizeof(float);
  auto kern = hist_kernel<B>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }

  // rows per block: many, so that each slot sums many rows before its one
  // global flush; fewer when that would leave SMs idle
  long long rows = kMaxRowsPerBlock;
  auto blocks = [&](long long r) {
    return (long long)F * ((n + r - 1) / r) * n_chunks;
  };
  while (rows > kMinRowsPerBlock && blocks(rows) < 2LL * sms) rows /= 2;
  const long long row_blocks = (n + rows - 1) / rows;
  if (row_blocks > 65535 || n_chunks > 65535) return cudaErrorInvalidValue;

  dim3 grid((unsigned)F, (unsigned)row_blocks, (unsigned)n_chunks);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const B*>(bins), node, g, h, w, out, n, F, n_nodes, n_bins,
      n_slots, chunk_slots, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6. bin_bytes: 1 (uint8 bins) or 2 (uint16 bits). bins (F, n); node
// (n,) int32; g, h, w (n,) float32; out (n_nodes, F, n_bins, 3) float32,
// zeroed by the caller and accumulated into. Returns cudaError_t.
int mmlspark_level_histogram(int bin_bytes, const void* bins,
                             const void* node, const void* g, const void* h,
                             const void* w, void* out, long long n, int F,
                             int n_nodes, int n_bins, void* stream) {
  const int32_t* nd = static_cast<const int32_t*>(node);
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return int(launch<uint8_t>(bins, nd, gf, hf, wf, o, n, F, n_nodes,
                               n_bins, s));
  if (bin_bytes == 2)
    return int(launch<uint16_t>(bins, nd, gf, hf, wf, o, n, F, n_nodes,
                                n_bins, s));
  return int(cudaErrorInvalidValue);
}

const char* mmlspark_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
