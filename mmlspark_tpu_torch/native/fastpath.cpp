/* The port's native host loops: quantile binning of a dense float matrix,
 * and VW's feature hashing and sparse padding.
 *
 * Copies of the `bin_columns`, `murmur3`, `murmur3_batch` and `pad_sparse`
 * loops of the JAX package's native/fastpath.cpp (the loops themselves are
 * unchanged, so their outputs are bitwise the same), bound through plain C
 * entry points and ctypes instead of the CPython/numpy C API: building
 * them needs g++ alone, no Python or numpy headers. The Python wrappers
 * (native/__init__.py) flatten object rows into offsets plus flat arrays.
 * The package's other native loops (parse_libsvm, stack_rows) are not
 * copied until a ported path needs them.
 *
 *   mmlspark_bin_columns(X[n,F] f32|f64, bounds[F,L] f64, lengths[F] i64,
 *                        out[n,F] u8|u16)
 *   mmlspark_murmur3(data, len, seed) -> u32
 *   mmlspark_murmur3_batch(flat bytes, offsets[n+1] i64, n, seed, mask,
 *                          out[n] u32)
 *   mmlspark_pad_sparse(idx flat i64, idx offsets[n+1], val flat f32,
 *                       val offsets[n+1], n, K, idx_out[n,K] i32,
 *                       val_out[n,K] f32)
 *
 * Per element: out = searchsorted(bounds_j[:lengths_j], x, "left") + 1,
 * NaN -> 0 (the missing bin). This is the dataset-construction loop
 * LightGBM runs in native code (LGBM_DatasetCreateFromMat); numpy's
 * per-column searchsorted pays a dependent-load binary search per
 * element, this loop narrows the search through a per-feature lookup
 * table first.
 *
 * Build: mmlspark_tpu_torch/native/__init__.py runs
 * g++ -O3 -shared -fPIC -std=c++17 on this file at first use.
 */

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// numpy's index type, kept so the loop reads as it does in the JAX package
typedef int64_t npy_intp;

/* branchless lower_bound (cmov per halving step, no mispredicts): index of
 * the first bound >= v == count of bounds < v. */
static inline int64_t lb_branchless(const double* a, int64_t n, double v) {
  if (n <= 0) return 0;
  const double* base = a;
  while (n > 1) {
    int64_t half = n >> 1;
    base = (base[half - 1] < v) ? base + half : base;
    n -= half;
  }
  return (base - a) + (*base < v);
}

/* Interpolation LUT over one feature's bounds: quantile bounds spread the
 * data ~uniformly, so a uniform-in-value bucket table narrows the search
 * range to O(1) bounds for almost every element, replacing the 8-step
 * dependent-load binary search with one LUT load and a 1-2 step search.
 * lut[i] = count of bounds < edge_i; for v in bucket i the answer lies in
 * [lut[i], lut[i+1]], widened by one bucket each side to absorb fp
 * rounding in the bucket computation. */
struct BinLut {
  static const int kBuckets = 1024;
  uint16_t lut[kBuckets + 1];
  double lo, scale;
  bool usable;

  void build(const double* b, int64_t lj) {
    usable = false;
    if (lj < 4 || lj > 65000) return;
    /* last bound is +inf by construction; interpolate over finite range */
    double fin_hi = b[lj - 2];
    if (!std::isfinite(b[0]) || !std::isfinite(fin_hi) || !(fin_hi > b[0]))
      return;
    lo = b[0];
    scale = (double)kBuckets / (fin_hi - lo);
    if (!std::isfinite(scale) || scale <= 0) return;
    for (int i = 0; i < kBuckets; i++) {
      double edge = lo + (double)i / scale;
      lut[i] = (uint16_t)lb_branchless(b, lj, edge);
    }
    /* values at/above the last finite bound must still find the top bins
     * (incl. the +inf cap), so the final range end is lj, not a count */
    lut[kBuckets] = (uint16_t)lj;
    usable = true;
  }

  inline int64_t find(const double* b, int64_t lj, double v) const {
    /* clamp in double space BEFORE the cast: (int64_t)inf is UB (x86
     * yields INT64_MIN, sending +inf values to bucket 0) */
    double t = (v - lo) * scale;
    int64_t bk;
    if (!(t > 0.0)) bk = 0;
    else if (t >= (double)(kBuckets - 1)) bk = kBuckets - 1;
    else bk = (int64_t)t;
    int64_t s = lut[bk > 0 ? bk - 1 : 0];
    int64_t e = lut[bk + 2 <= kBuckets ? bk + 2 : kBuckets];
    return s + lb_branchless(b + s, e - s, v);
  }
};

template <typename XT, typename OT>
static void bin_columns_loop(const XT* x, const double* bounds,
                             const int64_t* lengths, OT* out,
                             npy_intp n, npy_intp F, npy_intp L) {
  /* row-block x feature tiling: one feature's bounds + LUT stay
   * L1-resident for the whole inner row loop; the X/out blocks stay
   * L2-resident across features. */
  std::vector<BinLut> luts((size_t)F);
  for (npy_intp j = 0; j < F; j++) luts[(size_t)j].build(bounds + j * L,
                                                         lengths[j]);
  const npy_intp RB = 8192;
  for (npy_intp r0 = 0; r0 < n; r0 += RB) {
    npy_intp r1 = r0 + RB < n ? r0 + RB : n;
    for (npy_intp j = 0; j < F; j++) {
      const double* b = bounds + j * L;
      const int64_t lj = lengths[j];
      const BinLut& lut = luts[(size_t)j];
      if (lut.usable) {
        for (npy_intp r = r0; r < r1; r++) {
          double v = (double)x[r * F + j];
          if (std::isnan(v)) { out[r * F + j] = 0; continue; }
          /* values beyond the finite range short-circuit: below the first
           * bound -> bin 1; at/above the last finite bound the only
           * remaining candidates are the top two bounds */
          int64_t c;
          if (v <= lut.lo) c = (b[0] < v);
          else c = lut.find(b, lj, v);
          out[r * F + j] = (OT)(c + 1);
        }
      } else {
        for (npy_intp r = r0; r < r1; r++) {
          double v = (double)x[r * F + j];
          if (std::isnan(v)) { out[r * F + j] = 0; continue; }
          out[r * F + j] = (OT)(lb_branchless(b, lj, v) + 1);
        }
      }
    }
  }
}

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

/* MurmurHash3 x86_32, as the JAX package's loop computes it. */
static uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
  uint32_t h = seed;
  const size_t nblocks = len / 4;
  for (size_t i = 0; i < nblocks; i++) {
    uint32_t k;
    std::memcpy(&k, data + 4 * i, 4);
    k *= c1; k = rotl32(k, 15); k *= c2;
    h ^= k; h = rotl32(h, 13); h = h * 5 + 0xe6546b64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= (uint32_t)tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= (uint32_t)tail[1] << 8;  [[fallthrough]];
    case 1: k1 ^= (uint32_t)tail[0];
            k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h ^= k1;
  }
  h ^= (uint32_t)len;
  h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13; h *= 0xc2b2ae35u; h ^= h >> 16;
  return h;
}

extern "C" {

uint32_t mmlspark_murmur3(const uint8_t* data, int64_t len, uint32_t seed) {
  return murmur3_32(data, (size_t)len, seed);
}

/* Item i is flat[offsets[i] : offsets[i + 1]]; out[i] = hash & mask. */
void mmlspark_murmur3_batch(const uint8_t* flat, const int64_t* offsets,
                            int64_t n, uint32_t seed, uint32_t mask,
                            uint32_t* out) {
  for (int64_t i = 0; i < n; i++)
    out[i] = murmur3_32(flat + offsets[i],
                        (size_t)(offsets[i + 1] - offsets[i]), seed) & mask;
}

/* Row r's indices are idx[ioff[r] : ioff[r + 1]] and its values
 * val[voff[r] : voff[r + 1]]; each row fills min(len idx, len val, K)
 * slots of its K (a malformed row is clamped, never read past its
 * values), the indices cast to int32 as the JAX package's loop casts
 * them. The caller zeroes the outputs (padding: index 0, value 0). */
void mmlspark_pad_sparse(const int64_t* idx, const int64_t* ioff,
                         const float* val, const int64_t* voff, int64_t n,
                         int64_t K, int32_t* idx_out, float* val_out) {
  for (int64_t r = 0; r < n; r++) {
    int64_t k = ioff[r + 1] - ioff[r];
    int64_t kv = voff[r + 1] - voff[r];
    if (kv < k) k = kv;
    if (k > K) k = K;
    const int64_t* si = idx + ioff[r];
    const float* sv = val + voff[r];
    for (int64_t j = 0; j < k; j++) {
      idx_out[r * K + j] = (int32_t)si[j];
      val_out[r * K + j] = sv[j];
    }
  }
}

/* Returns 0, or 1 when a length is outside [1, L]. x_f64: X is float64
 * (else float32); out_u16: out is uint16 (else uint8). All arrays are
 * C-contiguous; the caller allocates out. */
int mmlspark_bin_columns(const void* x, int x_f64, const double* bounds,
                         const int64_t* lengths, void* out, int out_u16,
                         int64_t n, int64_t F, int64_t L) {
  for (int64_t j = 0; j < F; j++)
    if (lengths[j] < 1 || lengths[j] > L) return 1;
  if (x_f64) {
    if (out_u16)
      bin_columns_loop((const double*)x, bounds, lengths, (uint16_t*)out, n,
                       F, L);
    else
      bin_columns_loop((const double*)x, bounds, lengths, (uint8_t*)out, n,
                       F, L);
  } else {
    if (out_u16)
      bin_columns_loop((const float*)x, bounds, lengths, (uint16_t*)out, n,
                       F, L);
    else
      bin_columns_loop((const float*)x, bounds, lengths, (uint8_t*)out, n,
                       F, L);
  }
  return 0;
}

}  // extern "C"
