// Fused error-feedback block compression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ef_topk.py:
//   * ef_stats_telemetry (_ef_stats_telemetry_kernel + _kth_largest):
//     per 1024-wide block row, tau = k_b-th largest |m + eta*g| and the
//     moments [sum g^2, sum acc^2];
//   * ef_block_stats (_ef_block_stats_kernel): the same tau, no moments;
//   * block_stats (_block_stats_kernel): tau = k_b-th largest |x| of a
//     single input (the single-node compress_dense path);
//   * ef_apply (_ef_apply_kernel): acc = m + eta*g,
//     sent = acc * [|acc| >= tau_row], m' = acc - sent;
//   * threshold_split (_threshold_split_kernel): sent = x * [|x| >= tau_row],
//     residual = x - sent.
//
// Bytes per element: the pass-1 kernels read m and g (8 B) or x alone
// (4 B) once and write 4 B (12 B with moments) per row; ef_apply reads
// 8 B and writes 8 B, threshold_split reads 4 B and writes 8 B.  Every
// pass-1 kernel gives each row to one warp that keeps the row's 1024
// magnitudes in registers (32 per lane, 16-byte loads).
//
// The three pass-1 kernels share one select by value (select_kth).
// Every caller uses only tau, the value of the k_b-th largest magnitude
// (ef_apply keeps |acc| >= tau), and that value does not depend on which
// of several tied elements a knock-out round would take, so no column is
// kept.  The sign-cleared bit pattern of a non-NaN magnitude orders like
// its value as a uint32 (+0 lowest, +inf 0x7f800000 above every finite
// value), so the select runs on integers and is exact:
//   * the general path sets tau's bits from the top down, one warp count
//     (__reduce_add_sync) per bit over all 32 values a lane: at most 31
//     counts whatever k_b;
//   * the filter, for k_b <= 128, first bounds tau from below by L, the
//     k_b-th largest of the maxima of each lane's J groups of slots
//     (J = 1, 4, 8 for k_b <= 32, 64, 128), cut to its top 16 bits: k_b
//     distinct elements are >= L.  When the c elements >= L number at
//     most kCap (256), the warp compacts them into its slice of shared
//     memory and selects among them: for c <= 32 each lane ranks its one
//     candidate against all c, else the bitwise select runs over c / 32
//     values a lane instead of 32.  Otherwise (ties at the top,
//     near-constant rows) it takes the general path from L.
// Neither path's cost grows with k_b.  On Gaussian rows the filter keeps
// about 12, 49 and 123 candidates at k_b = 10, 41 and 102, and the bytes
// bound the kernels: on one H100 80GB HBM3 at 700 W (PERF.md §6) the
// device time is 1.2x the byte bound at k_b = 10 and 1.6x at 102 for
// block_stats, 1.07x and 1.22x for ef_stats_telemetry, 1.05x and 1.08x
// for ef_block_stats.  The warps share no barrier, so a warp past the
// last row returns at once.
//
// NaN rule: a row holding a NaN magnitude gets tau = NaN, as the TPU
// kernel gives it (its per-round max propagates NaN and then knocks
// nothing out); no selection runs for such a row.  A NaN's pattern lies
// above +inf's, so the row's largest pattern tells; for the EF pair that
// includes the NaN that inf - inf gives in the fma.  Infinities rank
// like any other value.
//
// acc is formed with an explicit fused multiply-add, __fmaf_rn(eta, g, m):
// the JAX reference computes m + eta*g with one rounding, and a separate
// multiply and add differ from it in the last bit for about a fifth of
// the elements.  eta is read from device memory, so no host sync is
// needed between the Armijo search and the compression.
//
// The moments are accumulated in double (each f32 square is exact there)
// and rounded once, so they sit within an ulp of the exact sums; the f32
// reference sums differ from them by their own rounding, a few ulp.  They
// are summed and written before the select, so the two f64 sums are dead
// during it.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 1024;
constexpr int kPerLane = kCols / 32;      // 32 magnitudes per lane
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAbs = 0x7fffffffu;   // clears the sign bit
constexpr unsigned kInf = 0x7f800000u;   // |x| above this is NaN
constexpr int kCap = 256;                // candidates a warp compacts

// The largest t, a multiple of 2^stop, with #{v >= t} >= k over the
// warp's N values a lane, given lo <= the k-th largest <= hi; with stop
// 0 that is the k-th largest itself.  Every value in [lo, hi] shares the
// bits above the highest bit where lo and hi differ, so t starts from
// them; each lower bit is kept when the count at it still reaches k.
// Values may be zero padding: every count is taken at a t of at least
// 1.  Warp-uniform: k, lo, hi and stop are.
template <int N>
__device__ __forceinline__ unsigned kth_by_bits(const unsigned (&v)[N],
                                                int k, unsigned lo,
                                                unsigned hi, int stop = 0) {
  const unsigned diff = lo ^ hi;
  if (diff == 0) return lo;
  const int top = 31 - __clz(diff);        // <= 30: bit 31 is clear
  unsigned t = lo & ~((2u << top) - 1u);
  for (int b = top; b >= stop; --b) {
    const unsigned tb = t | (1u << b);
    int n = 0;
#pragma unroll
    for (int s = 0; s < N; ++s) n += v[s] >= tb;
    if (__reduce_add_sync(kFull, n) >= k) t = tb;
  }
  return t;
}

// The filter's bound L: the k-th largest of the maxima of the lanes' J
// groups of 32 / J slots (k <= 32 J), its bits below 2^16 cleared.  k
// distinct elements are >= L, so L <= the row's k-th largest.  Only
// exponent and 7 mantissa bits are searched: the candidates >= L gain
// the few within 1/128 of a binade below it, and the search is 8 or so
// counts instead of 24.
template <int J>
__device__ __forceinline__ unsigned filter_bound(const unsigned (&u)[kPerLane],
                                                 int k, unsigned hi) {
  unsigned gmax[J];
#pragma unroll
  for (int i = 0; i < J; ++i) gmax[i] = 0u;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s)
    gmax[s / (kPerLane / J)] = max(gmax[s / (kPerLane / J)], u[s]);
  unsigned lo = gmax[0];
#pragma unroll
  for (int i = 1; i < J; ++i) lo = min(lo, gmax[i]);
  return kth_by_bits<J>(gmax, k, __reduce_min_sync(kFull, lo), hi, 16);
}

// The k-th largest of the c <= 32 N candidates in shared memory.
template <int N>
__device__ __forceinline__ unsigned select_candidates(const unsigned* cand,
                                                      int c, int k,
                                                      unsigned lo,
                                                      unsigned hi) {
  const int lane = threadIdx.x & 31;
  unsigned v[N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int i = s * 32 + lane;
    v[s] = i < c ? cand[i] : 0u;
  }
  return kth_by_bits<N>(v, k, lo, hi);
}

// The select shared by the pass-1 kernels (see the note at the top of
// this file): tau, the k_b-th largest of the row's 1024 sign-cleared
// patterns, 32 a lane in u (slot 4c + j: column (c*32 + lane)*4 + j), or
// NaN for a row holding a NaN.  mine: the warp's kCap slots of shared
// memory.  Called by the whole warp.
__device__ __forceinline__ float select_kth(const unsigned (&u)[kPerLane],
                                            int k_b, unsigned* mine) {
  const int lane = threadIdx.x & 31;
  unsigned lane_max = 0u;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) lane_max = max(lane_max, u[s]);
  // a NaN's pattern lies above +inf's, so the row's largest pattern
  // tells whether the row holds one
  const unsigned hi = __reduce_max_sync(kFull, lane_max);

  float kth = NAN;
  if (hi <= kInf) {
    unsigned lo = 0u, t = 0u;
    bool done = false;
    if (k_b <= 128) {
      lo = k_b <= 32   ? filter_bound<1>(u, k_b, hi)
           : k_b <= 64 ? filter_bound<4>(u, k_b, hi)
                       : filter_bound<8>(u, k_b, hi);
      int n = 0;
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) n += u[s] >= lo;
      const int c = __reduce_add_sync(kFull, n);
      if (c <= kCap) {
        int at = n;      // inclusive prefix of the lanes' counts
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(kFull, at, d);
          if (lane >= d) at += up;
        }
        at -= n;
#pragma unroll
        for (int s = 0; s < kPerLane; ++s) {
          if (u[s] >= lo) mine[at++] = u[s];
        }
        __syncwarp();
        if (c <= 32) {   // one candidate a lane: the one ranked k-th
          const unsigned mv = lane < c ? mine[lane] : 0u;
          int gt = 0, ge = 0;
          for (int i = 0; i < c; ++i) {
            const unsigned w = mine[i];
            gt += w > mv;
            ge += w >= mv;
          }
          const unsigned hit =
              __ballot_sync(kFull, lane < c && gt < k_b && k_b <= ge);
          t = __shfl_sync(kFull, mv, __ffs(hit) - 1);
        } else {
          t = c <= 64    ? select_candidates<2>(mine, c, k_b, lo, hi)
              : c <= 128 ? select_candidates<4>(mine, c, k_b, lo, hi)
                         : select_candidates<8>(mine, c, k_b, lo, hi);
        }
        done = true;
      }
    }
    if (!done) t = kth_by_bits<kPerLane>(u, k_b, lo, hi);
    kth = __uint_as_float(t);
  }
  return kth;
}

// The EF pass-1 body: one warp per block row, the patterns of
// |fma(eta, g, m)|.  kMoments: also write [sum g^2, sum acc^2] per row.
template <bool kMoments>
__device__ __forceinline__ void pass1_row(const float* __restrict__ m,
                                          const float* __restrict__ g,
                                          const float* __restrict__ eta_ptr,
                                          float* __restrict__ tau,
                                          float* __restrict__ moments,
                                          long long rows, int k_b,
                                          unsigned (*cand)[kCap]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // no barrier below: warps are independent
  const float4* m4 = reinterpret_cast<const float4*>(m + row * kCols);
  const float4* g4 = reinterpret_cast<const float4*>(g + row * kCols);
  const float eta = *eta_ptr;

  unsigned u[kPerLane];   // slot 4c + j: column (c*32 + lane)*4 + j
  double sum_g = 0.0, sum_acc = 0.0;
#pragma unroll
  for (int c = 0; c < kPerLane / 4; ++c) {
    float4 v = m4[c * 32 + lane];
    const float4 gv = g4[c * 32 + lane];
    v.x = __fmaf_rn(eta, gv.x, v.x);
    v.y = __fmaf_rn(eta, gv.y, v.y);
    v.z = __fmaf_rn(eta, gv.z, v.z);
    v.w = __fmaf_rn(eta, gv.w, v.w);
    if constexpr (kMoments) {
      sum_g = fma((double)gv.x, (double)gv.x, sum_g);
      sum_g = fma((double)gv.y, (double)gv.y, sum_g);
      sum_g = fma((double)gv.z, (double)gv.z, sum_g);
      sum_g = fma((double)gv.w, (double)gv.w, sum_g);
      sum_acc = fma((double)v.x, (double)v.x, sum_acc);
      sum_acc = fma((double)v.y, (double)v.y, sum_acc);
      sum_acc = fma((double)v.z, (double)v.z, sum_acc);
      sum_acc = fma((double)v.w, (double)v.w, sum_acc);
    }
    u[4 * c + 0] = __float_as_uint(v.x) & kAbs;
    u[4 * c + 1] = __float_as_uint(v.y) & kAbs;
    u[4 * c + 2] = __float_as_uint(v.z) & kAbs;
    u[4 * c + 3] = __float_as_uint(v.w) & kAbs;
  }
  if constexpr (kMoments) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum_g += __shfl_xor_sync(kFull, sum_g, off);
      sum_acc += __shfl_xor_sync(kFull, sum_acc, off);
    }
    if (lane == 0) {
      moments[2 * row + 0] = (float)sum_g;
      moments[2 * row + 1] = (float)sum_acc;
    }
  }
  const float kth = select_kth(u, k_b, cand[warp]);
  if (lane == 0) tau[row] = kth;
}

// One kernel name per entry point, so that a trace names the TPU kernel
// each one replaces.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ef_stats_telemetry_kernel(const float* __restrict__ m,
                          const float* __restrict__ g,
                          const float* __restrict__ eta,
                          float* __restrict__ tau,
                          float* __restrict__ moments, long long rows,
                          int k_b) {
  __shared__ unsigned cand[kWarpsPerBlock][kCap];
  pass1_row<true>(m, g, eta, tau, moments, rows, k_b, cand);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ef_block_stats_kernel(const float* __restrict__ m,
                      const float* __restrict__ g,
                      const float* __restrict__ eta,
                      float* __restrict__ tau, long long rows, int k_b) {
  __shared__ unsigned cand[kWarpsPerBlock][kCap];
  pass1_row<false>(m, g, eta, tau, nullptr, rows, k_b, cand);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_stats_kernel(const float* __restrict__ x, float* __restrict__ tau,
                   long long rows, int k_b) {
  __shared__ unsigned cand[kWarpsPerBlock][kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // no barrier below: warps are independent
  const uint4* x4 = reinterpret_cast<const uint4*>(x + row * kCols);

  unsigned u[kPerLane];   // slot 4c + j: column (c*32 + lane)*4 + j
#pragma unroll
  for (int c = 0; c < kPerLane / 4; ++c) {
    const uint4 v = x4[c * 32 + lane];
    u[4 * c + 0] = v.x & kAbs;
    u[4 * c + 1] = v.y & kAbs;
    u[4 * c + 2] = v.z & kAbs;
    u[4 * c + 3] = v.w & kAbs;
  }
  const float kth = select_kth(u, k_b, cand[warp]);
  if (lane == 0) tau[row] = kth;
}

// sent + rest == x exactly: rest is x - x or x - 0.
__device__ __forceinline__ void split(float x, float t, float& sent,
                                      float& rest) {
  sent = fabsf(x) >= t ? x : 0.f;
  rest = __fsub_rn(x, sent);
}

// One block of 256 threads per row, one float4 per thread; the row's tau
// is one broadcast load per block.
__global__ void __launch_bounds__(kCols / 4)
ef_apply_kernel(const float* __restrict__ m, const float* __restrict__ g,
                const float* __restrict__ eta_ptr,
                const float* __restrict__ tau, float* __restrict__ sent,
                float* __restrict__ mnew, long long rows) {
  const float eta = *eta_ptr;
  const float4* m4 = reinterpret_cast<const float4*>(m);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* s4 = reinterpret_cast<float4*>(sent);
  float4* n4 = reinterpret_cast<float4*>(mnew);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float t = tau[row];
    const long long i = row * (kCols / 4) + threadIdx.x;
    const float4 mv = m4[i];
    const float4 gv = g4[i];
    float4 sv, nv;
    split(__fmaf_rn(eta, gv.x, mv.x), t, sv.x, nv.x);
    split(__fmaf_rn(eta, gv.y, mv.y), t, sv.y, nv.y);
    split(__fmaf_rn(eta, gv.z, mv.z), t, sv.z, nv.z);
    split(__fmaf_rn(eta, gv.w, mv.w), t, sv.w, nv.w);
    s4[i] = sv;
    n4[i] = nv;
  }
}

// The single-input split: one block of 256 threads per row, one float4
// per thread, the row's tau one broadcast load per block.
__global__ void __launch_bounds__(kCols / 4)
threshold_split_kernel(const float* __restrict__ x,
                       const float* __restrict__ tau,
                       float* __restrict__ sent, float* __restrict__ resid,
                       long long rows) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* s4 = reinterpret_cast<float4*>(sent);
  float4* r4 = reinterpret_cast<float4*>(resid);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float t = tau[row];
    const long long i = row * (kCols / 4) + threadIdx.x;
    const float4 xv = x4[i];
    float4 sv, rv;
    split(xv.x, t, sv.x, rv.x);
    split(xv.y, t, sv.y, rv.y);
    split(xv.z, t, sv.z, rv.z);
    split(xv.w, t, sv.w, rv.w);
    s4[i] = sv;
    r4[i] = rv;
  }
}

unsigned stats_blocks(long long rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

unsigned split_blocks(long long rows) {
  return (unsigned)(rows < (1LL << 20) ? rows : (1LL << 20));
}

}  // namespace

extern "C" int ef_stats_telemetry_launch(const float* m, const float* g,
                                         const float* eta, float* tau,
                                         float* moments, long long rows,
                                         int k_b, void* stream) {
  if (rows > 0) {
    ef_stats_telemetry_kernel<<<stats_blocks(rows), kWarpsPerBlock * 32, 0,
                                (cudaStream_t)stream>>>(m, g, eta, tau,
                                                        moments, rows, k_b);
  }
  return (int)cudaGetLastError();
}

extern "C" int ef_block_stats_launch(const float* m, const float* g,
                                     const float* eta, float* tau,
                                     long long rows, int k_b, void* stream) {
  if (rows > 0) {
    ef_block_stats_kernel<<<stats_blocks(rows), kWarpsPerBlock * 32, 0,
                            (cudaStream_t)stream>>>(m, g, eta, tau, rows,
                                                    k_b);
  }
  return (int)cudaGetLastError();
}

extern "C" int block_stats_launch(const float* x, float* tau, long long rows,
                                  int k_b, void* stream) {
  if (rows > 0) {
    block_stats_kernel<<<stats_blocks(rows), kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(x, tau, rows, k_b);
  }
  return (int)cudaGetLastError();
}

extern "C" int ef_apply_launch(const float* m, const float* g,
                               const float* eta, const float* tau,
                               float* sent, float* mnew, long long rows,
                               void* stream) {
  if (rows > 0) {
    ef_apply_kernel<<<split_blocks(rows), kCols / 4, 0,
                      (cudaStream_t)stream>>>(m, g, eta, tau, sent, mnew,
                                              rows);
  }
  return (int)cudaGetLastError();
}

extern "C" int threshold_split_launch(const float* x, const float* tau,
                                      float* sent, float* resid,
                                      long long rows, void* stream) {
  if (rows > 0) {
    threshold_split_kernel<<<split_blocks(rows), kCols / 4, 0,
                             (cudaStream_t)stream>>>(x, tau, sent, resid,
                                                     rows);
  }
  return (int)cudaGetLastError();
}
