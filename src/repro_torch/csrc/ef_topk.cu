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
// 8 B and writes 8 B, threshold_split reads 4 B and writes 8 B.  The
// three pass-1 kernels share one templated body (pass1_row) and keep
// their own kernel names.  Design: pass 1 gives each row to one warp that
// keeps the row's 1024 magnitudes in registers (32 per lane), so its k_b
// rounds of a warp max-reduce never touch memory again; on an H100 these
// rounds, not the bytes, set its time at k_b = 10 (PERF.md).  The splits
// are streaming passes with 16-byte loads and stores.
//
// NaN rule: a row holding a NaN magnitude gets tau = NaN, as the TPU
// kernel gives it (its per-round max propagates NaN and then knocks
// nothing out); the rounds are skipped for such a row.  Infinities rank
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
// reference sums differ from them by their own rounding, a few ulp.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 1024;
constexpr int kPerLane = kCols / 32;      // 32 |acc| values per lane
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Column of register slot s of a lane: slot s = 4*c + j holds column
// (c*32 + lane)*4 + j, the j-th float of the lane's c-th float4.
__device__ __forceinline__ int slot_col(int s, int lane) {
  return ((s >> 2) * 32 + lane) * 4 + (s & 3);
}

// Lane-local maximum; the lowest slot wins ties, and slot order is
// column order within a lane.
__device__ __forceinline__ void lane_best(const float (&mag)[kPerLane],
                                          float& best, int& best_slot) {
  best = mag[0];
  best_slot = 0;
#pragma unroll
  for (int s = 1; s < kPerLane; ++s) {
    if (mag[s] > best) {
      best = mag[s];
      best_slot = s;
    }
  }
}

// The pass-1 body: one warp per block row.  kFromAcc: the magnitudes are
// |fma(eta, g, m)| (a = m), else |x| (a = x; g and eta unused).
// kMoments: also write [sum g^2, sum acc^2] per row.
template <bool kFromAcc, bool kMoments>
__device__ __forceinline__ void pass1_row(const float* __restrict__ a,
                                          const float* __restrict__ g,
                                          const float* __restrict__ eta_ptr,
                                          float* __restrict__ tau,
                                          float* __restrict__ moments,
                                          long long rows, int k_b) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps exit together
  const float4* a4 = reinterpret_cast<const float4*>(a + row * kCols);
  const float4* g4 = nullptr;
  float eta = 0.f;
  if constexpr (kFromAcc) {
    g4 = reinterpret_cast<const float4*>(g + row * kCols);
    eta = *eta_ptr;
  }

  float mag[kPerLane];
  double sum_g = 0.0, sum_acc = 0.0;
  bool has_nan = false;
#pragma unroll
  for (int c = 0; c < kPerLane / 4; ++c) {
    float4 v = a4[c * 32 + lane];
    if constexpr (kFromAcc) {
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
    }
    mag[4 * c + 0] = fabsf(v.x);
    mag[4 * c + 1] = fabsf(v.y);
    mag[4 * c + 2] = fabsf(v.z);
    mag[4 * c + 3] = fabsf(v.w);
    has_nan |= isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
  }

  float kth = NAN;
  if (!__any_sync(kFull, has_nan)) {
    // k_b rounds: the warp's largest remaining (value, column) pair,
    // lowest column on ties, is knocked out -- exactly one element per
    // round, as in _kth_largest, so duplicated magnitudes count like
    // lax.top_k's.
    float best;
    int best_slot;
    lane_best(mag, best, best_slot);
    for (int r = 0; r < k_b; ++r) {
      float v = best;
      int col = slot_col(best_slot, lane);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_xor_sync(kFull, v, off);
        const int c2 = __shfl_xor_sync(kFull, col, off);
        if (v2 > v || (v2 == v && c2 < col)) {
          v = v2;
          col = c2;
        }
      }
      kth = v;
      if (((col >> 2) & 31) == lane) {  // this lane owns the winner
        const int s = (col >> 7) * 4 + (col & 3);
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          if (t == s) mag[t] = -INFINITY;
        }
        lane_best(mag, best, best_slot);
      }
    }
  }

  if constexpr (kMoments) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum_g += __shfl_xor_sync(kFull, sum_g, off);
      sum_acc += __shfl_xor_sync(kFull, sum_acc, off);
    }
  }
  if (lane == 0) {
    tau[row] = kth;
    if constexpr (kMoments) {
      moments[2 * row + 0] = (float)sum_g;
      moments[2 * row + 1] = (float)sum_acc;
    }
  }
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
  pass1_row<true, true>(m, g, eta, tau, moments, rows, k_b);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ef_block_stats_kernel(const float* __restrict__ m,
                      const float* __restrict__ g,
                      const float* __restrict__ eta,
                      float* __restrict__ tau, long long rows, int k_b) {
  pass1_row<true, false>(m, g, eta, tau, nullptr, rows, k_b);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_stats_kernel(const float* __restrict__ x, float* __restrict__ tau,
                   long long rows, int k_b) {
  pass1_row<false, false>(x, nullptr, nullptr, tau, nullptr, rows, k_b);
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
