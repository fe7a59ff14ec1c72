// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm,
// body _rmsnorm_kernel): per row of x (rows, D),
//     y = (x * rsqrt(mean(x^2) + eps)) * w
// in f32, written in x's type.  x is f32 or bf16, w (D,) f32 or bf16.
//
// Bound: bytes.  The function reads x once and writes y once (w is D
// values, shared by every row): at qwen1.5-4b prefill (8,192 x 2,560
// bf16) that is 84 MB, 25 us at the H100's 3.35 TB/s; two FLOPs per
// element are nothing beside it.  Design: one warp per row, 8 rows per
// block.  Pass 1 sums the squares in f32 with 16-byte loads (8 values a
// lane), pass 2 reads the row again (from L1/L2: a row is 5 KB at
// D = 2,560) and writes y with 16-byte stores, so device memory sees x
// once.  The sum is a lane-local sum and a butterfly over the warp, in
// another order than XLA's: results agree to rounding, not bit for bit.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;

  float ss = 0.f;
  for (int i = lane * 8; i < d; i += 32 * 8) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(kFull, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

  for (int i = lane * 8; i < d; i += 32 * 8) {
    float v[8], g[8];
    load8(xr + i, v);
    load8(w + i, g);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] * r) * g[j];
    store8(yr + i, v);
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rmsnorm_kernel<TX, TW><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (rows, d) contiguous, 16-byte aligned, d a multiple of 8;
// w: (d,).  x_bf16 / w_bf16: 1 for bf16, 0 for f32; y has x's type.
int rmsnorm_launch(const void* x, const void* w, void* y, long long rows,
                   int d, float eps, int x_bf16, int w_bf16, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  return launch<float, float>(x, w, y, rows, d, eps, s);
}

}  // extern "C"
