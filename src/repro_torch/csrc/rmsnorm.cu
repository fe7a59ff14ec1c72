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
// element are nothing beside it.
//
// Design: one warp per row, 4 warps a block.  The grid is one full wave:
// as many blocks as the card holds at once at the kernel's register
// count (queried once per instantiation), or fewer when there are fewer
// rows; each warp then walks the rows with a stride of the grid's warps.
// So 8,192 rows leave no partial wave of blocks behind, and the decode
// shape (4 rows) is one block with no idle warp.  Each lane owns the
// row's 8-value chunks lane, lane + 32, ... and issues all of its
// 16-byte loads of x before it reduces, keeping the raw values in
// registers (template NC: chunks a lane holds, 10 at D = 2,560, 8 at
// 2,048); it then sums the squares in f32, reduces over the warp with a
// butterfly, and writes y from the same registers, so each row is read
// from memory once and the loads of a row are all in flight together.
// w comes through the read-only path.  D up to 4,096 (16 chunks a lane)
// takes that kernel, which covers both serving models (2,048, 2,560) and
// the smoke widths; a wider row takes rmsnorm_stream_kernel, which reads
// the row twice (the second time from L1/L2) instead of holding it.
// The sum is a lane-local sum in chunk order and a butterfly over the
// warp, in another order than XLA's: results agree to rounding, not bit
// for bit.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxChunks = 16;      // chunks a lane holds: D <= 4,096
constexpr unsigned kFull = 0xffffffffu;

// 8 values of a row as they sit in memory: 16 bytes of bf16, 32 of f32
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 v; };
template <> struct Raw<float> { float4 a, b; };

__device__ __forceinline__ Raw<__nv_bfloat16> load_raw(
    const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}

__device__ __forceinline__ Raw<float> load_raw(const float* p) {
  return {reinterpret_cast<const float4*>(p)[0],
          reinterpret_cast<const float4*>(p)[1]};
}

__device__ __forceinline__ Raw<__nv_bfloat16> load_raw_ro(
    const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ Raw<float> load_raw_ro(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r,
                                       float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float v[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
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

__device__ __forceinline__ float warp_sum(float ss) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(kFull, ss, off);
  return ss;
}

// One pass: a lane holds NC chunks of 8 values (those past the row's
// d / 8 chunks are not loaded); a warp takes every (grid's warps)-th row.
template <typename TX, typename TW, int NC>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int chunks = d / 8;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < rows; row += (long long)gridDim.x * kWarps) {
    const TX* xr = x + row * d;
    TX* yr = y + row * d;

    Raw<TX> raw[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane + 32 * c < chunks) raw[c] = load_raw(xr + 8 * (lane + 32 * c));

    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lane + 32 * c < chunks) {
        float v[8];
        unpack(raw[c], v);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
      }
    }
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = 8 * (lane + 32 * c);
      if (i < d) {
        float v[8], g[8];
        unpack(raw[c], v);
        unpack(load_raw_ro(w + i), g);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (v[j] * r) * g[j];
        store8(yr + i, v);
      }
    }
  }
}

// Rows wider than kMaxChunks * 256 values: the same arithmetic, the row
// read twice.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_stream_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      TX* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;

  float ss = 0.f;
  for (int i = lane * 8; i < d; i += 32 * 8) {
    float v[8];
    unpack(load_raw(xr + i), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);

  for (int i = lane * 8; i < d; i += 32 * 8) {
    float v[8], g[8];
    unpack(load_raw(xr + i), v);
    unpack(load_raw_ro(w + i), g);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] * r) * g[j];
    store8(yr + i, v);
  }
}

// The one-pass kernel over a grid of one full wave (fewer blocks when
// the rows need fewer).
template <typename TX, typename TW, int NC>
void launch_one_pass(const TX* x, const TW* w, TX* y, long long rows, int d,
                     float eps, unsigned blocks, cudaStream_t stream) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rmsnorm_kernel<TX, TW, NC>, kWarps * 32, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned wave = (unsigned)(per_sm * (sms > 0 ? sms : 1));
  rmsnorm_kernel<TX, TW, NC><<<blocks < wave ? blocks : wave, kWarps * 32, 0,
                               stream>>>(x, w, y, rows, d, eps);
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  // chunks a lane must hold, rounded up to an instantiated count
  const int need = (d / 8 + 31) / 32;
  if (need <= 1)
    launch_one_pass<TX, TW, 1>(xp, wp, yp, rows, d, eps, blocks, stream);
  else if (need <= 2)
    launch_one_pass<TX, TW, 2>(xp, wp, yp, rows, d, eps, blocks, stream);
  else if (need <= 4)
    launch_one_pass<TX, TW, 4>(xp, wp, yp, rows, d, eps, blocks, stream);
  else if (need <= 8)
    launch_one_pass<TX, TW, 8>(xp, wp, yp, rows, d, eps, blocks, stream);
  else if (need <= 10)
    launch_one_pass<TX, TW, 10>(xp, wp, yp, rows, d, eps, blocks, stream);
  else if (need <= 12)
    launch_one_pass<TX, TW, 12>(xp, wp, yp, rows, d, eps, blocks, stream);
  else if (need <= kMaxChunks)
    launch_one_pass<TX, TW, kMaxChunks>(xp, wp, yp, rows, d, eps, blocks,
                                        stream);
  else
    rmsnorm_stream_kernel<TX, TW><<<blocks, kWarps * 32, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
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
