// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv_wkv.py
// (wkv_forward, body _wkv_kernel): per (batch, head), with the (K, V)
// state S on chip for the whole sequence, for t = 0 .. S-1
//     y_t = r_t (S + diag(u) k_t^T v_t)
//     S  <- diag(w_t) S + k_t^T v_t
// r, k, w: (B, S, H, K), v: (B, S, H, V), u: (H, K), s0: (B, H, K, V),
// all f32; y: (B, S, H, V) and the final state sT: (B, H, K, V), f32.
//
// Bound: the function reads r, k, v, w and s0 once and writes y and sT
// once (the state stays on chip): at rwkv6-1.6b prefill (4, 1024, 32,
// 64) that is 172 MB, 0.051 ms at 3.35 TB/s.  It needs 5 operations per
// state element per step (r S, one multiply-add; w S + k^T v, a multiply
// and a multiply-add), the u term being a scalar per step, (sum_k r u
// k) v: 2.73 GFLOP, 0.041 ms at the 67 TFLOP/s of f32, so bytes bound
// it.  The recurrence is serial in t, so the card runs only B x H =
// 128 blocks of 64 threads on its 132 SMs, one short dependent chain per
// step: the kernel is bound by that latency, far from either bound, and
// a chunked (parallel-in-t) form is the later redesign.
//
// Design: one block per (b, h), one thread per value column v, holding
// the state column S[:, v] (K values) in registers.  Chunks of 32 steps
// of r, k, w and v are staged in shared memory with coalesced loads, so
// the walk over t reads them as broadcasts; y_t is written by the V
// threads together (one coalesced row per step).  The sum over k of y_t
// runs in four interleaved partial sums to shorten the dependent chain;
// it is another order than the plain version's, so the two agree to
// rounding, not bit for bit.  Each state update is one fused
// multiply-add.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;      // time steps staged per pass
constexpr int kMaxV = 1024;

template <int K>
__global__ void wkv_forward_kernel(const float* __restrict__ r,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ w,
                                   const float* __restrict__ u,
                                   const float* __restrict__ s0,
                                   float* __restrict__ y,
                                   float* __restrict__ sT, int seq,
                                   int n_heads, int V) {
  extern __shared__ float smem[];
  float* r_s = smem;                     // [kChunk][K]
  float* k_s = r_s + kChunk * K;
  float* w_s = k_s + kChunk * K;
  float* u_s = w_s + kChunk * K;         // [K]
  float* v_s = u_s + K;                  // [kChunk][V]

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int col = threadIdx.x;
  const bool active = col < V;
  const long long step = (long long)n_heads * K;     // t stride of r, k, w
  const long long vstep = (long long)n_heads * V;    // t stride of v, y
  const float* rb = r + (long long)b * seq * step + h * K;
  const float* kb = k + (long long)b * seq * step + h * K;
  const float* wb = w + (long long)b * seq * step + h * K;
  const float* vb = v + (long long)b * seq * vstep + h * V;
  float* yb = y + (long long)b * seq * vstep + h * V;
  const long long state0 = (long long)bh * K * V;

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    S[i] = active ? s0[state0 + (long long)i * V + col] : 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) u_s[i] = u[h * K + i];

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int n = min(kChunk, seq - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int c = threadIdx.x; c < n * K; c += blockDim.x) {
      const int t = c / K, i = c % K;
      const long long off = (long long)(t0 + t) * step + i;
      r_s[c] = rb[off];
      k_s[c] = kb[off];
      w_s[c] = wb[off];
    }
    for (int c = threadIdx.x; c < n * V; c += blockDim.x) {
      const int t = c / V, j = c % V;
      v_s[c] = vb[(long long)(t0 + t) * vstep + j];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      const float vt = v_s[t * V + col];
      const float* rt = r_s + t * K;
      const float* kt = k_s + t * K;
      const float* wt = w_s + t * K;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = kt[i] * vt;
        part[i & 3] = fmaf(rt[i], fmaf(u_s[i], kv, S[i]), part[i & 3]);
        S[i] = fmaf(wt[i], S[i], kv);
      }
      yb[(long long)(t0 + t) * vstep + col] =
          (part[0] + part[1]) + (part[2] + part[3]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < K; ++i) sT[state0 + (long long)i * V + col] = S[i];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int batch,
           int seq, int n_heads, int V, cudaStream_t stream) {
  const int threads = (V + 31) / 32 * 32;
  const int smem = (3 * kChunk * K + K + kChunk * V) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_forward_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  wkv_forward_kernel<K><<<batch * n_heads, threads, smem, stream>>>(
      r, k, v, w, u, s0, y, sT, seq, n_heads, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Contiguous f32 tensors as in the header; K in (32, 64), 1 <= V <=
// 1024.  seq = 0 copies s0 to sT.
int wkv_forward_launch(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0,
                       void* y, void* sT, int batch, int seq, int n_heads,
                       int K, int V, void* stream) {
  if (batch <= 0 || n_heads <= 0) return 0;
  if (V < 1 || V > kMaxV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *rf = static_cast<const float*>(r),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u),
              *sf = static_cast<const float*>(s0);
  float *yf = static_cast<float*>(y), *tf = static_cast<float*>(sT);
  switch (K) {
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, sf, yf, tf, batch, seq, n_heads,
                        V, s);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, sf, yf, tf, batch, seq, n_heads,
                        V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
