// Flash-attention forward for f32 on Hopper's CUDA cores (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) for f32 inputs: for q (B, H, Sq,
// D) and k, v (B, H, Sk, D), queries at absolute positions q_offset + i
// with q_offset = Sk - Sq,
//     o = softmax(mask((q * scale) k^T)) v
// with an online softmax over KV tiles: running max m, denominator l and
// a (BQ, D) accumulator in f32, o = acc / max(l, 1e-30).  Masking is the
// TPU kernel's: kpos < Sk, causal kpos <= qpos, window kpos > qpos -
// window, masked logits set to NEG_INF = -1e30; KV tiles wholly outside
// the causal/window band of a query tile are skipped by the loop bounds.
// Without causality Sq may exceed Sk (an encoder-decoder's cross
// attention), so q_offset and the query positions may be negative: the
// window's first tile clamps at 0 and the masks compare signed positions,
// and every row keeps key Sk - 1, so none is empty.  (Causal Sq > Sk is
// refused by the wrapper.)  q * scale is formed in f32 before the
// product, as on the TPU.  bf16
// inputs take flash_attention_sm90.cu (tensor cores); f32 stays here,
// because no tensor-core format holds f32 operands exactly, and the f32
// smoke serving runs compare the card's greedy tokens with the CPU's.
//
// Bound: operations.  At the f32 check shape (2, 3, 300, 300, 128)
// causal the products are 4 D FLOPs for each query-key pair of the band
// on the CUDA cores, at most 67 TFLOP/s.
//
// Design: one block of 128 threads per (b*h, tile of BQ = 64 queries).
// Each query row belongs to two lanes of one warp (lanes l and l ^ 16),
// each owning half of D: its half of the (pre-scaled) row sits in shared
// memory, its half of the accumulator in registers, and the two partial
// dot products of a logit are summed with one shuffle, so both lanes
// hold identical logits and softmax state.  K and V tiles of BK = 32
// rows are copied to shared memory once per block.  The layout is read
// through strides: q, k, v and o may be transposed views of (B, S, H,
// D) tensors, as the model hands them over, with the last axis
// contiguous.  Heavy causal tiles (late queries) are scheduled first.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

struct Strides {
  long long b, h, s;    // in elements; the last axis has stride 1
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int n_heads, int sq, int sk, float scale, int causal,
                       int window) {
  constexpr int D4 = D / 4;          // float4 columns of a row
  constexpr int DH4 = D4 / 2;        // float4 columns of a half row
  extern __shared__ float4 smem[];
  float4* q_s = smem;                // [D4][kBQ]: column-major, so the
                                     // 16 rows a warp reads are adjacent
  float4* k_s = q_s + D4 * kBQ;      // [kBK][D4]
  float4* v_s = k_s + kBK * D4;      // [kBK][D4]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane & 15);   // query row in the tile
  const int half = lane >> 4;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy tiles first
  const int q_offset = sk - sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int c = tid; c < kBQ * D4; c += kThreads) {
    const int r = c / D4, d4 = c % D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) {
      x = load4(qb + (long long)(q0 + r) * qs.s + 4 * d4);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    q_s[d4 * kBQ + r] = x;
  }

  // the KV tiles that meet this query tile's causal/window band
  const int q_start = q0 + q_offset;
  int lo = 0;
  if (window > 0) lo = max(q_start - (window - 1), 0) / kBK;
  int hi = (sk + kBK - 1) / kBK;
  if (causal) hi = min(hi, (q_start + kBQ + kBK - 1) / kBK);

  const int qpos = q_start + row;
  float m_i = kNegInf, l_i = 0.f;
  float acc[4 * DH4];
#pragma unroll
  for (int i = 0; i < 4 * DH4; ++i) acc[i] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int kv0 = kt * kBK;
    __syncthreads();                 // the previous tile is consumed
    for (int c = tid; c < kBK * D4; c += kThreads) {
      const int j = c / D4, d4 = c % D4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kv0 + j < sk) {
        kx = load4(kb + (long long)(kv0 + j) * ks.s + 4 * d4);
        vx = load4(vb + (long long)(kv0 + j) * vs.s + 4 * d4);
      }
      k_s[c] = kx;
      v_s[c] = vx;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DH4; ++dd) {
      const int d4 = half * DH4 + dd;
      const float4 qx = q_s[d4 * kBQ + row];
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kx = k_s[j * D4 + d4];
        s[j] = fmaf(qx.w, kx.w, fmaf(qx.z, kx.z,
               fmaf(qx.y, kx.y, fmaf(qx.x, kx.x, s[j]))));
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] += __shfl_xor_sync(kFull, s[j], 16);   // the other half of D
      const int kpos = kv0 + j;
      bool ok = kpos < sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[j] = ok ? s[j] : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l_i = alpha * l_i + psum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < 4 * DH4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int dd = 0; dd < DH4; ++dd) {
        const float4 vx = v_s[j * D4 + half * DH4 + dd];
        acc[4 * dd] = fmaf(s[j], vx.x, acc[4 * dd]);
        acc[4 * dd + 1] = fmaf(s[j], vx.y, acc[4 * dd + 1]);
        acc[4 * dd + 2] = fmaf(s[j], vx.z, acc[4 * dd + 2]);
        acc[4 * dd + 3] = fmaf(s[j], vx.w, acc[4 * dd + 3]);
      }
    }
  }

  if (q0 + row >= sq) return;
  const float denom = fmaxf(l_i, 1e-30f);
  T* ob = o + b * os.b + h * os.h + (long long)(q0 + row) * os.s
          + half * (D / 2);
#pragma unroll
  for (int dd = 0; dd < DH4; ++dd)
    store4(ob + 4 * dd, make_float4(acc[4 * dd] / denom,
                                    acc[4 * dd + 1] / denom,
                                    acc[4 * dd + 2] / denom,
                                    acc[4 * dd + 3] / denom));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int batch, int n_heads, int sq, int sk,
           float scale, int causal, int window, cudaStream_t stream) {
  const int smem = (D / 4) * (kBQ + 2 * kBK) * (int)sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * n_heads, (sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, n_heads,
      sq, sk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             const long long* st, int batch, int n_heads, int sq, int sk,
             float scale, int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, st, batch, n_heads, sq, sk, scale,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, st, batch, n_heads, sq, sk, scale,
                           causal, window, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, st, batch, n_heads, sq, sk, scale,
                            causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, st, batch, n_heads, sq, sk, scale,
                            causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, H, Sq, D); k, v: (B, H, Sk, D); strides: 12 element strides,
// (b, h, s) of q, k, v and o in turn (the last axis contiguous).  D is
// 32, 64, 112 or 128; window 0 means no window.  All four are f32.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int batch,
                           int n_heads, int sq, int sk, int d, float scale,
                           int causal, int window, void* stream) {
  if (batch <= 0 || n_heads <= 0 || sq <= 0) return 0;
  return launch_d<float>(d, q, k, v, o, strides, batch, n_heads, sq, sk,
                         scale, causal, window,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
