// Flash-attention forward for bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) for bf16 inputs: for q (B, H,
// Sq, D) and k, v (B, H, Sk, D), queries at absolute positions
// q_offset + i with q_offset = Sk - Sq,
//     o = softmax(mask((q k^T) * scale)) v
// with an online softmax over KV tiles: running max m, denominator l and
// an f32 accumulator, o = acc / max(l, 1e-30).  Masks: kpos < Sk, causal
// kpos <= qpos, window kpos > qpos - window; masked logits are -1e30.
// KV tiles wholly outside a query tile's causal/window band are skipped
// by the loop bounds.  Without causality Sq may exceed Sk (an
// encoder-decoder's cross attention: 2048 decoder positions against 32
// encoder frames), so q_offset, q_start and the query positions may be
// negative: the window's first tile clamps at 0, and the tile bounds,
// the live test and the row masks compare signed positions, so they
// hold as they are; every row keeps key Sk - 1, so none is empty.
// (Causal Sq > Sk is refused by the wrapper.)  TMA zero-fills the K and
// V rows of a tile past Sk (32 keys fill half of one 64-key tile), and
// the mask drops them.  f32 inputs stay on flash_attention.cu: no
// tensor-core format holds f32 operands exactly.
//
// Bound: at qwen1.5-4b prefill, (4, 20, 2048, 128) bf16 causal, the
// function does 86 GFLOP of products (4 D FLOPs for each of the
// Sq (Sq + 1) / 2 query-key pairs of the causal band, per (b, h)) and
// moves 168 MB: 0.0869 ms at the 989 TFLOP/s of the bf16 tensor cores,
// 0.050 ms at 3.35 TB/s, so operations bound it.  The design puts both
// products on the tensor cores (wgmma); TMA brings the q, k and v tiles
// into shared memory without the computing threads, wgmma reads them
// there, and the logits never leave registers.
//
// Numerics.  q is bf16, so q * scale cannot be formed in f32 before a
// tensor-core product: the scale (times log2 e, for exp2f) is applied to
// the f32 logits, s = (q k) * scale, as ref.mha_reference does.  P is
// written as P_hi + P_lo, P_hi = bf16(p), P_lo = bf16(p - P_hi), and
// O += [P_hi | P_lo] [V; V] is one wgmma chain of twice the depth over
// the same V tile: rounding P once to bf16 (error 2^-8 a term) moves an
// output near zero by more than one of its own bf16 ulps at S = 2048;
// the split leaves about 2^-16, at half as much tensor work again (129
// GFLOP in place of 86, a 0.13 ms bound).  l sums the f32 p.
//
// Design.  One block per (b * h, tile of 128 queries), heavy causal
// tiles first; 288 threads: two consumer warpgroups, each owning 64
// query rows, and one producer warp.
//   * The producer's lane 0 issues TMA loads: the block's Q once, then
//     each KV tile (64 keys) into a ring of kStages shared-memory stages,
//     with a full and an empty mbarrier per stage, so the next tiles'
//     loads overlap the current tile's products.  The tensor maps are
//     rank 4 over (D, S, H, B) with the views' own byte strides (the
//     model's transposed (B, S, H, D) views as they are), so a box never
//     runs past Sk into the next head: TMA zero-fills the ragged edge.
//     A box is one 128-byte swizzle row wide (64 values; D 128 takes two
//     boxes a tile) or, at D 32, one 64-byte row.  D 112 (zamba2-7b's
//     heads) takes the D 128 layout: the maps declare the real 112
//     columns, so TMA zero-fills columns 112-127 of the second box of
//     every Q, K and V tile.  S = Q K^T then runs over 7 k16 steps
//     (the padded columns would add zeros), O += P V at n128 (1.14x
//     the tensor work of a true n112, whose MN-major V operand would
//     end inside a 128-byte swizzle atom), and the zero columns 112-127
//     of O are never stored.  A batch or head axis
//     of size 1 or stride 0 (a broadcast view) is described with size 1
//     and read at coordinate 0, so every view the wrapper accepts takes
//     TMA; none takes another route.
//   * Each consumer warpgroup computes S = Q K^T with wgmma m64n64k16
//     (Q and K K-major in shared memory, f32 accumulators), scales and
//     masks S in registers (the mask only on the diagonal tiles, the
//     ragged Sk tile and the window's edge), updates m and l, rescales
//     O and runs O += P V with wgmma m64nDk16: P from registers as the A
//     operand (the S accumulator's layout is the A fragment's), V
//     MN-major in shared memory through the instruction's transpose-B
//     flag.  Each product is waited for before the next step, so a
//     warpgroup's softmax does not overlap its own products, only the
//     other warpgroup's.  A tile wholly masked for a warpgroup's 64
//     rows, or a warpgroup whose rows all lie at or beyond Sq, is
//     released without products.  The warpgroup index comes through a
//     shuffle, so the compiler can prove it warp-uniform and keeps the
//     wgmma descriptors in uniform registers.
//   * Not done: issuing S of tile j together with P V of tile j - 1, so
//     that a warpgroup's softmax overlaps its own P V.  ptxas serialized
//     every wgmma of that schedule (note C7513: the V descriptors, which
//     follow a loop-carried stage index, were moved into uniform
//     registers between the instructions).
//   * A barrier wait that outlasts about 10 s traps, so a fault of the
//     pipeline ends the launch with an error instead of hanging it.
//   * o is stored from registers into the (B, Sq, H, D) buffer the
//     wrapper allocates, rows at or beyond Sq masked.
//
// The entry point returns cudaGetLastError() after its launch, or an
// error code when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;            // queries a block: two warpgroups
constexpr int kBK = 64;             // keys a KV tile
constexpr int kStages = 3;          // KV tiles in flight
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr float kNegInf = -1e30f;

template <int D>
struct Layout {
  static constexpr int kCols = D < 64 ? D : 64;   // values a swizzle row
  static constexpr int kRowBytes = kCols * 2;     // 128 or 64
  static constexpr int kBoxes = (D + kCols - 1) / kCols;   // boxes across D
  static constexpr int kPadD = kBoxes * kCols;    // D, or 128 at D 112
  static constexpr int kBoxBytes = 64 * kRowBytes;   // 64 rows of a box
  static constexpr int kTile = 64 * kPadD * 2;    // 64 rows of kPadD values
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;
  // shared memory: Q (two warpgroups' tiles), then K and V per stage,
  // then the barriers; 1024 bytes of slack align the base for swizzle
  static constexpr int kQ = 0;
  static constexpr int kKV = 2 * kTile;
  static constexpr int kBars = kKV + kStages * 2 * kTile;
  static constexpr int kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A
// wait of more than about 10 s (a fault of the kernel, never a slow
// tile) traps, so a broken pipeline ends in a launch error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 20000000000LL) asm volatile("trap;");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                        uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
         | (uint64_t)layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 operands, f32 accumulators.  _ss: A and
// B from shared memory, both K-major; _rs: A from registers, B MN-major
// (transposed) in shared memory, accumulating.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V at n = PD, the padded head dimension (Layout::kPadD)
template <int PD>
__device__ __forceinline__ void wgmma_pv(float (&o)[PD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (PD == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (PD == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n32(o, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

struct OutStrides {
  long long b, h, s;    // elements of o; the last axis has stride 1
};

// Which coordinates of a tensor map's batch and head axes are read: 0
// for an axis described with size 1 (a size-1 or broadcast axis).
struct Coords {
  int q_b, q_h, k_b, k_h, v_b, v_h;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, OutStrides os,
                            Coords cs, int n_heads, int sq, int sk,
                            float scale_log2, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  auto full = [&](int s) { return q_full + 8 + 8 * s; };
  auto empty = [&](int s) { return q_full + 8 + 8 * kStages + 8 * s; };
  auto k_tile = [&](int s) { return base + L::kKV + s * 2 * L::kTile; };

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy tiles first
  const int q_offset = sk - sq;
  const int q_start = q0 + q_offset;
  // the KV tiles that meet this query tile's causal/window band
  int lo = 0;
  if (window > 0) lo = max(q_start - (window - 1), 0) / kBK;
  int hi = (sk + kBK - 1) / kBK;
  if (causal) hi = min(hi, (q_start + kBQ + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kConsumers / 32) {
    // ---- producer: one lane issues every TMA load ----
    if (lane != 0) return;
    mbar_expect_tx(q_full, 2 * L::kTile);
    for (int g = 0; g < 2; ++g)
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(base + L::kQ + g * L::kTile + c * L::kBoxBytes, &tq, q_full,
                 c * L::kCols, q0 + 64 * g, h * cs.q_h, b * cs.q_b);
    int stage = 0, phase = 0;
    for (int kt = lo; kt < hi; ++kt) {
      mbar_wait(empty(stage), phase ^ 1);
      mbar_expect_tx(full(stage), 2 * L::kTile);
      const uint32_t kd = k_tile(stage), vd = kd + L::kTile;
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(kd + c * L::kBoxBytes, &tk, full(stage), c * L::kCols,
                 kt * kBK, h * cs.k_h, b * cs.k_b);
        tma_load(vd + c * L::kBoxBytes, &tv, full(stage), c * L::kCols,
                 kt * kBK, h * cs.v_h, b * cs.v_b);
      }
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64) ----
  // wg through a shuffle, so the compiler knows it is warp-uniform and
  // keeps the tile addresses and wgmma descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r0 = (warp & 3) * 16 + (lane >> 2);    // this thread's rows:
  const int qrow0 = q0 + 64 * wg + r0;             // r0 and r0 + 8
  const int qpos0 = q_offset + qrow0, qpos1 = qpos0 + 8;
  const int wg_first = q_start + 64 * wg, wg_last = wg_first + 63;
  const int col = 2 * (lane & 3);                  // within 8 columns
  const uint32_t q_tile = base + L::kQ + wg * L::kTile;

  constexpr int kAcc = L::kPadD / 2;              // O's f32 accumulators
  float acc[kAcc], s[32];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  int stage = 0, phase = 0;
  for (int kt = lo; kt < hi; ++kt) {
    const int kv0 = kt * kBK;
    mbar_wait(full(stage), phase);
    const bool live = q0 + 64 * wg < sq && !(causal && kv0 > wg_last) &&
                      !(window > 0 && kv0 + kBK - 1 <= wg_first - window);
    if (live) {                      // uniform across the warpgroup
      const uint32_t kd = k_tile(stage), vd = kd + L::kTile;
      // S = Q K^T over D in steps of 16 (the zero-filled columns past D
      // are not read)
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        const uint32_t off = (t * 16 / L::kCols) * L::kBoxBytes
                             + (t * 16 % L::kCols) * 2;
        wgmma_ss_n64(s,
                     desc(q_tile + off, 16, 8 * L::kRowBytes, L::kSwizzle),
                     desc(kd + off, 16, 8 * L::kRowBytes, L::kSwizzle),
                     t > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale into the log2 domain; mask the diagonal, ragged and window
      // edge tiles; element i sits at row r0 + 8 [i & 2], column
      // kv0 + 8 (i / 4) + col + (i & 1)
      const bool edge = kv0 + kBK > sk
                        || (causal && kv0 + kBK - 1 > wg_first)
                        || (window > 0 && kv0 <= wg_last - window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale_log2;
        if (edge) {
          const int kpos = kv0 + 8 * (i / 4) + col + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : kNegInf;
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // p = exp2(s - m) in f32; P_hi = bf16(p), P_lo = bf16(p - P_hi),
      // packed as the A fragments of the four 16-key steps
      uint32_t p_hi[16], p_lo[16];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float m = (j & 1) ? mn1 : mn0;
        const float pa = exp2f(s[2 * j] - m), pb = exp2f(s[2 * j + 1] - m);
        if (j & 1) ps1 += pa + pb; else ps0 += pa + pb;
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(pa, pb);
        const float2 hf = __bfloat1622float2(hi2);
        p_hi[j] = bf16x2_bits(hi2);
        p_lo[j] = bf16x2_bits(__floats2bfloat162_rn(pa - hf.x, pb - hf.y));
      }
      l0 = l0 * a0 + ps0;            // this thread's columns; the quad's
      l1 = l1 * a1 + ps1;            // partial sums are added at the end
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= (i & 2) ? a1 : a0;

      // O += [P_hi | P_lo] [V; V], 16 keys a step
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t) {
        const uint64_t dv = desc(vd + t * 16 * L::kRowBytes, L::kBoxBytes,
                                 8 * L::kRowBytes, L::kSwizzle);
        const uint32_t ah[4] = {p_hi[4 * t], p_hi[4 * t + 1],
                                p_hi[4 * t + 2], p_hi[4 * t + 3]};
        const uint32_t al[4] = {p_lo[4 * t], p_lo[4 * t + 1],
                                p_lo[4 * t + 2], p_lo[4 * t + 3]};
        wgmma_pv<L::kPadD>(acc, ah, dv);
        wgmma_pv<L::kPadD>(acc, al, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(empty(stage));       // the stage's K and V are consumed
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * os.b + h * os.h + col;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {      // the columns past D stay unstored
    if (qrow0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + qrow0 * os.s + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (qrow0 + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (qrow0 + 8) * os.s + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no link against the driver.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes of this file, beyond CUDA's own: the driver entry point is
// missing, or TMA refused a view.
constexpr int kErrNoEncoder = 10001;
constexpr int kErrEncode = 10002;

// A rank-4 map over (D, S, H, B) with the view's element strides st =
// (b, h, s).  An axis of size 1 or stride 0 is described with size 1
// (*read = 0: the kernel reads it at coordinate 0).
template <int D>
int encode(CUtensorMap* map, const void* ptr, const long long* st, int batch,
           int n_heads, int seq, int* read_b, int* read_h) {
  using L = Layout<D>;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  *read_b = batch > 1 && st[0] != 0;
  *read_h = n_heads > 1 && st[1] != 0;
  // a stride for an axis read only at 0: past everything else, 16-aligned
  const long long outer = ((long long)(seq - 1) * st[2] + D
                           + (long long)(n_heads - 1) * st[1]
                           + (long long)(batch - 1) * st[0] + 7) / 8 * 8;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)seq,
                              (cuuint64_t)(*read_h ? n_heads : 1),
                              (cuuint64_t)(*read_b ? batch : 1)};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(seq > 1 ? st[2] : D) * 2,
      (cuuint64_t)(*read_h ? st[1] : outer) * 2,
      (cuuint64_t)(*read_b ? st[0] : outer) * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::kCols, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int batch, int n_heads, int sq, int sk,
           float scale, int causal, int window, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  Coords cs;
  int err = encode<D>(&tq, q, st, batch, n_heads, sq, &cs.q_b, &cs.q_h);
  if (err == 0)
    err = encode<D>(&tk, k, st + 3, batch, n_heads, sk, &cs.k_b, &cs.k_h);
  if (err == 0)
    err = encode<D>(&tv, v, st + 6, batch, n_heads, sk, &cs.v_b, &cs.v_h);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return (int)e;
  const OutStrides os{st[9], st[10], st[11]};
  const dim3 grid(batch * n_heads, (sq + kBQ - 1) / kBQ);
  flash_attention_sm90_kernel<D><<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, cs, n_heads, sq, sk,
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, o: (B, H, Sq, D); k, v: (B, H, Sk, D); strides: 12 element
// strides, (b, h, s) of q, k, v and o in turn (the last axis contiguous,
// every stride a multiple of 8, every base 16-byte aligned).  D is 32, 64,
// 112 or 128; window 0 means no window.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, const long long* strides, int batch,
                                int n_heads, int sq, int sk, int d,
                                float scale, int causal, int window,
                                void* stream) {
  if (batch <= 0 || n_heads <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, strides, batch, n_heads, sq, sk, scale,
                        causal, window, s);
    case 64:
      return launch<64>(q, k, v, o, strides, batch, n_heads, sq, sk, scale,
                        causal, window, s);
    case 112:
      return launch<112>(q, k, v, o, strides, batch, n_heads, sq, sk, scale,
                         causal, window, s);
    case 128:
      return launch<128>(q, k, v, o, strides, batch, n_heads, sq, sk, scale,
                         causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory one block takes at head dimension d.
int flash_attention_sm90_smem_bytes(int d) {
  return d == 32 ? Layout<32>::kSmem : d == 64 ? Layout<64>::kSmem
         : d == 112 ? Layout<112>::kSmem : Layout<128>::kSmem;
}

}  // extern "C"
