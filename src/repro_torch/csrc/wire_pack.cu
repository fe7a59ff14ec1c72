// Bit-packing codec of the compressed-gradient wire format for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/wire_pack.py:
//   * pack_words (_pack_kernel, _pack_kernel_ragged, _field_mask):
//     (R, W*F) uint32 fields of width bits in {4, 8, 16} -> (R, W) words,
//     field f of a word at bits [f*bits, (f+1)*bits);
//   * unpack_words (_unpack_kernel, _unpack_kernel_ragged): the inverse.
// F = 32 / bits.  With a counts pointer (the ragged variant) field j of
// row r is zeroed when j % period >= counts[r], on the way in (pack) or
// out (unpack).
//
// Bound on an H100: memory.  Pack reads 4*F bytes and writes 4 bytes a
// word, unpack the reverse: (1 + F) * 4 bytes a word at 3.35 TB/s, e.g.
// 0.0019 ms for the trainer's 537,600-word 16-bit index stream and
// 0.0196 ms for its 5,483,520-word one at gamma 0.1.  A few shifts and
// masks a field are far below the card's integer rate.
//
// Design: a streaming pass.  Packing is word-local, so without counts the
// (R, W) tensor is one flat stream of R*W words and needs no row index.
// The vector path (kVector) gives each warp a tile of 128 words: the
// field side moves as F 16-byte accesses a thread, lane-contiguous, so
// each warp-wide instruction covers 512 contiguous bytes; the word side
// as 8-byte (16-bit fields), 4-byte (8-bit) or shared 4-byte (4-bit: two
// lanes hold the halves of a word and join them with one shuffle)
// accesses, contiguous too.  A block walks its tiles from a 64-bit base
// computed once per block and 32-bit offsets inside it; the grid is a few
// waves of the blocks an SM holds, striding beyond that.  The launcher
// picks the first word `head` (0..3) at which both pointers are 16-byte
// aligned; the head words and the tail of fewer than 128 words are done
// one a thread by the first threads of the grid.  When no such word
// exists (a field pointer off 16 bytes by one field, say) the stream
// takes the scalar path (kScalar), one word a thread.  The ragged variant
// (kRagged) runs rows on grid y, striding past 65,535, and words on x,
// with 32-bit row and column math: counts[r] read once per row, j %
// period once per word and a running counter across its fields (rows and
// fields per row below 2^31, else the launcher returns
// cudaErrorInvalidValue).  All shifts are on uint32_t: fields and words
// travel as int32 bit patterns.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileShift = 7;
constexpr int kTile = 1 << kTileShift;   // words a warp packs in one step
constexpr int kWaves = 4;          // grid: this many waves of resident blocks
constexpr int kMaxGridY = 65535;
constexpr int kVector = 0, kScalar = 1, kRagged = 2;

struct Stream {
  const uint32_t* in;   // fields (pack) or words (unpack)
  uint32_t* out;        // words (pack) or fields (unpack)
  const int* counts;    // kRagged: valid fields per row, else null
  long long n;          // words in the stream
  int head;             // kVector: words before the first aligned tile
  int rows, cols;       // kRagged: the (rows, cols) words
  int period;           // kRagged
};

template <int kBits>
__device__ __forceinline__ uint32_t pack_word(const uint32_t* v) {
  constexpr int F = 32 / kBits;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  uint32_t word = 0u;
#pragma unroll
  for (int f = 0; f < F; ++f) word |= (v[f] & kMask) << (f * kBits);
  return word;
}

template <int kBits>
__device__ __forceinline__ void unpack_word(uint32_t word, uint32_t* v) {
  constexpr int F = 32 / kBits;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = (word >> (f * kBits)) & kMask;
}

// 4-bit fields x, y, z, w at bits [shift, shift + 16) of a word.
__device__ __forceinline__ uint32_t pack_quarter(uint4 a, int shift) {
  return ((a.x & 15u) | (a.y & 15u) << 4 | (a.z & 15u) << 8 |
          (a.w & 15u) << 12) << shift;
}

// One warp's tile: words [0, 128) at `words`, their fields at `fields`.
template <int kBits>
__device__ __forceinline__ void pack_tile(const uint4* __restrict__ fields,
                                          uint32_t* __restrict__ words,
                                          int lane) {
  constexpr int F = 32 / kBits;
  uint4 a[F];
#pragma unroll
  for (int q = 0; q < F; ++q) a[q] = fields[q * 32 + lane];
#pragma unroll
  for (int q = 0; q < F; ++q) {
    if constexpr (F == 2) {      // vector j: the fields of words 2j, 2j+1
      const uint32_t lo[2] = {a[q].x, a[q].y}, hi[2] = {a[q].z, a[q].w};
      reinterpret_cast<uint2*>(words)[q * 32 + lane] =
          make_uint2(pack_word<kBits>(lo), pack_word<kBits>(hi));
    } else if constexpr (F == 4) {   // vector j: word j
      const uint32_t v[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
      words[q * 32 + lane] = pack_word<kBits>(v);
    } else {                     // vector j: half j % 2 of word j / 2
      uint32_t w = pack_quarter(a[q], (lane & 1) * 16);
      w |= __shfl_xor_sync(0xffffffffu, w, 1);
      if ((lane & 1) == 0) words[q * 16 + lane / 2] = w;
    }
  }
}

template <int kBits>
__device__ __forceinline__ void unpack_tile(const uint32_t* __restrict__ words,
                                            uint4* __restrict__ fields,
                                            int lane) {
  constexpr int F = 32 / kBits;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  uint4 a[F];
#pragma unroll
  for (int q = 0; q < F; ++q) {
    if constexpr (F == 2) {
      const uint2 w = reinterpret_cast<const uint2*>(words)[q * 32 + lane];
      a[q] = make_uint4(w.x & kMask, w.x >> 16, w.y & kMask, w.y >> 16);
    } else if constexpr (F == 4) {
      const uint32_t w = words[q * 32 + lane];
      a[q] = make_uint4(w & kMask, (w >> 8) & kMask, (w >> 16) & kMask,
                        w >> 24);
    } else {
      const uint32_t w = words[q * 16 + lane / 2] >> ((lane & 1) * 16);
      a[q] = make_uint4(w & kMask, (w >> 4) & kMask, (w >> 8) & kMask,
                        (w >> 12) & kMask);
    }
  }
#pragma unroll
  for (int q = 0; q < F; ++q) fields[q * 32 + lane] = a[q];
}

// kVector's scalar words: the first `head` threads of the grid take the
// head words, the next ones the tail of (n - head) % 128 words.
__device__ __forceinline__ long long edge_word(const Stream& s) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int tail = (int)((s.n - s.head) & (kTile - 1));
  if (t < s.head) return t;
  if (t < s.head + tail) return s.n - tail + (t - s.head);
  return -1;
}

template <int kBits, int kMode>
__global__ void __launch_bounds__(kThreads)
pack_words_kernel(const Stream s) {
  constexpr int F = 32 / kBits;
  if constexpr (kMode == kVector) {
    const long long tiles = (s.n - s.head) >> kTileShift;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint4* fields = reinterpret_cast<const uint4*>(s.in + s.head * F);
    uint32_t* words = s.out + s.head;
    for (long long base = (long long)blockIdx.x * kWarps; base < tiles;
         base += (long long)gridDim.x * kWarps) {
      if (warp < tiles - base)
        pack_tile<kBits>(fields + base * (kTile * F / 4) + warp * 32 * F,
                         words + base * kTile + warp * kTile, lane);
    }
    const long long i = edge_word(s);
    if (i >= 0) s.out[i] = pack_word<kBits>(s.in + i * F);
  } else if constexpr (kMode == kScalar) {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < s.n; i += (long long)gridDim.x * kThreads)
      s.out[i] = pack_word<kBits>(s.in + i * F);
  } else {
    for (int r = blockIdx.y; r < s.rows; r += gridDim.y) {
      const uint32_t* src = s.in + (long long)r * s.cols * F;
      uint32_t* dst = s.out + (long long)r * s.cols;
      const int count = s.counts[r];
      for (int w = blockIdx.x * kThreads + threadIdx.x; w < s.cols;
           w += gridDim.x * kThreads) {
        uint32_t v[F];
        int p = (w * F) % s.period;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          v[f] = p < count ? src[w * F + f] : 0u;
          if (++p == s.period) p = 0;
        }
        dst[w] = pack_word<kBits>(v);
      }
    }
  }
}

template <int kBits, int kMode>
__global__ void __launch_bounds__(kThreads)
unpack_words_kernel(const Stream s) {
  constexpr int F = 32 / kBits;
  if constexpr (kMode == kVector) {
    const long long tiles = (s.n - s.head) >> kTileShift;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint32_t* words = s.in + s.head;
    uint4* fields = reinterpret_cast<uint4*>(s.out + s.head * F);
    for (long long base = (long long)blockIdx.x * kWarps; base < tiles;
         base += (long long)gridDim.x * kWarps) {
      if (warp < tiles - base)
        unpack_tile<kBits>(words + base * kTile + warp * kTile,
                           fields + base * (kTile * F / 4) + warp * 32 * F,
                           lane);
    }
    const long long i = edge_word(s);
    if (i >= 0) unpack_word<kBits>(s.in[i], s.out + i * F);
  } else if constexpr (kMode == kScalar) {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < s.n; i += (long long)gridDim.x * kThreads)
      unpack_word<kBits>(s.in[i], s.out + i * F);
  } else {
    for (int r = blockIdx.y; r < s.rows; r += gridDim.y) {
      const uint32_t* src = s.in + (long long)r * s.cols;
      uint32_t* dst = s.out + (long long)r * s.cols * F;
      const int count = s.counts[r];
      for (int w = blockIdx.x * kThreads + threadIdx.x; w < s.cols;
           w += gridDim.x * kThreads) {
        uint32_t v[F];
        unpack_word<kBits>(src[w], v);
        int p = (w * F) % s.period;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          dst[w * F + f] = p < count ? v[f] : 0u;
          if (++p == s.period) p = 0;
        }
      }
    }
  }
}

// The first word (0..3) at which both pointers are 16-byte aligned, the
// input advancing in_bytes and the output out_bytes a word; -1 if none.
int vector_head(const void* in, int in_bytes, const void* out,
                int out_bytes) {
  const uintptr_t a = (uintptr_t)in, b = (uintptr_t)out;
  for (int h = 0; h < 4; ++h)
    if ((a + (uintptr_t)h * in_bytes) % 16 == 0 &&
        (b + (uintptr_t)h * out_bytes) % 16 == 0)
      return h;
  return -1;
}

unsigned grid_for(long long blocks, long long cap) {
  return (unsigned)(blocks < 1 ? 1 : blocks < cap ? blocks : cap);
}

// Launch one mode of the pack or unpack kernel over `blocks` blocks (at
// most a few waves of what the card holds at once, found at the first
// launch of each kernel) and `rows_y` rows of grid y.
template <bool kPack, int kBits, int kMode>
void start(const Stream& s, long long blocks, unsigned rows_y,
           cudaStream_t stream) {
  void (*kernel)(const Stream) = kPack ? pack_words_kernel<kBits, kMode>
                                       : unpack_words_kernel<kBits, kMode>;
  static long long cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    cap = (long long)kWaves * (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  void* args[] = {const_cast<Stream*>(&s)};
  cudaLaunchKernel((const void*)kernel, dim3(grid_for(blocks, cap), rows_y),
                   dim3(kThreads), args, 0, stream);
}

template <bool kPack, int kBits>
int launch(const uint32_t* in, const int* counts, uint32_t* out,
           long long rows, long long words, int period,
           cudaStream_t stream) {
  constexpr int F = 32 / kBits;
  Stream s{in, out, counts, rows * words, 0, 0, 0, period};
  if (counts != nullptr) {
    if (rows > 0x7fffffffLL || words * F > 0x7fffffffLL || period <= 0)
      return (int)cudaErrorInvalidValue;
    s.rows = (int)rows;
    s.cols = (int)words;
    start<kPack, kBits, kRagged>(
        s, (words + kThreads - 1) / kThreads,
        (unsigned)(rows < kMaxGridY ? rows : kMaxGridY), stream);
  } else {
    s.head = kPack ? vector_head(in, 4 * F, out, 4)
                   : vector_head(in, 4, out, 4 * F);
    if (s.head >= 0 && s.head <= s.n) {
      const long long tiles = (s.n - s.head) >> kTileShift;
      start<kPack, kBits, kVector>(s, (tiles + kWarps - 1) / kWarps, 1,
                                   stream);
    } else {
      s.head = 0;
      start<kPack, kBits, kScalar>(s, (s.n + kThreads - 1) / kThreads, 1,
                                   stream);
    }
  }
  return (int)cudaGetLastError();
}

template <bool kPack>
int launch_bits(const uint32_t* in, const int* counts, uint32_t* out,
                long long rows, long long words, int bits, int period,
                void* stream) {
  if (rows * words <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 4: return launch<kPack, 4>(in, counts, out, rows, words, period, s);
    case 8: return launch<kPack, 8>(in, counts, out, rows, words, period, s);
    case 16:
      return launch<kPack, 16>(in, counts, out, rows, words, period, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pack_words_launch(const uint32_t* fields, const int* counts,
                                 uint32_t* out, long long rows,
                                 long long words, int bits, int period,
                                 void* stream) {
  return launch_bits<true>(fields, counts, out, rows, words, bits, period,
                           stream);
}

extern "C" int unpack_words_launch(const uint32_t* words_in,
                                   const int* counts, uint32_t* out,
                                   long long rows, long long words, int bits,
                                   int period, void* stream) {
  return launch_bits<false>(words_in, counts, out, rows, words, bits, period,
                            stream);
}
