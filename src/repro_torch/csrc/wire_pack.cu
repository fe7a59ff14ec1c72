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
// Bound on an H100: memory.  Pack reads 4*F bytes and writes 4 bytes per
// word; unpack the reverse.  Design: one thread per packed word, shifts
// and masks on uint32_t in registers, grid-stride over R*W words so any
// payload size takes one launch.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool field_valid(const int* counts, long long r,
                                            long long j, int period) {
  return counts == nullptr || (j % period) < (long long)counts[r];
}

__global__ void __launch_bounds__(kThreads)
pack_words_kernel(const uint32_t* __restrict__ fields,
                  const int* __restrict__ counts, uint32_t* __restrict__ out,
                  long long rows, long long words, int bits, int period) {
  const int per_word = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const long long total = rows * words;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / words;
    const long long w = i - r * words;
    const uint32_t* src = fields + r * words * per_word + w * per_word;
    uint32_t word = 0u;
    for (int f = 0; f < per_word; ++f) {
      uint32_t v = src[f] & mask;
      if (!field_valid(counts, r, w * per_word + f, period)) v = 0u;
      word |= v << (f * bits);
    }
    out[i] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_words_kernel(const uint32_t* __restrict__ words_in,
                    const int* __restrict__ counts,
                    uint32_t* __restrict__ out, long long rows,
                    long long words, int bits, int period) {
  const int per_word = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const long long total = rows * words;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / words;
    const long long w = i - r * words;
    const uint32_t word = words_in[i];
    uint32_t* dst = out + r * words * per_word + w * per_word;
    for (int f = 0; f < per_word; ++f) {
      uint32_t v = (word >> (f * bits)) & mask;
      if (!field_valid(counts, r, w * per_word + f, period)) v = 0u;
      dst[f] = v;
    }
  }
}

unsigned grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

}  // namespace

extern "C" int pack_words_launch(const uint32_t* fields, const int* counts,
                                 uint32_t* out, long long rows,
                                 long long words, int bits, int period,
                                 void* stream) {
  if (rows * words > 0) {
    pack_words_kernel<<<grid_for(rows * words), kThreads, 0,
                        (cudaStream_t)stream>>>(fields, counts, out, rows,
                                                words, bits, period);
  }
  return (int)cudaGetLastError();
}

extern "C" int unpack_words_launch(const uint32_t* words_in,
                                   const int* counts, uint32_t* out,
                                   long long rows, long long words, int bits,
                                   int period, void* stream) {
  if (rows * words > 0) {
    unpack_words_kernel<<<grid_for(rows * words), kThreads, 0,
                          (cudaStream_t)stream>>>(words_in, counts, out,
                                                  rows, words, bits, period);
  }
  return (int)cudaGetLastError();
}
