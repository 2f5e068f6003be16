// Shared device code of the placement kernels K4 (csrc/bitpack_place.cu),
// K8 (csrc/bitpack_gather.cu) and K9 (csrc/bitpack_streams.cu): a CTA owns
// a range of one frame's output words, finds the blocks that reach it by a
// search of the frame's non-decreasing offsets, stages their records in
// shared memory chunk by chunk, and writes the range once.
#pragma once

#include "bs_common.cuh"

namespace psx {

// The first indices in [0, n) with e[i] >= key[q] (n where none), q = 0, 1,
// of a non-decreasing row in global memory, found by every thread of the
// CTA together. A round cuts each bracket into blockDim.x segments; thread
// t tests the last entry of segment t, and since the row is sorted the
// segments whose last entry is below the key are a prefix, whose length
// (the count) names the segment that holds the answer. Its barriers also
// order the shared-memory writes made before it (an image zeroed, an
// mbarrier initialised) before what follows.
__device__ __forceinline__ void cta_lower_bounds(const int* __restrict__ e,
                                                 int n, const int (&key)[2],
                                                 int (&lo)[2]) {
  int hi[2] = {n, n};  // the answer lies in [lo, hi]
  lo[0] = lo[1] = 0;
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int span = hi[q] - lo[q];
      const int step = (span + blockDim.x - 1) / blockDim.x;
      const int first = lo[q] + static_cast<int>(threadIdx.x) * step;
      const bool below =
          span > 0 && first < hi[q] &&
          __ldg(e + min(first + step, hi[q]) - 1) < key[q];
      const int c = __syncthreads_count(below);
      if (span > 0) {
        const int next = lo[q] + c * step;
        if (next >= hi[q]) {
          lo[q] = hi[q];
        } else {
          hi[q] = min(next + step, hi[q]) - 1;
          lo[q] = next;
        }
      }
    }
  }
}

// One tensor whose records a chunk stages: ``rec`` int32 words a record,
// record i at src + i * rec, staged into ``dst`` in shared memory (16-byte
// aligned).
struct StageSrc {
  const int* src;
  uint32_t* dst;
  int rec;
};

// Stages records [g, g + n) of each source (tensors of ``total`` records)
// into shared memory so that record g + k sits at dst + (lead + k) * rec,
// lead = g & 3, and returns lead; every thread of the CTA calls it, and the
// records are visible to all of them on return. With ``vec`` (every source
// on a 16-byte boundary) the chunk is widened to whole groups of four
// records, which start and end on 16-byte boundaries for any record size,
// and arrives by one bulk copy a source, all completing on ``bar`` (its
// parity in ``phase``, flipped here); where the widened chunk would read
// past the tensors, plain coalesced loads take its place. The caller
// synchronises the CTA before the next chunk overwrites the stage.
template <int N>
__device__ __forceinline__ int stage_chunk(const StageSrc (&s)[N], int g,
                                           int n, int total, bool vec,
                                           uint64_t* bar, int& phase) {
  const int ga = g & ~3;
  const int lead = g - ga;
  const int na = (lead + n + 3) & ~3;
  if (vec && ga + na <= total) {
    if (threadIdx.x == 0) {
      // The stage's last contents were read through the generic proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      int bytes = 0;
#pragma unroll
      for (int q = 0; q < N; ++q) bytes += na * s[q].rec * 4;
      barrier_expect(bar, bytes);
#pragma unroll
      for (int q = 0; q < N; ++q)
        bulk_copy(s[q].dst, s[q].src + static_cast<size_t>(ga) * s[q].rec,
                  na * s[q].rec * 4, bar);
    }
    barrier_wait(bar, phase);
    phase ^= 1;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q)
      for (int i = threadIdx.x; i < n * s[q].rec; i += blockDim.x)
        s[q].dst[lead * s[q].rec + i] = static_cast<uint32_t>(
            s[q].src[static_cast<size_t>(g) * s[q].rec + i]);
    __syncthreads();
  }
  return lead;
}

// The offset, in 4-byte words, of p from the 16-byte boundary below it.
__device__ __forceinline__ int quad_shift(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Every thread of the CTA writes image[0, len) to dst[0, len), where image
// lies as far from a 16-byte boundary as dst (``shift`` words): a few
// scalar stores at each end, 16-byte stores between.
__device__ __forceinline__ void write_range(int* dst, const uint32_t* image,
                                            int shift, int len) {
  const int head = min((4 - shift) & 3, len);
  if (static_cast<int>(threadIdx.x) < head)
    dst[threadIdx.x] = static_cast<int>(image[threadIdx.x]);
  const int quads = (len - head) / 4;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int4* s4 = reinterpret_cast<const int4*>(image + head);
  for (int i = threadIdx.x; i < quads; i += blockDim.x) d4[i] = s4[i];
  for (int k = head + 4 * quads + threadIdx.x; k < len; k += blockDim.x)
    dst[k] = static_cast<int>(image[k]);
}

}  // namespace psx
