// K8: bitstream placement as a gather, output-stationary: a CTA per range of
// a frame's output words, a thread per four of them.
//
// Replaces psxavenc_tpu/ops/bitpack_pallas.py::place_vals_gather_pallas
// (_gather_kernel). Plain version: ops/bitpack_cuda.py::
// place_vals_gather_plain; the plain model of this decomposition:
// ops/bitpack_cuda.py::place_vals_gather_ranges_plain. Same function as K4
// (csrc/bitpack_place.cu): frame b's word w is the OR of vals32[b, j, w -
// e0[b, j]] over the blocks j with 0 <= w - e0[b, j] < 9, for w < cap32.
//
// The TPU kernel finds each 128-lane output tile's candidate blocks with
// two searchsorteds over the monotone offsets, loads 32-row windows at
// 8-aligned starts from padded, sentinel-filled rows, applies nine
// compare/selects per candidate and sums over the candidates (the
// contributions are bit-disjoint). The scalar prefetch, the alignment and
// padding and the sequential grid do not carry over. Here the output is cut
// into ranges of ``range_words`` words (at most 4 x 256 - 4, so that 256
// threads of four words cover a range at any alignment), and a CTA owns one
// range of one frame (grid: frames x ranges, about four CTAs an SM, as K4).
// The CTA
//  1. brackets the blocks that reach the range, start - 8 <= e0 < end, with
//     K4's 256-ary search of the frame's e0 row (csrc/place_common.cuh);
//  2. stages the bracket's e0 entries and vals32 records in shared memory,
//     a chunk of up to 512 blocks at a time, by bulk copies that complete
//     on one mbarrier (widened to groups of four blocks; plain loads where
//     that would read past the tensors or they are not 16-byte aligned);
//  3. gives each thread four consecutive output words, those of one 16-byte
//     quad of the output, and finds each thread's first staged block (the
//     first with e0 >= its first word - 8) by a merge of the two sorted
//     sequences: staged block k writes its index for the threads whose
//     first word - 8 lies in (e0[k - 1], e0[k]], a run that no other block
//     writes (a binary search of the staged e0 by every thread read
//     0.0068-0.0069 ms where the merge reads 0.0067, PERF.md); the thread
//     walks the blocks from there up to e0 = its last word and ORs the
//     slots that land on its words in registers;
//  4. writes its words with one 16-byte store (scalar stores where the
//     quad is cut by the range's ends).
// Each word is computed from the records that reach it: no atomics, no
// image to zero, and the wrapper allocates with torch.empty. Words at or
// past cap32 lie in no range and are never computed, so the overrun of an
// unfittable frame drops, as in K4.
//
// What bounds it on the H100: memory traffic, the same bytes as K4 (each
// block's 40 bytes read once, the (B, cap32) words written once: 11.5 MB at
// 128 frames of 320x240 and 18,144 bytes, about 0.0034 ms at 3.35 TB/s); a
// CTA's own time is the latency of its search rounds and its copy, and the
// instructions of its merge and walk.
//
// Precondition: each frame's e0 row is non-decreasing, as for K4.
#include "place_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;  // blocks staged at a time

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ vals32, const int* __restrict__ e0,
              int nbe, int cap32, int range_words, int ranges,
              int total_blocks, int vec, int* __restrict__ out) {
  __shared__ __align__(16) uint32_t s_e[kChunk + 4];
  __shared__ __align__(16) uint32_t s_v[(kChunk + 4) * 9];
  __shared__ int s_first[kThreads];  // each thread's first staged block
  __shared__ __align__(8) uint64_t bar;

  const int b = blockIdx.x / ranges;
  const int start = (blockIdx.x - b * ranges) * range_words;
  const int len = min(range_words, cap32 - start);
  const int* e = e0 + b * nbe;
  int* dst = out + b * cap32 + start;
  // Thread t owns words [w_lo, w_lo + 4) of the range, a 16-byte quad of
  // the output (dst - shift is on a 16-byte boundary).
  const int shift = psx::quad_shift(dst);
  const int w_lo = 4 * static_cast<int>(threadIdx.x) - shift;
  const int w0 = start + w_lo;  // the frame's word
  if (threadIdx.x == 0) psx::barrier_init(&bar);

  // The search's barriers also order the barrier's init before its use.
  const int keys[2] = {start - 8, start + len};
  int j[2];
  psx::cta_lower_bounds(e, nbe, keys, j);

  // Thread t's first word is base + 4t.
  const int base = start - shift;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  int phase = 0;
  for (int j0 = j[0]; j0 < j[1]; j0 += kChunk) {
    const int n = min(kChunk, j[1] - j0);
    const psx::StageSrc src[2] = {{e0, s_e, 1}, {vals32, s_v, 9}};
    const int lead = psx::stage_chunk(src, b * nbe + j0, n, total_blocks,
                                      vec, &bar, phase);
    const int* se = reinterpret_cast<const int*>(s_e) + lead;
    // The merge: thread t's first block, the first with e0 >= base + 4t -
    // 8, is block k where se[k - 1] < base + 4t - 8 <= se[k], so block k
    // names the threads t in ((se[k - 1] + 8 - base) / 4, (se[k] + 8 -
    // base) / 4] (floored); those runs are disjoint.
    for (int k = 1 + threadIdx.x; k < n; k += kThreads) {
      const int t0 = max(((se[k - 1] + 8 - base) >> 2) + 1, 0);
      const int t1 = min((se[k] + 8 - base) >> 2, kThreads - 1);
      for (int t = t0; t <= t1; ++t) s_first[t] = k;
    }
    __syncthreads();
    if (w_lo < len && w0 + 3 >= se[0] && w0 - 8 <= se[n - 1]) {
      const int lo = w0 - 8 <= se[0] ? 0 : s_first[threadIdx.x];
      for (int k = lo; k < n; ++k) {
        const int d = w0 - se[k];  // the slot of word w0: -3..8
        if (d < -3) break;
        const uint32_t* v = s_v + (lead + k) * 9;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int slot = d + q;
          if (slot >= 0 && slot <= 8) acc[q] |= v[slot];
        }
      }
    }
    __syncthreads();  // the stage is read before it is filled again
  }

  if (w_lo >= 0 && w_lo + 4 <= len) {
    *reinterpret_cast<int4*>(dst + w_lo) =
        make_int4(static_cast<int>(acc[0]), static_cast<int>(acc[1]),
                  static_cast<int>(acc[2]), static_cast<int>(acc[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (w_lo + q >= 0 && w_lo + q < len)
        dst[w_lo + q] = static_cast<int>(acc[q]);
  }
}

}  // namespace

// ``range_words``: a multiple of 4, at most 4 * 256 - 4
// (ops/bitpack_cuda.py:gather_range_words); batch * nbe * 9 and batch *
// cap32 below 2^31.
extern "C" int psx_place_vals_gather(const void* vals32, const void* e0,
                                     int batch, int nbe, int cap32,
                                     int range_words, void* out,
                                     void* stream) {
  if (batch <= 0 || cap32 <= 0) return 0;
  if (range_words <= 0 || range_words % 4 ||
      range_words > 4 * kThreads - 4 || nbe <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ranges = (cap32 + range_words - 1) / range_words;
  const int vec = reinterpret_cast<uintptr_t>(vals32) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(e0) % 16 == 0;
  gather_kernel<<<batch * ranges, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vals32), static_cast<const int*>(e0), nbe,
      cap32, range_words, ranges, batch * nbe, vec, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
