// K4: bitstream placement, a CTA per range of a frame's output words.
//
// Replaces psxavenc_tpu/ops/bitpack_pallas.py::place_vals_mxu_pallas
// (_mxu_place_kernel). Plain version: ops/bitpack_cuda.py::place_vals_plain;
// the plain model of this decomposition: ops/bitpack_cuda.py::
// place_vals_ranges_plain.
//
// Each block contributes nine u32 words at u32 offset e0; contributions of
// different blocks are bit-disjoint, so a frame's word is the OR of the
// slots that land on it, in any order. The TPU kernel spread byte planes
// with one-hot bf16 matmuls because it has an MXU and no scatter. Here the
// output is cut into ranges of ``range_words`` words, and a CTA owns one
// range of one frame (grid: frames x ranges, so that a batch of 128 frames
// at 320x240 gives each SM four or five CTAs). The CTA
//  1. zeroes an image of its range in shared memory;
//  2. finds the blocks whose nine-word window overlaps the range, those
//     with start - 8 <= e0 < end, in the frame's non-decreasing e0 row:
//     every thread tests one entry a round and the count of entries below
//     the key narrows the bracket 256-fold, so two rounds of loads for a
//     row of up to 65,536 blocks instead of a dependent binary search;
//  3. stages those blocks' vals32 records, contiguous at 36 bytes a block,
//     into shared memory by one bulk copy a chunk of up to 512 blocks that
//     completes on an mbarrier (the copy is widened to whole groups of four
//     blocks, 144 bytes, so that it starts and ends on 16-byte boundaries;
//     where that would read past the tensor or the tensor is not 16-byte
//     aligned, plain coalesced loads take its place);
//  4. ORs each block's nine words into the image (a thread a block, shared-
//     memory atomicOr; nine words a block apart, so no two threads of a
//     warp read one bank);
//  5. writes the range once, zeros included, with 16-byte stores (the
//     image sits at the same offset from a 16-byte boundary as its words
//     in the output, so a few scalar stores at each end take the rest).
// No global atomics and no zero-fill: the wrapper allocates the output with
// torch.empty. Words at or past cap32 lie in no range, so the overrun of an
// unfittable frame (emitted at scale 1; the caller raises for it) drops.
// All index arithmetic is 32-bit (the wrapper checks the sizes).
//
// Precondition: each frame's e0 row is non-decreasing (K3's offsets and a
// cumsum of block bits are); K8 and K9 have the same.
//
// What bounds it on the H100: memory traffic, each block's 40 bytes read
// once and the (B, cap32) words written once (11.5 MB at 128 frames of
// 320x240 and 18,144 bytes, 0.0034 ms at 3.35 TB/s); a CTA's own time is
// the latency of its two search rounds and its copy.
#include "place_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;               // blocks staged at a time
constexpr int kStageWords = (kChunk + 4) * 9;  // a chunk and its slack

__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ vals32, const int* __restrict__ e0,
             int nbe, int cap32, int range_words, int ranges,
             int total_blocks, int vec, int* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(8) uint64_t bar;
  uint32_t* stage = smem;
  uint32_t* image_base = smem + kStageWords;  // range_words + 4 words

  const int b = blockIdx.x / ranges;
  const int start = (blockIdx.x - b * ranges) * range_words;
  const int len = min(range_words, cap32 - start);
  const int* e = e0 + b * nbe;
  int* dst = out + b * cap32 + start;
  // Word k of the range at image[k], as far from a 16-byte boundary as
  // dst + k.
  const int shift = psx::quad_shift(dst);
  uint32_t* image = image_base + shift;
  for (int i = threadIdx.x; i < range_words + 4; i += kThreads)
    image_base[i] = 0;
  if (threadIdx.x == 0) psx::barrier_init(&bar);

  // The search's barriers also order the zeroing and the barrier's init
  // before what follows.
  const int keys[2] = {start - 8, start + len};
  int j[2];
  psx::cta_lower_bounds(e, nbe, keys, j);

  int phase = 0;
  for (int j0 = j[0]; j0 < j[1]; j0 += kChunk) {
    const int n = min(kChunk, j[1] - j0);
    const psx::StageSrc src[1] = {{vals32, stage, 9}};
    const int lead = psx::stage_chunk(src, b * nbe + j0, n, total_blocks,
                                      vec, &bar, phase);
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int w0 = __ldg(e + j0 + k) - start;
      const uint32_t* v = stage + (lead + k) * 9;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const uint32_t x = v[s];
        const int w = w0 + s;
        if (x && static_cast<unsigned>(w) < static_cast<unsigned>(len))
          atomicOr(image + w, x);
      }
    }
    __syncthreads();  // the stage is read before it is filled again
  }
  __syncthreads();

  psx::write_range(dst, image, shift, len);
}

}  // namespace

// ``range_words``: a multiple of 4 (ops/bitpack_cuda.py:place_range_words);
// batch * nbe * 9 and batch * cap32 below 2^31.
extern "C" int psx_place_vals(const void* vals32, const void* e0, int batch,
                              int nbe, int cap32, int range_words, void* out,
                              void* stream) {
  if (batch <= 0 || cap32 <= 0) return 0;
  if (range_words <= 0 || range_words % 4 || nbe <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ranges = (cap32 + range_words - 1) / range_words;
  const size_t smem =
      static_cast<size_t>(kStageWords + range_words + 4) * sizeof(uint32_t);
  cudaFuncSetAttribute(place_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int vec = reinterpret_cast<uintptr_t>(vals32) % 16 == 0;
  place_kernel<<<batch * ranges, kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vals32), static_cast<const int*>(e0), nbe,
      cap32, range_words, ranges, batch * nbe, vec, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
