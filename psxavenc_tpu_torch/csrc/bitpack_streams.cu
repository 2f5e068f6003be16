// K10: dense per-block packing of symbol tensors, a warp per block, and K9:
// placement of the per-block streams, a CTA per range of a frame's words.
//
// K10 replaces psxavenc_tpu/ops/bitpack_pallas.py::pack_block_streams_pallas
// (_pack_kernel); plain version: ops/bitpack_cuda.py::
// pack_block_streams_plain (ops/bitpack.py:_pack_block_streams); the plain
// model of this decomposition: ops/bitpack_cuda.py::
// pack_block_streams_lanes_plain. Each block's S (code, bits) symbols are
// placed in order into eight MSB-first u32 windows and written as its
// 16-word u16 stream and its bit count. Symbols of 0 bits are skipped and
// each code is masked to its length, as the windowed shift/mask of
// _pack_block_streams does; bits past the 256th are cut there and here
// alike, and the bit count counts them.
//
// What bounds K10 on the H100: memory traffic, 2 x S int32 words read and
// 17 written per block (136 MB at 128 x 1,801 blocks of 65 symbols). So the
// CTAs are persistent (as many as fit on each SM) and stride over tiles of
// rows (a row is a block's S symbols, contiguous in the (B, NBe, S)
// tensors) that reach shared memory by bulk copies on a ring of three
// stages, each completing on its own mbarrier: while the CTA packs tile k,
// the copies of the next two are in flight. A tile is a multiple of 4 rows,
// so for any S it starts on a 16-byte boundary; a ragged last tile whose
// bytes are not a multiple of 16, or tensors not 16-byte aligned, are
// loaded with plain coalesced loads instead, and rows too long for three
// stages of four rows are read straight from global memory. A warp packs a
// row: lane l takes slots l, l + 32 and l + 64 of each 96, loaded together;
// three independent shuffle scans of their bit lengths, carried across
// rounds by the rounds' totals, give each symbol's offset; a code of at
// most 32 bits touches at most two of the eight windows, which the lanes
// OR into the warp's eight words in shared memory (atomicOr; the symbols'
// bits are disjoint); 16 lanes store the 16 u16 values as one 64-byte
// write. Packing, not the copies, takes most of a CTA's cycles (PERF.md:
// the kernel's stats_out sections); eight windows a lane ORed over the warp
// by __reduce_or_sync took longer than these shared-memory ORs (PERF.md).
//
// K9 replaces bitpack_pallas.py::place_streams_pallas (_kernel); plain
// version: ops/bitpack_cuda.py::place_streams_u32_plain (ops/bitpack.py:
// _place_streams_u32); the plain model of this decomposition:
// ops/bitpack_cuda.py::place_streams_ranges_plain. The TPU kernel swept
// each frame's blocks in order through a sliding 256-lane window with
// dynamic lane rotates, because it has no scatter. Here, as in K4
// (csrc/bitpack_place.cu), the output is cut into ranges of
// ``range_words`` words and a CTA owns one range of one frame (grid:
// frames x ranges, about four CTAs an SM). The CTA zeroes an image of its
// range in shared memory; brackets the blocks whose nine placed words reach
// the range, 32 (start - 8) <= goff < 32 end, with K4's 256-ary search of
// the frame's non-decreasing goff row (csrc/place_common.cuh); stages
// their 64-byte streams by bulk copies on an mbarrier, up to 512 blocks at
// a time; turns each block's stream into its nine placed u32 words
// (psx::stream_to_u32, a thread a block) and ORs them into the image
// (shared-memory atomicOr; different blocks' words are bit-disjoint, so
// the order does not matter); and writes the range once, zeros included,
// with 16-byte stores. No global atomics and no zero-fill: the wrapper
// allocates with torch.empty. Words at or past cap32 lie in no range, so
// they drop (the TPU kernel instead clamps its flushes for an unfittable
// frame). What bounds it: memory traffic, each block's 64-byte stream and
// offset read once and the (B, cap32) words written once.
// Precondition: each frame's goff row is non-decreasing (an exclusive
// cumsum of block bits is).
#include "place_common.cuh"

namespace {

constexpr int kPackWarps = 8;
constexpr int kPackThreads = 32 * kPackWarps;
constexpr int kStages = 3;
constexpr int kMaxTileRows = 32;
constexpr int kStageBytes = 56 * 1024;   // a CTA's ring, at most
constexpr unsigned kAllLanes = 0xFFFFFFFFu;  // a row's whole warp (lanes
                                             // past S carry 0-bit symbols)
constexpr int kPlaceThreads = 256;
constexpr int kPlaceChunk = 512;  // blocks staged at a time
constexpr int kPlaceStageWords = (kPlaceChunk + 4) * 16;
// tiles, cycles waiting for tiles, packing (warp 0's rows), at the tile's
// closing barrier, in all; the grid, CTAs an SM, the SM
constexpr int kPackStats = 8;

// ORs a b-bit code (1 <= b <= 32, no bits above b) into the warp's eight
// MSB-first u32 windows ``win`` (shared memory) at bit o: it spans windows
// o >> 5 and the next; bits past the 256th drop. The symbols' bits are
// disjoint, so the order of the ORs does not matter.
__device__ __forceinline__ void place_shared(unsigned* win, int o, int b,
                                             uint32_t code) {
  const int q = o >> 5;
  if (q >= 8) return;
  const uint64_t v = static_cast<uint64_t>(code) << (64 - (o & 31) - b);
  atomicOr(win + q, static_cast<uint32_t>(v >> 32));
  if (q < 7) atomicOr(win + q + 1, static_cast<uint32_t>(v));
}

// Inclusive sum over the warp's lanes.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAllLanes, x, off);
    if (lane >= off) x += v;
  }
  return x;
}

// One block's symbols c[0..nsym), bl[0..nsym) (shared or global memory),
// packed by the calling warp into stream[0..16) and *total, through the
// warp's zeroed windows ``win`` (which it leaves zeroed). Lane l takes
// slots l, l + 32 and l + 64 of each 96, loaded together; their three
// scans are independent, and the rounds' totals carry the offsets.
__device__ __forceinline__ void pack_row(const int* c, const int* bl,
                                         int nsym, int lane, unsigned* win,
                                         int* stream, int* total) {
  int carry = 0;  // the bits of the slots before
  for (int i0 = 0; i0 < nsym; i0 += 96) {
    int b[3], incl[3];
    uint32_t code[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = i0 + 32 * j + lane;
      b[j] = i < nsym ? bl[i] : 0;
      code[j] = i < nsym ? static_cast<uint32_t>(c[i]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) incl[j] = warp_scan(b[j], lane);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (b[j] > 0)
        place_shared(win, carry + incl[j] - b[j], b[j],
                     code[j] & (b[j] >= 32 ? 0xFFFFFFFFu
                                           : (1u << b[j]) - 1u));
      carry += __shfl_sync(kAllLanes, incl[j], 31);
    }
  }
  __syncwarp();
  if (lane < 16) {
    const uint32_t w = win[lane >> 1];
    stream[lane] = static_cast<int>(lane & 1 ? w & 0xFFFFu : w >> 16);
  }
  if (lane == 0) *total = carry;
  __syncwarp();
  if (lane < 8) win[lane] = 0;
  __syncwarp();
}

// ``tile_rows``: rows a tile (a multiple of 4), or 0 to read every row from
// global memory. ``bulk``: both tensors start on 16-byte boundaries.
// ``stats`` (``stats_rows`` rows of kPackStats, or null): per CTA, as
// ops/bitpack_cuda.py:PACK_STAT_NAMES; thread 0 reads the clock.
__global__ void __launch_bounds__(kPackThreads, 4)
pack_kernel(const int* __restrict__ codes, const int* __restrict__ bits,
            long long rows, int nsym, int tile_rows, int bulk,
            int* __restrict__ streams, int* __restrict__ block_bits,
            int* __restrict__ stats, int stats_rows, int per_sm) {
  extern __shared__ __align__(16) int ring[];
  __shared__ uint64_t bars[kStages];
  __shared__ unsigned windows[kPackWarps][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* win = windows[warp];
  if (lane < 8) win[lane] = 0;
  __syncwarp();
  const bool timed = stats != nullptr && threadIdx.x == 0 &&
                     static_cast<int>(blockIdx.x) < stats_rows;
  long long st[kPackStats] = {};
  const long long t_start = clock64();
  if (tile_rows == 0) {
    for (long long r = static_cast<long long>(blockIdx.x) * kPackWarps + warp;
         r < rows; r += static_cast<long long>(gridDim.x) * kPackWarps)
      pack_row(codes + r * nsym, bits + r * nsym, nsym, lane, win,
               streams + r * 16, block_bits + r);
    return;
  }
  const int tile_words = tile_rows * nsym;
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  auto tile_len = [&](long long t) {
    return static_cast<int>(min(static_cast<long long>(tile_rows),
                                rows - t * tile_rows));
  };
  // A tile goes by bulk copy when its bytes are a multiple of 16 too.
  auto by_bulk = [&](long long t) {
    return bulk && (tile_len(t) * nsym) % 4 == 0;
  };
  auto fetch = [&](long long t, int s) {
    const int bytes = tile_len(t) * nsym * 4;
    const size_t w0 = static_cast<size_t>(t) * tile_words;
    int* sc = ring + s * 2 * tile_words;
    psx::barrier_expect(&bars[s], 2 * bytes);
    psx::bulk_copy(sc, codes + w0, bytes, &bars[s]);
    psx::bulk_copy(sc + tile_words, bits + w0, bytes, &bars[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) psx::barrier_init(&bars[s]);
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (t < ntiles && by_bulk(t)) fetch(t, s);
    }
  }
  __syncthreads();

  unsigned phase = 0;  // bit s: the parity of stage s's next phase
  int s = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int* sc = ring + s * 2 * tile_words;
    int* sb = sc + tile_words;
    const long long r0 = t * tile_rows;
    const int nr = tile_len(t);
    long long t0 = timed ? clock64() : 0;
    if (by_bulk(t)) {
      psx::barrier_wait(&bars[s], (phase >> s) & 1);
      phase ^= 1u << s;
    } else {
      const size_t w0 = static_cast<size_t>(r0) * nsym;
      for (int i = threadIdx.x; i < nr * nsym; i += kPackThreads) {
        sc[i] = codes[w0 + i];
        sb[i] = bits[w0 + i];
      }
      __syncthreads();
    }
    if (timed) {
      const long long now = clock64();
      st[1] += now - t0;
      t0 = now;
    }
    for (int r = warp; r < nr; r += kPackWarps)
      pack_row(sc + r * nsym, sb + r * nsym, nsym, lane, win,
               streams + (r0 + r) * 16, block_bits + r0 + r);
    if (timed) {
      const long long now = clock64();
      st[2] += now - t0;
      t0 = now;
    }
    __syncthreads();  // every warp has left the stage
    if (threadIdx.x == 0) {
      const long long next = t + static_cast<long long>(kStages) * gridDim.x;
      if (next < ntiles && by_bulk(next)) fetch(next, s);
    }
    if (timed) {
      st[3] += clock64() - t0;
      ++st[0];
    }
    s = s + 1 == kStages ? 0 : s + 1;
  }
  if (timed) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    st[4] = clock64() - t_start;
    st[5] = gridDim.x;
    st[6] = per_sm;
    st[7] = sm;
    for (int k = 0; k < kPackStats; ++k)
      stats[blockIdx.x * kPackStats + k] = static_cast<int>(st[k]);
  }
}

__global__ void __launch_bounds__(kPlaceThreads)
place_streams_kernel(const int* __restrict__ streams,
                     const int* __restrict__ goff, int nbe, int cap32,
                     int range_words, int ranges, int total_blocks, int vec,
                     int* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(8) uint64_t bar;
  uint32_t* stage = smem;
  uint32_t* image_base = smem + kPlaceStageWords;  // range_words + 4 words

  const int b = blockIdx.x / ranges;
  const int start = (blockIdx.x - b * ranges) * range_words;
  const int len = min(range_words, cap32 - start);
  const int* g_row = goff + b * nbe;
  int* dst = out + b * cap32 + start;
  // Word k of the range at image[k], as far from a 16-byte boundary as
  // dst + k.
  const int shift = psx::quad_shift(dst);
  uint32_t* image = image_base + shift;
  for (int i = threadIdx.x; i < range_words + 4; i += kPlaceThreads)
    image_base[i] = 0;
  if (threadIdx.x == 0) psx::barrier_init(&bar);

  // A block's nine words start at u32 word goff >> 5. The search's
  // barriers also order the zeroing and the barrier's init before what
  // follows.
  const int keys[2] = {32 * (start - 8), 32 * (start + len)};
  int j[2];
  psx::cta_lower_bounds(g_row, nbe, keys, j);

  int phase = 0;
  for (int j0 = j[0]; j0 < j[1]; j0 += kPlaceChunk) {
    const int n = min(kPlaceChunk, j[1] - j0);
    const psx::StageSrc src[1] = {{streams, stage, 16}};
    const int lead = psx::stage_chunk(src, b * nbe + j0, n, total_blocks,
                                      vec, &bar, phase);
    for (int k = threadIdx.x; k < n; k += kPlaceThreads) {
      const uint4* s4 = reinterpret_cast<const uint4*>(stage) + (lead + k) * 4;
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 x = s4[q];
        w[4 * q] = x.x;
        w[4 * q + 1] = x.y;
        w[4 * q + 2] = x.z;
        w[4 * q + 3] = x.w;
      }
      const int g = __ldg(g_row + j0 + k);
      uint32_t v[9];
      psx::stream_to_u32(w, g, v);
      const int w0 = (g >> 5) - start;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const int word = w0 + s;
        if (v[s] && static_cast<unsigned>(word) < static_cast<unsigned>(len))
          atomicOr(image + word, v[s]);
      }
    }
    __syncthreads();  // the stage is read before it is filled again
  }
  __syncthreads();

  psx::write_range(dst, image, shift, len);
}

}  // namespace

extern "C" int psx_pack_block_streams(const void* codes, const void* bits,
                                      int rows, int nsym, void* streams,
                                      void* block_bits, void* stats,
                                      int stats_rows, void* stream) {
  if (rows == 0) return 0;
  int tile_rows = kMaxTileRows;
  while (tile_rows > 0 &&
         static_cast<size_t>(kStages) * 2 * tile_rows * nsym * 4 > kStageBytes)
    tile_rows -= 4;
  if (nsym == 0) tile_rows = 0;
  const int bulk = tile_rows > 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  const int smem = kStages * 2 * tile_rows * nsym * 4;
  cudaFuncSetAttribute(pack_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_kernel,
                                                kPackThreads, smem);
  const long long units = tile_rows
                              ? (rows + tile_rows - 1) / tile_rows
                              : (rows + kPackWarps - 1) / kPackWarps;
  const int grid = static_cast<int>(std::min<long long>(
      units, static_cast<long long>(psx::sm_count()) * std::max(per_sm, 1)));
  pack_kernel<<<grid, kPackThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), static_cast<const int*>(bits), rows,
      nsym, tile_rows, bulk, static_cast<int*>(streams),
      static_cast<int*>(block_bits), static_cast<int*>(stats), stats_rows,
      per_sm);
  return static_cast<int>(cudaGetLastError());
}

// ``range_words``: a multiple of 4, at most 4,096
// (ops/bitpack_cuda.py:place_range_words); batch * nbe * 16 below 2^31 and
// 32 * (cap32 + 8) below 2^31.
extern "C" int psx_place_streams(const void* streams, const void* goff,
                                 int batch, int nbe, int cap32,
                                 int range_words, void* out, void* stream) {
  if (batch <= 0 || cap32 <= 0) return 0;
  if (range_words <= 0 || range_words % 4 || range_words > 4096 || nbe <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ranges = (cap32 + range_words - 1) / range_words;
  const size_t smem = static_cast<size_t>(kPlaceStageWords + range_words + 4) *
                      sizeof(uint32_t);
  cudaFuncSetAttribute(place_streams_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int vec = reinterpret_cast<uintptr_t>(streams) % 16 == 0;
  place_streams_kernel<<<batch * ranges, kPlaceThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(goff), nbe,
      cap32, range_words, ranges, batch * nbe, vec, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
