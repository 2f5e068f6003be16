// K3 and K7: winner emission + per-block packing, one thread per block,
// and the tail emission of blocks longer than the 256-bit window.
//
// K3 replaces psxavenc_tpu/ops/bs_pallas.py::emit_prep_pallas
// (_emit_prep_kernel, _emit_chunk_windows); plain version:
// ops/bs_cuda.py::emit_prep_plain. K7 replaces bs_pallas.py::
// emit_pack_pallas (_emit_pack_kernel); plain version: ops/bs_cuda.py::
// emit_pack_plain. The tail emission has no TPU kernel behind it: it
// replaces the flat re-pack that psxavenc_tpu/api.py:212-235 leaves to XLA;
// plain version: ops/bs_cuda.py::emit_tail_plain, the plain model of its
// decomposition ops/bs_cuda.py::emit_tail_lanes_plain. K3 and K7 run
// emit_block below, a thread a block; the tail emission runs a warp a block
// (emit_tail_block).
//
// emit_block, per block at the frame's chosen scale, in two passes:
//  A. find: the 63 AC positions are read once (no divide) and a 63-bit
//     mask of the positions whose level is nonzero is built: level != 0 iff
//     |c| >= ceil(d / 2);
//  B. walk: only the set bits are visited. Each is quantized (round half
//     away from zero by the exact div_floor, clamp to [-0x200, 0x1FE]), its
//     run is the distance to the set bit before it, its code comes from a
//     table in shared memory (levels up to 7 at runs up to 31, levels up to
//     40 at runs 0 and 1; else the 22-bit escape), and the code goes into a
//     64-bit shift register that hands a finished MSB-first u32 word to the
//     sink whenever 32 bits are full. A warp so lasts as long as its
//     busiest lane's nonzero count, not as long as the union of its lanes'.
// Word w of a block holds its bits [32w, 32w + 32). The window sink stores
// words 0..7 (the 256-bit window) in shared memory as they are finished
// (later words are dropped, block_bits counts them; eight registers chosen
// by a run-time index would cost sixteen instructions a word).
//
// K3 and K7 read the coefficients from a tile in shared memory, 63 rows by
// one block per thread, that the CTA fills asynchronously (no register held
// meanwhile): a thread that loads its own column from global memory waits
// for each of the 63 rows in turn. K3 fills its tile with 63 bulk copies of a
// row each, K7, whose rows may start on any boundary, with 16-byte cp.async
// copies or element by element.
//
// K3, one CTA per frame (a frame's blocks in as few even trips as 960
// threads allow, a tile per trip; the next trip's rows are asked into L2
// before a trip's emission, so that they leave HBM meanwhile), then:
//  2. a CTA-wide exclusive scan over the block totals, with the 10-bit EOF
//     block at index NB, gives each block's frame-global bit offset;
//  3. each block's windows, parked in shared memory meanwhile (in the
//     vals32 output itself for frames too large for that), are shifted to
//     their sub-word alignment with nine funnel shifts and rotated into
//     little-endian u16 pairs (ops/bitpack.py:streams_to_u32), at u32
//     offset e0 = goff >> 5, gathered in shared memory and written to
//     vals32 once, in whole lines.
// Outputs have NB + 1 entries per frame (no lane padding).
//
// K7, a 2-D grid (block tiles x frames), writes each block's windows as
// its 16-word u16 stream (word 2k = window k >> 16, word 2k + 1 = window k
// & 0xFFFF) with four 16-byte stores, and its bit count. It reads either
// coefficient form: K1's (64, nb_pad) int16 rows or the sweep's (63, NB)
// int32 rows; blocks at or past the true NB (dc_code's width) emit
// nothing.
//
// The tail emission, a launch after the placement kernel, ORs into the
// placed words the bits at or past in-block bit 256 of every block longer
// than that. A frame has ``ctas`` CTAs of 16 warps (grid: frames x ctas).
// Each reads the frame's block totals, coalesced: a frame without a long
// block leaves there. Otherwise the CTA copies the AC code table made at
// compile time (ac_codes.cuh) into shared memory and computes the 63
// divisors, reciprocals and thresholds of its frame's scale, while one pass
// over contiguous segments of the totals with two warp scans (totals and
// counts of long blocks) gives every long block's frame-global bit offset
// and its rank among the long blocks, in block order, so that every CTA of
// the frame lists them alike. The frame's warps take every (ctas x 16)-th
// of them, CTA c's warp w starting at rank 16c + w; the first CTA counts
// the frame. A warp emits a long block as a whole (emit_tail_block): lane
// l takes scan positions l and l + 32, loads both coefficients up front
// (for four blocks at a time, so that their loads are in flight together),
// tests them against the thresholds, and two ballots give the 63-bit mask
// of nonzero levels. Each lane quantizes its nonzero levels with the exact
// div_floor, takes each run from the mask (the highest set bit below its
// position) and looks its code up in the table (else the 22-bit escape).
// One inclusive warp scan of the two lengths, packed into one int, gives
// each code's in-block end; DC (at most 16 bits) ends far inside the
// window, the 2-bit EOB ends at the block's total. A code ending past bit
// 256 ORs its last min(end - 256, bits) bits into the placed words at the
// block's offset, one global atomicOr a touched u32 word (those words are
// shared with the placed windows and with the neighbouring blocks); u16
// words at or past the capacity drop. The critical path of a block is a
// round of loads, two of lookups in shared memory and a five-step scan.
//
// What bounds them on the H100: K3 the walk's dependent integer work and
// the arrival of a frame's first tile, during which nothing computes; K7 the
// bytes of its coefficients and streams; the tail emission the latency of
// a warp's rounds of loads, as its bytes are few. See PERF.md for the
// sections' cycles (K3's stats output).
#include "ac_codes.cuh"
#include "bs_common.cuh"

namespace {

constexpr int kMaxThreads = 960;   // K3: ten groups of 96
constexpr int kPackThreads = 96;   // K7
// A tile's row stride is a constant, so that the 63 row offsets of a
// column are immediates and not 63 registers.
constexpr int kTileStride = kMaxThreads;
constexpr int kTailWarps = 16;
constexpr int kTailThreads = 32 * kTailWarps;
constexpr int kTailGroup = 4;      // long blocks a warp loads at once
constexpr int kWindowBits = 256;
constexpr int kEmitStats = 8;  // ops/bs_cuda.py:EMIT_STAT_NAMES

// ---- asynchronous copies into shared memory
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}
// Asks L2 for ``bytes`` (a multiple of 16, from a 16-byte boundary) that a
// later copy will read, so that they leave HBM while the CTA computes.
__device__ __forceinline__ void prefetch_l2(const void* gmem, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(gmem),
               "r"(bytes));
}

// Bulk copies reporting to an mbarrier: bs_common.cuh.
using psx::barrier_expect;
using psx::barrier_init;
using psx::barrier_wait;
using psx::bulk_copy;
// ---- end of the asynchronous copies

// Starts the copy of a tile: rows[p * stride + n0 + t] for p < 63 and
// t < width (columns at or past ``stride`` are left out) into
// tile[p * kStride + t]. ``vec``: 16-byte copies (width, stride and n0 are
// multiples of 16 bytes of T and ``rows`` is so aligned); else element by
// element. cp_async_wait and a barrier complete it.
template <int kStride, typename T>
__device__ __forceinline__ void stage_tile(T* tile, const T* rows, int stride,
                                           int n0, int width, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int chunks = width / kVec;
    for (int i = threadIdx.x; i < 63 * chunks; i += blockDim.x) {
      const int p = i / chunks, t = (i - p * chunks) * kVec;
      if (n0 + t < stride)
        cp_async(tile + p * kStride + t,
                 rows + static_cast<size_t>(p) * stride + n0 + t, 16);
    }
  } else {
    for (int i = threadIdx.x; i < 63 * width; i += blockDim.x) {
      const int p = i / width, t = i - p * width;
      if (n0 + t >= stride) continue;
      const T* src = rows + static_cast<size_t>(p) * stride + n0 + t;
      T* dst = tile + p * kStride + t;
      if (sizeof(T) == 4) cp_async(dst, src, 4); else *dst = *src;
    }
  }
}

// The first warp starts the bulk copy of a tile of int16 rows (as
// stage_tile's, 16-byte aligned: whole rows of ``width`` columns, cut at
// ``stride``), a row per lane and instruction; barrier_wait(bar, phase)
// completes it. Every thread must have left the tile's last contents.
template <int kStride>
__device__ __forceinline__ void stage_tile_bulk(int16_t* tile,
                                                const int16_t* rows,
                                                int stride, int n0, int width,
                                                uint64_t* bar) {
  if (threadIdx.x >= 32) return;
  const int bytes = 2 * min(width, stride - n0);
  if (threadIdx.x == 0) barrier_expect(bar, 63 * bytes);
  __syncwarp();
  for (int p = threadIdx.x; p < 63; p += 32)
    bulk_copy(tile + p * kStride, rows + static_cast<size_t>(p) * stride + n0,
              bytes, bar);
}

// Per-frame tables in shared memory, filled by the CTA itself: the 63 AC
// divisors (psx::kQuantZZ times the frame's scale) with their f32
// reciprocals and their zero-test thresholds, and the AC codes
// (psx::ac_bits_code) as (bits << 24 | code of the positive level), 0 where
// the pair is an escape.
constexpr int kLow = 7 * 32, kHigh = 2 * 33;
struct EmitTables {
  int2 div[63];  // (divisor, bits of its f32 reciprocal)
  int thr[63];
  // [(level - 1) * 32 + run] for levels 1..7 at runs 0..31, then
  // [kLow + run * 33 + level - 8] for runs 0..1 at levels 8..40
  uint32_t code[kLow + kHigh];
};

__device__ __forceinline__ void load_tables(EmitTables& t, int s) {
  for (int i = threadIdx.x; i < kLow + kHigh + 63; i += blockDim.x) {
    if (i < kLow + kHigh) {
      const int j = i - kLow;
      const int r = i < kLow ? i & 31 : j / 33;
      const int a = i < kLow ? (i >> 5) + 1 : j % 33 + 8;
      int bits;
      uint32_t code;
      psx::ac_bits_code(r, a, bits, code);
      // No table code is as long as the 22-bit escape.
      const uint32_t e =
          bits == 22 ? 0u : (static_cast<uint32_t>(bits) << 24) | code;
      t.code[i] = e;
    } else {
      const int p = i - kLow - kHigh;
      const int d = psx::kQuantZZ[p] * s;
      t.div[p] = make_int2(d, __float_as_int(1.0f / static_cast<float>(d)));
      t.thr[p] = (d + 1) >> 1;
    }
  }
  __syncthreads();
}

// (bits, code) of the nonzero level ``ac`` at run ``r`` from the tables.
__device__ __forceinline__ void ac_lookup(const EmitTables& t, int r, int ac,
                                          int& bits, uint32_t& code) {
  // No branch: a warp's lanes hold levels of every size.
  const int a = ac < 0 ? -ac : ac;
  const bool low = a <= 7;
  const bool listed = low ? r < 32 : (a <= 40 && r < 2);
  const int at = low ? ((a - 1) << 5) + r : kLow + r * 33 + a - 8;
  const uint32_t e = listed ? t.code[listed ? at : 0] : 0u;
  if (e) {
    bits = static_cast<int>(e >> 24);
    code = (e & 0xFFFFFFu) | (ac < 0 ? 1u : 0u);
  } else {
    bits = 22;
    code = (1u << 16) | static_cast<uint32_t>((r << 10) | (ac & 0x3FF));
  }
}

// The shift register of the walk: codes enter at the low end, finished u32
// words leave from the top. ``fill`` < 32 between calls.
template <typename Sink>
struct BitWriter {
  Sink& sink;
  uint64_t buf = 0;
  int fill = 0, w = 0;
  __device__ __forceinline__ explicit BitWriter(Sink& s) : sink(s) {}
  // Appends a ``b``-bit code (0 <= b <= 32, no bits above b).
  __device__ __forceinline__ void put(int b, uint32_t code) {
    buf = (buf << b) | code;
    fill += b;
    if (fill >= 32) {
      fill -= 32;
      sink.word(w++, static_cast<uint32_t>(buf >> fill));
    }
  }
  // Hands over the last, partly filled word (zeros below its bits).
  __device__ __forceinline__ void finish() {
    if (fill) sink.word(w, static_cast<uint32_t>(buf << (32 - fill)));
  }
};

// Words 0..7 of a block (the 256-bit window), stored as they are finished:
// word w at ``at[w * step]``. Words the block does not reach are not
// written; load_windows reads them as zeros.
struct WindowSink {
  uint32_t* at;
  int step;
  __device__ __forceinline__ void word(int w, uint32_t v) {
    if (w < 8) at[w * step] = v;
  }
};

// The eight window words of a block of ``bits`` bits that a WindowSink
// stored at ``at``.
__device__ __forceinline__ void load_windows(uint32_t (&acc)[8],
                                             const uint32_t* at, int step,
                                             int bits) {
  const int words = (bits + 31) >> 5;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = k < words ? at[k * step] : 0u;
}

// The column of a ``width``-wide tile (a multiple of 96) that thread ``t``
// takes: a warp's lanes get blocks of one kind (a macroblock is Cr, Cb and
// four Y blocks in a row, and chroma blocks are the emptier), so that its
// lanes' walks are of like length.
__device__ __forceinline__ int lane_column(int t, int width) {
  const int per_kind = width / 6;
  return (t % per_kind) * 6 + t / per_kind;
}

// Emission of one block, whose coefficient at scan position p + 1 is
// ``col[p * kStride]``, into ``sink``; returns its bits (DC + ACs + EOB,
// uncut). The lanes of ``meet`` (all of the warp's lanes that make this
// call, or 0) meet after pass A, and ``find_end``, where not null,
// receives the clock there.
template <int kStride, typename T, typename Sink>
__device__ __forceinline__ int emit_block(const T* __restrict__ col, int dcb,
                                          uint32_t dcc, const EmitTables& t,
                                          Sink& sink, unsigned meet = 0,
                                          long long* find_end = nullptr) {
  uint32_t half[2] = {0, 0};
#pragma unroll
  for (int p = 0; p < 63; ++p) {
    const int c = col[p * kStride];
    const uint32_t nz = (c < 0 ? -c : c) >= t.thr[p];
    half[p >> 5] |= nz << (p & 31);
  }
  if (meet) __syncwarp(meet);
  if (find_end) *find_end = clock64();
  BitWriter<Sink> bw(sink);
  bw.put(dcb, dcc);
  int o = dcb, prev = -1;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    uint32_t mask = half[h];
    while (mask) {
      const int p = 32 * h + __ffs(static_cast<int>(mask)) - 1;
      mask &= mask - 1;
      const int c = col[p * kStride];
      const int2 dv = t.div[p];
      const int mag = psx::div_floor((c < 0 ? -c : c) + (dv.x >> 1), dv.x,
                                     __int_as_float(dv.y));
      const int ac = min(max(c < 0 ? -mag : mag, -0x200), 0x1FE);
      int bits;
      uint32_t code;
      ac_lookup(t, p - prev - 1, ac, bits, code);
      prev = p;
      bw.put(bits, code);
      o += bits;
    }
  }
  bw.put(2, 0x2u);  // EOB
  bw.finish();
  return o + 2;
}

// Exclusive scan in place over a[0..n) in shared memory; returns the total
// to every thread. ``scratch`` holds one int per warp.
__device__ int block_exclusive_scan(int* a, int n, int* scratch) {
  const int seg = (n + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * seg, n);
  const int end = min(beg + seg, n);
  int sum = 0;
  for (int i = beg; i < end; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = sum;  // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) before += scratch[w];
    total += scratch[w];
  }
  int run = before + x - sum;
  for (int i = beg; i < end; ++i) {
    const int t = a[i];
    a[i] = run;
    run += t;
  }
  __syncthreads();
  return total;
}

// Dynamic shared memory of K3: nb + 1 block totals (then offsets); unless
// ``kParkGlobal``, a block's eight raw windows between phases 1 and 3, window
// k of block n at [k * nb + n] (else they wait in the frame's vals32 rows);
// the trip's coefficient tile, 63 rows of kTileStride int16 values, which
// phase 3 reuses for the trip's nine placed words a block.
template <bool kParkGlobal>
__global__ void __launch_bounds__(kMaxThreads)
emit_prep_kernel(const int16_t* __restrict__ coefs_in, int nb_pad, int nb,
                 const int* __restrict__ scale_in,
                 const int* __restrict__ dc_code_in,
                 const int* __restrict__ dc_bits_in, int eof, int* vals_out,
                 int* __restrict__ e0_out, int* __restrict__ bbits_out,
                 int* __restrict__ total_out, int* __restrict__ stats_out) {
  extern __shared__ __align__(16) int goff[];
  __shared__ EmitTables tables;
  __shared__ int scratch[32];
  __shared__ __align__(8) uint64_t tile_bar;

  const int b = blockIdx.x;
  const int nbe = nb + 1;
  const int width = blockDim.x;
  const int16_t* coefs = coefs_in + static_cast<size_t>(b) * 64 * nb_pad;
  if (threadIdx.x == 0) barrier_init(&tile_bar);
  __syncthreads();
  int* vals = vals_out + static_cast<size_t>(b) * nbe * 9;
  uint32_t* park = kParkGlobal ? reinterpret_cast<uint32_t*>(vals)
                               : reinterpret_cast<uint32_t*>(goff + nbe);
  const int park_n = kParkGlobal ? 9 : 1, park_k = kParkGlobal ? 1 : nb;
  int* tile_words = goff + ((nbe + (kParkGlobal ? 0 : 8 * nb) + 3) & ~3);
  int16_t* tile = reinterpret_cast<int16_t*>(tile_words);
  // Statistics: the first lane of the last warp (a warp of luma blocks)
  // reads the clock; its warp meets before each reading, so that a section
  // is the warp's and not one lane's.
  __shared__ int st[kEmitStats];
  const bool stats_on = stats_out != nullptr;
  const bool timed = stats_on && threadIdx.x == blockDim.x - 32;
  long long t = 0;
  // The cycles since the last call, into column ``k``.
  auto lap = [&](int k) {
    if (timed) {
      const long long now = clock64();
      st[k] += static_cast<int>(now - t);
      t = now;
    }
  };
  if (timed) {
#pragma unroll
    for (int k = 0; k < kEmitStats; ++k) st[k] = 0;
    t = clock64();
  }
  stage_tile_bulk<kTileStride>(tile, coefs, nb_pad, 0, width, &tile_bar);
  load_tables(tables, scale_in[b]);
  const int column = lane_column(threadIdx.x, width);
  lap(0);

  // --- 1. per-block emission into registers; raw windows parked.
  int phase = 0;
  for (int n0 = 0; n0 < nb; n0 += width, phase ^= 1) {
    // The block's DC code is fetched while the tile is on its way.
    const int n = n0 + column;
    const size_t i = static_cast<size_t>(b) * nb + n;
    int dcb = 0;
    uint32_t dcc = 0;
    if (n < nb) {
      dcb = dc_bits_in[i];
      dcc = static_cast<uint32_t>(dc_code_in[i]);
    }
    long long tw = 0;
    if (timed) tw = clock64();
    barrier_wait(&tile_bar, phase);
    if (timed) st[6] += static_cast<int>(clock64() - tw);
    // The next trip's rows start towards L2 before this trip's emission.
    if (n0 + width < nb && threadIdx.x < 63)
      prefetch_l2(coefs + static_cast<size_t>(threadIdx.x) * nb_pad + n0 +
                      width,
                  2 * min(width, nb_pad - n0 - width));
    // With statistics a warp's emitting lanes meet around each pass.
    const unsigned meet = stats_on ? __ballot_sync(0xFFFFFFFFu, n < nb) : 0u;
    if (n < nb) {
      WindowSink sink{park + n * park_n, park_k};
      long long ta = 0, tb = 0;
      if (timed) ta = clock64();
      const int o = emit_block<kTileStride>(tile + column, dcb, dcc,
                                            tables, sink, meet,
                                            timed ? &tb : nullptr);
      if (meet) __syncwarp(meet);
      if (timed) {
        st[1] += static_cast<int>(tb - ta);
        st[2] += static_cast<int>(clock64() - tb);
      }
      goff[n] = o;
      bbits_out[i] = o;
    }
    if (timed) tw = clock64();
    __syncthreads();
    if (timed) st[7] += static_cast<int>(clock64() - tw);
    if (n0 + width < nb)
      stage_tile_bulk<kTileStride>(tile, coefs, nb_pad, n0 + width, width,
                                   &tile_bar);
  }
  if (threadIdx.x == 0) goff[nb] = 10;  // the end-of-frame code
  __syncthreads();
  lap(3);

  // --- 2. frame-global bit offsets.
  const int total = block_exclusive_scan(goff, nbe, scratch);
  if (threadIdx.x == 0) total_out[b] = total;
  lap(4);

  // --- 3. funnel shift + LE u16-pair packing (streams_to_u32): the
  // 256-bit stream moved down by g & 31 bits is nine MSB-first u32 words,
  // each stored with its halves swapped. A trip's words gather in shared
  // memory (9 words a block: no bank is hit twice) and leave in order.
  for (int n0 = 0; n0 < nbe; n0 += width) {
    const int n = n0 + threadIdx.x;
    if (n < nbe) {
      uint32_t acc[8];
      const int g = goff[n];
      if (n < nb) {
        load_windows(acc, park + n * park_n, park_k, goff[n + 1] - g);
      } else {
        // The EOF block: a lone 10-bit code at the top of window 0.
        acc[0] = static_cast<uint32_t>(eof) << 22;
#pragma unroll
        for (int k = 1; k < 8; ++k) acc[k] = 0;
      }
      const int sh = g & 31;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const uint32_t w = __funnelshift_r(j < 8 ? acc[j] : 0u,
                                           j > 0 ? acc[j - 1] : 0u, sh);
        tile_words[threadIdx.x * 9 + j] =
            static_cast<int>(__funnelshift_l(w, w, 16));
      }
      e0_out[static_cast<size_t>(b) * nbe + n] = g >> 5;
    }
    __syncthreads();
    const int count = min(width, nbe - n0) * 9;
    for (int i = threadIdx.x; i < count; i += width)
      vals[n0 * 9 + i] = tile_words[i];
    __syncthreads();
  }
  lap(5);
  if (timed)
    for (int k = 0; k < kEmitStats; ++k)
      stats_out[b * kEmitStats + k] = st[k];
}

template <typename T>
__global__ void __launch_bounds__(kPackThreads)
emit_pack_kernel(const T* __restrict__ coefs_in, int rows, int stride, int nb,
                 const int* __restrict__ scale_in,
                 const int* __restrict__ dc_code_in,
                 const int* __restrict__ dc_bits_in, int vec,
                 int* __restrict__ streams_out, int* __restrict__ bbits_out) {
  extern __shared__ __align__(16) int tile_words[];
  __shared__ EmitTables tables;
  __shared__ uint32_t windows[8 * kPackThreads];
  T* tile = reinterpret_cast<T*>(tile_words);
  const int b = blockIdx.y;
  const T* coefs = coefs_in + static_cast<size_t>(b) * rows * stride;
  const int n0 = blockIdx.x * kPackThreads;
  stage_tile<kPackThreads>(tile, coefs, stride, n0, kPackThreads, vec != 0);
  load_tables(tables, scale_in[b]);
  cp_async_wait();
  __syncthreads();
  const int column = lane_column(threadIdx.x, kPackThreads);
  const int n = n0 + column;
  if (n >= nb) return;
  const size_t i = static_cast<size_t>(b) * nb + n;
  WindowSink sink{windows + threadIdx.x, kPackThreads};
  const int bits = emit_block<kPackThreads>(
      tile + column, dc_bits_in[i], static_cast<uint32_t>(dc_code_in[i]),
      tables, sink);
  bbits_out[i] = bits;
  uint32_t acc[8];
  load_windows(acc, sink.at, kPackThreads, bits);
  int4* out = reinterpret_cast<int4*>(streams_out + i * 16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = make_int4(static_cast<int>(acc[2 * k] >> 16),
                       static_cast<int>(acc[2 * k] & 0xFFFFu),
                       static_cast<int>(acc[2 * k + 1] >> 16),
                       static_cast<int>(acc[2 * k + 1] & 0xFFFFu));
}

// The long blocks of a frame that has one, in block order: list[i] =
// (block, frame-global bit offset) of the i-th block over the 256-bit
// window; returns their count to every thread. Thread t takes the totals
// [t * seg, (t + 1) * seg): it sums them and counts its long blocks, two
// warp scans and the warps' sums give its segment's offset and rank, and
// it walks its segment again to list its long blocks. ``scratch``: 64
// ints.
__device__ int list_long_blocks(const int* __restrict__ bbits, int nb,
                                int2* list, int* scratch) {
  const int seg = (nb + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * seg, nb);
  const int end = min(beg + seg, nb);
  int sum = 0, cnt = 0;
#pragma unroll 4
  for (int i = beg; i < end; ++i) {
    const int o = bbits[i];
    sum += o;
    cnt += o > kWindowBits;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int xs = sum, xc = cnt;  // inclusive scans within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ys = __shfl_up_sync(0xFFFFFFFFu, xs, off);
    const int yc = __shfl_up_sync(0xFFFFFFFFu, xc, off);
    if (lane >= off) {
      xs += ys;
      xc += yc;
    }
  }
  if (lane == 31) {
    scratch[warp] = xs;
    scratch[32 + warp] = xc;
  }
  __syncthreads();
  int g = xs - sum, rank = xc - cnt, n_long = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    if (w < warp) {
      g += scratch[w];
      rank += scratch[32 + w];
    }
    n_long += scratch[32 + w];
  }
  for (int i = beg; i < end; ++i) {
    const int o = bbits[i];
    if (o > kWindowBits) list[rank++] = make_int2(i, g);
    g += o;
  }
  __syncthreads();
  return n_long;
}

// The frame's tables in shared memory: the AC codes (a copy of the table
// made at compile time, ac_codes.cuh) and, per scan position, the divisor at
// the frame's scale, its f32 reciprocal and the zero test's threshold
// (position 63, which no lane's second half has, never passes it).
struct TailTables {
  uint32_t code[psx::kAcLow + psx::kAcHigh];
  int d[64], thr[64];
  float rcp[64];
};

// Starts the copy of the code table (cp_async_wait completes it).
__device__ __forceinline__ void stage_tail_codes(TailTables& t) {
  for (int i = threadIdx.x; i < psx::kAcLow + psx::kAcHigh; i += blockDim.x)
    cp_async(t.code + i, psx::kAcCodes + i, 4);
}

// The divisors, reciprocals and thresholds at the frame's scale ``s``.
__device__ __forceinline__ void load_tail_divisors(TailTables& t, int s) {
  if (threadIdx.x < 64) {
    const int p = threadIdx.x;
    const int d = p < 63 ? psx::kQuantZZ[p] * s : 1;
    t.d[p] = d;
    t.rcp[p] = 1.0f / static_cast<float>(d);
    t.thr[p] = p < 63 ? (d + 1) >> 1 : 0x7FFFFFFF;
  }
}

// A lane's scan position of a long block: its divisor, reciprocal and
// threshold from the frame's tables.
struct LanePos {
  int d, thr;
  float rcp;
  __device__ __forceinline__ LanePos(const TailTables& t, int p)
      : d(t.d[p]), thr(t.thr[p]), rcp(t.rcp[p]) {}
  // The quantized level of a coefficient whose level is nonzero.
  __device__ __forceinline__ int level(int c) const {
    const int mag = psx::div_floor((c < 0 ? -c : c) + (d >> 1), d, rcp);
    return min(max(c < 0 ? -mag : mag, -0x200), 0x1FE);
  }
};

// (bits, code) of the nonzero level ``ac`` at run ``r`` from the frame's
// copy of the table made at compile time (ac_codes.cuh), or the 22-bit
// escape.
__device__ __forceinline__ void table_code(const TailTables& t, int r, int ac,
                                           int& bits, uint32_t& code) {
  const int a = ac < 0 ? -ac : ac;
  const bool low = a <= 7;
  const bool listed = low ? r < 32 : (a <= 40 && r < 2);
  const uint32_t e =
      listed ? t.code[low ? ((a - 1) << 5) + r : psx::kAcLow + r * 33 + a - 8]
             : 0u;
  if (e) {
    bits = static_cast<int>(e >> 24);
    code = (e & 0xFFFFFFu) | (ac < 0 ? 1u : 0u);
  } else {
    bits = 22;
    code = (1u << 16) | static_cast<uint32_t>((r << 10) | (ac & 0x3FF));
  }
}

// ORs the part at or past in-block bit 256 of a ``bits``-bit code that ends
// at in-block bit ``end`` into a frame's placed u32 words ``out`` (MSB-first
// u16 words as little-endian pairs, ops/bitpack.py:streams_to_u32), the
// block starting at frame bit ``g``: its last keep = min(end - 256, bits)
// bits at frame bits [g + end - keep, g + end). They lie in at most three
// u16 words, so in at most two u32 words, one atomicOr each; u16 words at
// or past ``cap_words`` drop.
__device__ __forceinline__ void or_tail(int* out, int g, int end, int bits,
                                        uint32_t code, int cap_words) {
  const int keep = min(end - kWindowBits, bits);
  if (keep <= 0) return;
  const int p = g + end - keep;
  const int k = p >> 4;
  // The kept bits, MSB-first, in the 48-bit window of u16 words k..k + 2.
  const uint64_t t = static_cast<uint64_t>(code & ((1u << keep) - 1u))
                     << (48 - (p & 15) - keep);
  uint64_t pairs = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (k + i < cap_words)
      pairs |= ((t >> (32 - 16 * i)) & 0xFFFFu) << (16 * i);
  // u16 word k + i is half (k + i) & 1 of u32 word (k + i) >> 1.
  pairs <<= 16 * (k & 1);
  const uint32_t lo = static_cast<uint32_t>(pairs);
  const uint32_t hi = static_cast<uint32_t>(pairs >> 32);
  if (lo) atomicOr(out + (k >> 1), static_cast<int>(lo));
  if (hi) atomicOr(out + (k >> 1) + 1, static_cast<int>(hi));
}

// One long block, emitted by a whole warp from its coefficients at the
// lane's positions (``ca`` at position lane, ``cb`` at lane + 32; 0 where
// none) and its DC code's length ``dcb``; its tail goes into ``out`` at
// frame bit ``g``.
__device__ __forceinline__ void emit_tail_block(int ca, int cb, int dcb,
                                                int g, const TailTables& t,
                                                const LanePos& pa,
                                                const LanePos& pb, int* out,
                                                int cap_words) {
  const int lane = threadIdx.x & 31;
  const bool nza = (ca < 0 ? -ca : ca) >= pa.thr;
  const bool nzb = (cb < 0 ? -cb : cb) >= pb.thr;
  const unsigned lo = __ballot_sync(0xFFFFFFFFu, nza);
  const unsigned hi = __ballot_sync(0xFFFFFFFFu, nzb);
  const unsigned below = (1u << lane) - 1u;
  // The nonzero position before each of the lane's own.
  const int prev_a = (lo & below) ? 31 - __clz(lo & below) : -1;
  const int prev_b = (hi & below) ? 63 - __clz(hi & below)
                                  : (lo ? 31 - __clz(lo) : -1);
  int bits_a = 0, bits_b = 0;
  uint32_t code_a = 0, code_b = 0;
  if (nza) table_code(t, lane - prev_a - 1, pa.level(ca), bits_a, code_a);
  if (nzb) table_code(t, lane + 31 - prev_b, pb.level(cb), bits_b, code_b);
  // Both lengths in one int: a half's sum is at most 32 x 22 bits.
  int x = bits_a | (bits_b << 16);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  const int all = __shfl_sync(0xFFFFFFFFu, x, 31);
  const int half = dcb + (all & 0xFFFF);  // DC and positions 0..31
  if (nza) or_tail(out, g, dcb + (x & 0xFFFF), bits_a, code_a, cap_words);
  if (nzb) or_tail(out, g, half + (x >> 16), bits_b, code_b, cap_words);
  if (lane == 31) or_tail(out, g, half + (all >> 16) + 2, 2, 0x2u, cap_words);
}

// Dynamic shared memory: the frame's long blocks, an int2 each (at most
// nb). ``ctas``: the CTAs of a frame, blockIdx.x = frame * ctas + part.
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
emit_tail_kernel(const T* __restrict__ coefs_in, int rows, int stride, int nb,
                 const int* __restrict__ scale_in,
                 const int* __restrict__ dc_bits_in,
                 const int* __restrict__ bbits_in, int ctas, int cap32,
                 int cap_words, int* out32, int* count) {
  extern __shared__ __align__(16) int2 list[];
  __shared__ TailTables tables;
  __shared__ int scratch[64];

  const int b = blockIdx.x / ctas;
  const int part = blockIdx.x - b * ctas;
  const int* bbits = bbits_in + b * nb;
  // The code table is on its way while the totals are read. A frame
  // without a long block leaves after one coalesced read of its totals.
  stage_tail_codes(tables);
  int any = 0;
#pragma unroll 4
  for (int n = threadIdx.x; n < nb; n += blockDim.x)
    any |= bbits[n] > kWindowBits;
  const bool some = __syncthreads_or(any);
  cp_async_wait();
  if (!some) return;
  if (part == 0 && threadIdx.x == 0) atomicAdd(count, 1);
  // The scan's barriers order the tables before their use.
  load_tail_divisors(tables, scale_in[b]);
  const int n_long = list_long_blocks(bbits, nb, list, scratch);

  const int lane = threadIdx.x & 31;
  const LanePos pa(tables, lane), pb(tables, lane + 32);
  const T* coefs = coefs_in + static_cast<size_t>(b) * rows * stride;
  const int* dcb_row = dc_bits_in + b * nb;
  int* out = out32 + b * cap32;
  const int cap_bits = cap_words * 16;
  const int warps = ctas * kTailWarps;  // the frame's warps
  for (int q0 = part * kTailWarps + (threadIdx.x >> 5); q0 < n_long;
       q0 += kTailGroup * warps) {
    int ca[kTailGroup], cb[kTailGroup], dcb[kTailGroup], g[kTailGroup];
    bool on[kTailGroup];
#pragma unroll
    for (int i = 0; i < kTailGroup; ++i) {
      const int q = q0 + i * warps;
      const int2 e = q < n_long ? list[q] : make_int2(0, cap_bits);
      // A tail that starts at or past the capacity drops whole.
      on[i] = e.y + kWindowBits < cap_bits;
      g[i] = e.y;
      ca[i] = cb[i] = dcb[i] = 0;
      if (on[i]) {
        const T* col = coefs + e.x;
        ca[i] = col[lane * stride];
        if (lane < 31) cb[i] = col[(lane + 32) * stride];
        dcb[i] = dcb_row[e.x];
      }
    }
#pragma unroll
    for (int i = 0; i < kTailGroup; ++i)
      if (on[i])
        emit_tail_block(ca[i], cb[i], dcb[i], g[i], tables, pa, pb, out,
                        cap_words);
  }
}

}  // namespace

// ``threads``: the CTA's width, a multiple of 96 up to 960 (the wrapper
// spreads the frame's blocks evenly over its trips); ``coefs`` is 16-byte
// aligned and nb_pad a multiple of 8; ``stats``: null, or (batch, 8) ints
// that receive the last warp's SM cycles per frame
// (ops/bs_cuda.py:EMIT_STAT_NAMES).
extern "C" int psx_emit_prep(const void* coefs, int batch, int nb_pad,
                             int nb, const void* scale, const void* dc_code,
                             const void* dc_bits, int eof, int threads,
                             void* vals32, void* e0, void* block_bits,
                             void* total_bits, void* stats,
                             void* stream) {
  if (batch == 0) return 0;
  if (threads < 96 || threads > kMaxThreads || threads % 96 || nb_pad % 8 ||
      reinterpret_cast<uintptr_t>(coefs) % 16)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // The raw windows wait in shared memory where a frame's fit.
  const size_t tile = static_cast<size_t>(63) * kTileStride * sizeof(int16_t);
  const size_t offsets = (static_cast<size_t>(nb + 1) + 3) / 4 * 16;
  const size_t parked = (static_cast<size_t>(9 * nb + 1) + 3) / 4 * 16;
  const bool park_global = parked + tile > 220 * 1024;
  const size_t smem = (park_global ? offsets : parked) + tile;
  auto kernel = park_global ? emit_prep_kernel<true> : emit_prep_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), nb_pad, nb,
      static_cast<const int*>(scale), static_cast<const int*>(dc_code),
      static_cast<const int*>(dc_bits), eof, static_cast<int*>(vals32),
      static_cast<int*>(e0), static_cast<int*>(block_bits),
      static_cast<int*>(total_bits), static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// coefs_int16: 1 for K1's (B, 64, nb_pad) int16 rows, 0 for (B, 63, NB)
// int32 rows; ``rows`` and ``stride`` are the coefficient tensor's last two
// dimensions.
extern "C" int psx_emit_pack(const void* coefs, int coefs_int16, int batch,
                             int rows, int stride, int nb, const void* scale,
                             const void* dc_code, const void* dc_bits,
                             void* streams, void* block_bits,
                             void* stream) {
  if (batch == 0 || nb == 0) return 0;
  const dim3 grid((nb + kPackThreads - 1) / kPackThreads, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(scale);
  const int* dcc = static_cast<const int*>(dc_code);
  const int* dcb = static_cast<const int*>(dc_bits);
  int* out = static_cast<int*>(streams);
  int* bb = static_cast<int*>(block_bits);
  // 16-byte copies where every row starts on a 16-byte boundary.
  const size_t elem = coefs_int16 ? sizeof(int16_t) : sizeof(int);
  const int vec = reinterpret_cast<uintptr_t>(coefs) % 16 == 0 &&
                  stride * elem % 16 == 0;
  const size_t smem = 63 * kPackThreads * elem;
  if (coefs_int16)
    emit_pack_kernel<int16_t><<<grid, kPackThreads, smem, s>>>(
        static_cast<const int16_t*>(coefs), rows, stride, nb, sc, dcc, dcb,
        vec, out, bb);
  else
    emit_pack_kernel<int><<<grid, kPackThreads, smem, s>>>(
        static_cast<const int*>(coefs), rows, stride, nb, sc, dcc, dcb, vec,
        out, bb);
  return static_cast<int>(cudaGetLastError());
}

// ORs into ``out32`` (batch, cap32) the bits at or past in-block bit 256 of
// every block whose ``block_bits`` entry is over 256, at the offsets the
// exclusive scan of ``block_bits`` gives; adds to ``count`` the number of
// frames with such a block. ``ctas``: CTAs a frame (ops/bs_cuda.py:
// tail_ctas); batch * ctas, batch * nb and batch * cap32 below 2^31.
// Coefficient forms as psx_emit_pack.
extern "C" int psx_emit_tail(const void* coefs, int coefs_int16, int batch,
                             int rows, int stride, int nb, const void* scale,
                             const void* dc_bits, const void* block_bits,
                             int ctas, int cap32, int cap_words, void* out32,
                             void* count, void* stream) {
  if (batch == 0 || nb == 0) return 0;
  if (ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(nb) * sizeof(int2);
  const int* sc = static_cast<const int*>(scale);
  const int* dcb = static_cast<const int*>(dc_bits);
  const int* bb = static_cast<const int*>(block_bits);
  int* out = static_cast<int*>(out32);
  int* cnt = static_cast<int*>(count);
  if (coefs_int16) {
    cudaFuncSetAttribute(emit_tail_kernel<int16_t>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    emit_tail_kernel<int16_t><<<batch * ctas, kTailThreads, smem, s>>>(
        static_cast<const int16_t*>(coefs), rows, stride, nb, sc, dcb, bb,
        ctas, cap32, cap_words, out, cnt);
  } else {
    cudaFuncSetAttribute(emit_tail_kernel<int>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    emit_tail_kernel<int><<<batch * ctas, kTailThreads, smem, s>>>(
        static_cast<const int*>(coefs), rows, stride, nb, sc, dcb, bb, ctas,
        cap32, cap_words, out, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
