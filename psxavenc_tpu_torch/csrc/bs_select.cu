// K1 and K6: first-fit quantization-scale search, one CTA per frame, the
// frame's coefficient magnitudes resident in shared memory.
//
// K1 replaces psxavenc_tpu/ops/bs_pallas.py::select_scale_pix_pallas
// (_select_pix_kernel, _search_store, _fused_probe, ladder_lb,
// _exact_totals); plain version: ops/bs_cuda.py::select_scale_pix_plain.
// K6 replaces bs_pallas.py::select_scale_pallas (_select_kernel); plain
// version: ops/bs_cuda.py::select_scale_plain. Both run search() below;
// ops/bs_cuda.py::select_search_plain is its model in plain torch,
// evaluation for evaluation, and the kernels' statistics output is held
// to it.
//
// What they compute. K1 FDCTs every block of the (64, NB) int8 pixel rows
// into the int16 signed zigzag coefficient output (row 63 and the pad
// lanes up to nb_pad are zero); K6 takes (63, NB) int32 rows. search()
// finds the first scale s in 1..63 whose exact AC bit total is <= thr_ac,
// the reference retry loop's choice (mdec.c:663-722); 64 = no scale fits
// (a negative threshold included), with bits and nz 0.
//
// What bounds them on the H100: the integer pipes' rate. The work the data
// needs is the FDCT plus two evaluations of the frame's 63 x NB
// coefficients (the exact total at the chosen scale, and proof that the
// scale below does not fit); memory traffic is an order less. So the
// design spends its effort on (a) evaluating as few scales as that, and
// (b) making one evaluation cost what its nonzero levels cost. A launch
// ends with its slowest frame (128 frames are one wave on 132 SMs), so
// the worst frame's evaluations count, not the mean's.
//
// Shared-memory budget. The search only reads |c|. One frame's 63 x NB
// magnitudes as 16-bit values are 63 x 1,800 x 2 = 226,800 bytes at
// 320x240; a CTA may use 232,448 (opt-in, set once per device with
// cudaFuncSetAttribute), which leaves 5,648; Shared below (reciprocals,
// two code-length tables, the reduction slots) takes 1,728. Rows have
// stride NB rounded up to even, so NB <= 1,830 fits. K1 writes each FDCT
// output twice, signed to global memory for K3 and as a magnitude to
// shared memory, and reads nothing back; K6 copies its frame once with
// 16-byte loads (58 MB per 128 frames: 0.017 ms at 3.35 TB/s). One CTA
// fills an SM.
//
// Two readers, one search. A frame that does not fit (640x480 is NB =
// 7,200), and a K6 frame holding a magnitude above 65,535 (found with a
// block-wide OR in the copy pass), is searched by the same code through
// GlobalReader, from global memory (K1: its own coefficient output).
// Which reader ran is a column of the statistics.
//
// One evaluation. A thread owns pairs of neighbouring blocks: one 32-bit
// load gives both blocks' magnitudes at a scan position. Pass A runs the
// 63 positions unrolled and branch-free and only decides level != 0, which
// is a >= d - (d >> 1), into a 63-bit mask per block, so a coefficient
// that quantizes to zero costs a compare and an OR. (Testing both halves
// of the word with one packed add was tried: the same time for K1, 9%
// more for K6, whose 64 registers it spilled. Pass B is what costs.)
// Pass B walks the set bits alone; the run
// length is a difference of bit positions. Per nonzero the ladder needs
// the level's class, five compares against multiples of d and no divide;
// the exact total divides with div_floor (f32 reciprocal estimate and the
// integer remainder correction, exact) and reads the code length from a
// 64 x 8 table that the CTA fills from psx::ac_bits at start (levels of 8
// and more take the closed form). The two blocks of a pair share one
// loop, and a warp's lanes take pairs of one kind (chroma, upper luma,
// lower luma: partial_totals), so a warp waits for about its mean pair.
//
// As few evaluations as the data needs. The ladder lower bound LB(s) <=
// exact(s) never rises with s (bs_pallas.py::ladder_lb proves both). The
// search keeps a bracket lo < hi with LB(lo) > thr (lo = 0: nothing known)
// and LB(hi) <= thr (hi = 64: nothing known); every step tightens it from
// a total it has just computed over the whole frame, never from a seed or
// the subsample, so any seed, right, wrong or out of range, ends at the
// same lower_bound hi, and the exact walk upward from hi gives the first
// fit. What chooses where to look: every eighth pair of blocks is a
// subsample whose ladder, times eight, stands for the frame's. Groups of
// whole warps probe different scales of it at once (3 groups of 128
// threads for K1 at 320x240, 7 for K6), so three or two rounds, each
// about one pair's latency, find its lower_bound s0. One fused pass over
// the whole frame then computes LB(s0 - 1) and exact(s0) from one pass A:
// if the first does not fit and the second does, the bracket is closed
// and the answer known, with the two evaluations the bound counts. When
// the subsample was off it is nearly always by one, and the pass says to
// which side, so up to three passes step that way before anything else:
// upward one exact evaluation is enough, because the bracket's lower end
// only has to mean "no scale up to here fits", which LB(s0 - 1) > thr
// and exact(s0) > thr already say of s0; downward it takes another fused
// pass. Only then does the search gallop and bisect with ladder
// evaluations and walk exact totals upward. The launch waits for exactly
// these frames, so the second pass is what set the time: stepping took
// K1 from 0.207 to 0.166 ms, where galloping from the first pass's
// bracket spent three ladder evaluations and an exact one, and the
// exact-only upward step to 0.158. The TPU kernel took a seed from the
// previous grid step; CTAs run in no order, so here the seed is an
// optional argument of the wrappers and only a hint: the subsample's first
// round probes the seed and the scale below it, and a seed that is right
// ends the rounds there. An earlier form that spent the fused pass on the
// seed itself was slower with the previous batch's last scale as seed than
// with none (0.236 against 0.208 ms): a wrong seed cost a whole pass. The
// frame encoder passes no seed: even as a hint such a seed made the launch
// longer (K1 0.163 against 0.158 ms, K6 0.186 against 0.151), and the
// answers themselves as seeds bought 2% and nothing, because the launch
// lasts as long as the frame whose subsample misses, whatever its seed.
//
// Measured (chip_smoke.py phases 3 and 10, B = 128, 320x240, 18,144-byte
// budgets, CUDA-graph replay, NVIDIA H100 80GB HBM3 at 700 W): K1 0.159 ms
// (0.482 before this design; bound 0.047), K6 0.152 ms (0.994; 0.035);
// 2.1-2.2 evaluations of the frame per frame where the bound counts 2.
// PERF.md has the runs, the cycles per phase and what still holds them.
#include "bs_common.cuh"

namespace {

// The most threads a launch may ask for; the wrapper's counts at 320x240.
// K1: the FDCT holds 64 values a thread (128 registers, so 480 threads,
// two even trips over 900 pairs, nothing spilled). K6: one pair a thread
// at 900 pairs, which leaves 64 registers: ptxas (CUDA 12.9) reaches them
// with 480 bytes of spill stores and 540 of loads in the kernel and 100
// and 120 in its ladder-only evaluation from shared memory; the fused
// evaluation spills nothing. chip_smoke.py prints the report of each build.
constexpr int kPixMaxThreads = 480;
constexpr int kCoefMaxThreads = 928;
constexpr int kSubsample = 8;          // self-seeding: every eighth pair
constexpr int kMaxGroups = 8;
constexpr int kNoScale = 1 << 20;      // a scale at which every level is 0
constexpr int kMaxFused = 3;           // passes that step before the gallop
// Statistics per frame: full ladder evaluations, fused passes, exact
// evaluations, self-seeding rounds, the reader (0 shared, 1 global), and
// the SM cycles (clock64) before the search, in self-seeding rounds and in
// full evaluations.
constexpr int kStats = 8;

struct Shared {
  float rcp[64];         // 1 / (q[p] * s) of the exact evaluation under way
  int slots[3][32];      // reductions: one slot per value and warp
  uint8_t bits[512];     // psx::ac_bits(run, level) at [run * 8 + level]
  uint8_t lad[512];      // the ladder's weight at [run * 8 + class]
  uint8_t q[64];         // psx::kQuantZZ, for a position known at run time
};
static_assert(sizeof(Shared) % 16 == 0, "the magnitudes follow, 16-byte "
                                        "aligned");

struct Totals {
  int lad, bits, nz;
};

// ---------------------------------------------------------------- readers

// The frame's magnitudes in shared memory: 16 bits each, row stride even,
// so one 32-bit word holds blocks 2j (low half) and 2j + 1.
struct SharedReader {
  const uint16_t* mags;
  int stride;
  __device__ __forceinline__ void pair(int p, int j, int& a0, int& a1) const {
    const uint32_t w =
        reinterpret_cast<const uint32_t*>(mags + p * stride)[j];
    a0 = static_cast<int>(w & 0xFFFFu);
    a1 = static_cast<int>(w >> 16);
  }
  __device__ __forceinline__ int one(int p, int n) const {
    return mags[p * stride + n];
  }
};

// The frame's signed coefficients in global memory.
template <typename T>
struct GlobalReader {
  const T* c;
  int stride, nb;
  __device__ __forceinline__ int one(int p, int n) const {
    const int v = c[static_cast<size_t>(p) * stride + n];
    return v < 0 ? -v : v;
  }
  __device__ __forceinline__ void pair(int p, int j, int& a0, int& a1) const {
    a0 = one(p, 2 * j);
    a1 = 2 * j + 1 < nb ? one(p, 2 * j + 1) : 0;
  }
};

// ------------------------------------------------------------- evaluation

__device__ void init_shared(Shared& sh) {
  for (int i = threadIdx.x; i < 512; i += blockDim.x) {
    const int run = i >> 3, k = i & 7;
    sh.bits[i] = k ? static_cast<uint8_t>(psx::ac_bits(run, k)) : 0;
    // Classes 0..5: levels 1, 2, 3, 4, 5-6, 7 and up (bs_pallas.py:
    // ladder_lb): the run-0 code length, plus for a run of one or more
    // min(class, 2), plus the run curve g.
    const int base = k == 0 ? 3 : k == 1 ? 5 : k == 2 ? 6 : k == 3 ? 8
                     : k == 4 ? 9 : 11;
    const int g = (run < 3 ? run : 3) + (run >= 5) + (run >= 8) +
                  (run >= 10) + 2 * (run >= 14) + (run >= 17);
    sh.lad[i] = static_cast<uint8_t>(
        base + (run >= 1 ? (k < 2 ? k : 2) : 0) + g);
  }
  for (int p = threadIdx.x; p < 63; p += blockDim.x)
    sh.q[p] = static_cast<uint8_t>(psx::kQuantZZ[p]);
}

// Sum over the nonzero levels of blocks 2j (mask words m[0], m[1]) and
// 2j + 1 (m[2], m[3]) at scale s: exact code lengths, or the ladder's
// weights. Bit b of mask word h is scan position 32 h + b + 1. One loop
// walks the four words, so a warp waits for its largest pair.
template <bool kExact, class Reader>
__device__ __forceinline__ int sum_pair(const Reader& rd, const Shared& sh,
                                        int j, int s,
                                        const uint32_t (&m)[4]) {
  int acc = 0, prev = -1, n = 2 * j, base = 0, word = 0;
  uint32_t w = m[0];
  for (;;) {
    while (w == 0) {
      if (++word == 4) return acc;
      w = word == 1 ? m[1] : word == 2 ? m[2] : m[3];
      base = (word & 1) << 5;
      if (word == 2) {
        prev = -1;
        n += 1;
      }
    }
    const int p = base + __ffs(static_cast<int>(w)) - 1;
    w &= w - 1;
    const int run = p - prev - 1;
    prev = p;
    const int d = sh.q[p] * s;
    const int t = rd.one(p, n) + (d >> 1);
    if (kExact) {
      const int level = psx::div_floor(t, d, sh.rcp[p]);
      acc += level < 8 ? sh.bits[run * 8 + level] : psx::ac_bits(run, level);
    } else {
      const int cls = (t >= 2 * d) + (t >= 3 * d) + (t >= 4 * d) +
                      (t >= 5 * d) + (t >= 7 * d);
      acc += sh.lad[run * 8 + cls];
    }
  }
}

// Adds pair j's ladder total at scale s_lad and, with kEx, its exact totals
// at scale s_ex to t, from one read of each magnitude. At kNoScale a mask
// is empty and its total 0.
template <bool kEx, class Reader>
__device__ __forceinline__ void eval_pair(const Reader& rd, const Shared& sh,
                                          int j, int s_lad, int s_ex,
                                          Totals& t) {
  // Pass A: nonzero masks, [2 * block + half]: level != 0 iff
  // a >= d - (d >> 1).
  uint32_t ml[4] = {0, 0, 0, 0}, me[4] = {0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < 63; ++p) {
    int a0, a1;
    rd.pair(p, j, a0, a1);
    const uint32_t bit = 1u << (p & 31);
    const int h = p >> 5;
    const int dl = psx::kQuantZZ[p] * s_lad;
    const int zl = dl - (dl >> 1);
    ml[h] |= a0 >= zl ? bit : 0u;
    ml[2 + h] |= a1 >= zl ? bit : 0u;
    if (kEx) {
      const int de = psx::kQuantZZ[p] * s_ex;
      const int ze = de - (de >> 1);
      me[h] |= a0 >= ze ? bit : 0u;
      me[2 + h] |= a1 >= ze ? bit : 0u;
    }
  }
  // Pass B: the nonzero levels alone.
  t.lad += sum_pair<false>(rd, sh, j, s_lad, ml);
  if (kEx) {
    t.bits += sum_pair<true>(rd, sh, j, s_ex, me);
    t.nz += __popc(me[0]) + __popc(me[1]) + __popc(me[2]) + __popc(me[3]);
  }
}

// This thread's totals over items first, first + step, ... below count.
// Item i is pair i * mul, or with `third` set (mul is 1 then) pair
// 3 (i % third) + i / third: a macroblock's three pairs are (Cr, Cb), (Y1,
// Y2), (Y3, Y4), and chroma quantizes to far fewer levels than luma, so
// this order gives a warp's lanes pairs of one kind and about equal work.
// One copy of the evaluation's code per reader and kEx, whoever calls.
template <bool kEx, class Reader>
__device__ __noinline__ Totals partial_totals(Reader rd, const Shared* sh,
                                              int first, int step, int count,
                                              int mul, int third, int s_lad,
                                              int s_ex) {
  Totals t = {0, 0, 0};
  for (int i = first; i < count; i += step) {
    const int j = third ? 3 * (i % third) + i / third : i * mul;
    eval_pair<kEx>(rd, *sh, j, s_lad, s_ex, t);
  }
  return t;
}

// Leaves each warp's sums of t in sh.slots (blockDim.x is a multiple of 32).
__device__ __forceinline__ void warp_sums(const Totals& t, Shared& sh) {
  int v[3] = {t.lad, t.bits, t.nz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xFFFFFFFFu, v[k], off);
    if ((threadIdx.x & 31) == 0) sh.slots[k][threadIdx.x >> 5] = v[k];
  }
  __syncthreads();
}

// Sum of value k's slots of warps [w0, w1).
__device__ __forceinline__ int slot_sum(const Shared& sh, int k, int w0,
                                        int w1) {
  int total = 0;
  for (int w = w0; w < w1; ++w) total += sh.slots[k][w];
  return total;
}

// One evaluation of the whole frame by the whole CTA, the totals returned
// to every thread: the ladder at s_lad and, with kEx, the exact totals at
// s_ex.
template <bool kEx, class Reader>
__device__ __forceinline__ Totals evaluate(const Reader& rd, Shared& sh,
                                           int npairs, int s_lad, int s_ex) {
  if (kEx) {
    for (int p = threadIdx.x; p < 63; p += blockDim.x)
      sh.rcp[p] = 1.0f / static_cast<float>(psx::kQuantZZ[p] * s_ex);
    __syncthreads();
  }
  const Totals t = partial_totals<kEx>(rd, &sh, threadIdx.x, blockDim.x,
                                       npairs, 1,
                                       npairs % 3 == 0 ? npairs / 3 : 0,
                                       s_lad, s_ex);
  warp_sums(t, sh);
  const int nwarps = (blockDim.x + 31) >> 5;
  Totals sum = {slot_sum(sh, 0, 0, nwarps), slot_sum(sh, 1, 0, nwarps),
                slot_sum(sh, 2, 0, nwarps)};
  __syncthreads();
  return sum;
}

// ----------------------------------------------------------------- search

// The scale group g of `groups` probes inside the open interval (lo, hi).
// With a hint inside it, the first two groups probe the hint and the scale
// below it, and the others spread as they would without.
__device__ __forceinline__ int group_probe(int lo, int hi, int g, int groups,
                                           int hint) {
  if (hint > lo && hint < hi) {
    if (g == 0) return hint;
    if (g == 1) return max(hint - 1, lo + 1);
    g -= 2;
    groups -= 2;
  }
  const int step = (hi - lo) * (g + 1) / (groups + 1);
  return min(lo + max(step, 1), hi - 1);
}

// A likely scale, 1..63, from the subsample (every kSubsample-th pair): the
// lower_bound of "its ladder, times kSubsample, fits", each round probing
// one scale per group of threads, the first round around `hint` (0: none).
template <class Reader>
__device__ int subsample_seed(const Reader& rd, Shared& sh, int npairs,
                              int thr, int hint, int& rounds) {
  int lo = 0, hi = 64;
  const int nsub = (npairs + kSubsample - 1) / kSubsample;
  const int nthreads = blockDim.x;
  const int gsize = min(nthreads, (nsub + 31) / 32 * 32);
  const int groups = min(nthreads / gsize, kMaxGroups);
  const int g = threadIdx.x / gsize;
  const int nwarps = (nthreads + 31) >> 5;
  while (hi - lo > 1) {
    Totals t = {0, 0, 0};
    if (g < groups)
      t = partial_totals<false>(rd, &sh, threadIdx.x - g * gsize, gsize, nsub,
                                kSubsample, 0,
                                group_probe(lo, hi, g, groups, hint), 0);
    warp_sums(t, sh);
    const int lo0 = lo, hi0 = hi;
    for (int k = 0; k < groups; ++k) {
      const int s = group_probe(lo0, hi0, k, groups, hint);
      const int total = slot_sum(sh, 0, k * gsize >> 5,
                                 min(((k + 1) * gsize + 31) >> 5, nwarps));
      if (static_cast<long long>(total) * kSubsample <= thr)
        hi = min(hi, s);
      else
        lo = max(lo, s);
    }
    __syncthreads();
    hint = 0;
    ++rounds;
  }
  return min(hi, 63);
}

// The first-fit search over one frame by the whole CTA; thread 0 stores
// the result. See the note at the top for why any seed is safe.
template <class Reader>
__device__ void search(const Reader& rd, Shared& sh, int nb, int thr,
                       int seed, int reader_id, long long start_clock,
                       int* scale_out, int* bits_out, int* nz_out,
                       int* stats) {
  const int npairs = (nb + 1) >> 1;
  const long long search_clock = clock64();
  long long seed_cycles = 0;
  // No scale up to lo fits (0: nothing known); LB(hi) <= thr (64: nothing
  // known). The answer is the first scale above lo whose exact total fits.
  int lo = 0, hi = 64;
  int n_lad = 0, n_fused = 0, n_exact = 0, n_sub = 0;

  // The subsample names a likely scale, looking first where the caller's
  // seed says. A fused pass, LB(s - 1) and exact(s) from one pass A over
  // the whole frame, then usually closes the bracket at once; when the
  // subsample was off, the answer is most often the next scale on the
  // side the pass points to, so up to kMaxFused passes step that way:
  // upward an exact evaluation is enough (every scale below is known
  // not to fit), downward it takes another fused pass.
  const long long c0 = clock64();
  int s = subsample_seed(rd, sh, npairs, thr,
                         seed >= 1 && seed <= 63 ? seed : 0, n_sub);
  seed_cycles += clock64() - c0;
  int es[kMaxFused] = {}, ebits[kMaxFused] = {}, enz[kMaxFused] = {};
  bool exact_only = false;
  for (int pass = 0; pass < kMaxFused; ++pass) {
    const int below = max(s - 1, 1);
    const Totals t =
        evaluate<true>(rd, sh, npairs, exact_only ? kNoScale : below, s);
    bool ladder_fits = false;
    if (exact_only) {
      ++n_exact;
    } else {
      ++n_fused;
      ladder_fits = t.lad <= thr;
      if (ladder_fits) hi = min(hi, below); else lo = max(lo, below);
    }
#pragma unroll
    for (int k = 0; k < kMaxFused; ++k)          // keep the exact totals
      if (k == pass) {
        es[k] = s;
        ebits[k] = t.bits;
        enz[k] = t.nz;
      }
    if (t.bits <= thr)
      hi = min(hi, s);                           // LB(s) <= exact(s)
    else if (lo >= s - 1)
      lo = max(lo, s);       // nothing below s fits, and s does not
    if (hi - lo <= 1) break;
    if (ladder_fits) {
      s = hi;                // the answer is below s: a fused pass there
      exact_only = false;
    } else if (s < 63) {
      s += 1;                // nothing up to s fits: is s + 1 the answer?
      exact_only = true;
    } else {
      break;
    }
  }

  // lower_bound of "the ladder fits": gallop away from a one-sided bracket
  // with doubling steps, bisect a two-sided one.
  int step = 1;
  while (hi - lo > 1) {
    int probe;
    if (lo == 0 && hi < 64) {
      probe = hi - step;
      step *= 2;
    } else if (hi == 64 && lo > 0) {
      probe = lo + step;
      step *= 2;
    } else {
      probe = (lo + hi) >> 1;
    }
    probe = min(max(probe, lo + 1), hi - 1);
    const Totals t = evaluate<false>(rd, sh, npairs, probe, 0);
    ++n_lad;
    if (t.lad <= thr) hi = probe; else lo = probe;
  }

  // The exact walk upward from the bound's answer.
  int scale = 64, bits = 0, nz = 0;
  for (s = hi; s < 64; ++s) {
    int b = -1, z = 0;
#pragma unroll
    for (int k = 0; k < kMaxFused; ++k)          // a fused pass's totals
      if (s == es[k]) {
        b = ebits[k];
        z = enz[k];
      }
    if (b < 0) {
      const Totals t = evaluate<true>(rd, sh, npairs, kNoScale, s);
      ++n_exact;
      b = t.bits;
      z = t.nz;
    }
    if (b <= thr) {
      scale = s;
      bits = b;
      nz = z;
      break;
    }
  }
  if (threadIdx.x == 0) {
    *scale_out = scale;
    *bits_out = bits;
    *nz_out = nz;
    if (stats) {
      stats[0] = n_lad;
      stats[1] = n_fused;
      stats[2] = n_exact;
      stats[3] = n_sub;
      stats[4] = reader_id;
      stats[5] = static_cast<int>(search_clock - start_clock);
      stats[6] = static_cast<int>(seed_cycles);
      stats[7] = static_cast<int>(clock64() - search_clock - seed_cycles);
    }
  }
}

// ---------------------------------------------------------------- kernels

// The dynamic shared memory holds Shared, then the frame's magnitudes.
__device__ __forceinline__ uint16_t* shared_mags(uint4* smem_raw) {
  return reinterpret_cast<uint16_t*>(smem_raw + sizeof(Shared) / 16);
}

__global__ void __launch_bounds__(kPixMaxThreads, 1)
select_pix_kernel(const int8_t* __restrict__ pix,
                  const int* __restrict__ thr_ac,
                  const int* __restrict__ seeds, int nb, int nb_pad,
                  int in_shared, int* __restrict__ scale_out,
                  int* __restrict__ bits_out, int* __restrict__ nz_out,
                  int16_t* coefs_out, int* __restrict__ stats) {
  extern __shared__ uint4 smem_raw[];
  const long long start_clock = clock64();
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  uint16_t* mags = shared_mags(smem_raw);
  const int stride = (nb + 1) & ~1;
  const int b = blockIdx.x;
  const int8_t* px = pix + static_cast<size_t>(b) * 64 * nb;
  int16_t* coefs = coefs_out + static_cast<size_t>(b) * 64 * nb_pad;
  init_shared(sh);

  // --- FDCT, one block per thread at a time: signed to global memory, the
  // magnitude to shared memory.
  for (int n = threadIdx.x; n < nb_pad; n += blockDim.x) {
    if (n >= nb) {
      for (int p = 0; p < 64; ++p) coefs[p * nb_pad + n] = 0;
      if (in_shared && n < stride)
        for (int p = 0; p < 63; ++p) mags[p * stride + n] = 0;
      continue;
    }
    int v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) v[i] = px[i * nb + n];
    psx::fdct_islow(v);
#pragma unroll
    for (int k = 1; k < 64; ++k) {
      const int row = psx::kZigzagRow[k];
      coefs[row * nb_pad + n] = static_cast<int16_t>(v[k]);
      if (in_shared)
        mags[row * stride + n] =
            static_cast<uint16_t>(v[k] < 0 ? -v[k] : v[k]);
    }
    coefs[63 * nb_pad + n] = 0;
  }
  // Makes the tables, the magnitudes and this CTA's coefficient stores
  // visible to all its threads.
  __syncthreads();

  const int seed = seeds ? seeds[b] : 0;
  int* st = stats ? stats + b * kStats : nullptr;
  if (in_shared)
    search(SharedReader{mags, stride}, sh, nb, thr_ac[b], seed, 0,
           start_clock, scale_out + b, bits_out + b, nz_out + b, st);
  else
    search(GlobalReader<int16_t>{coefs, nb_pad, nb}, sh, nb, thr_ac[b], seed,
           1, start_clock, scale_out + b, bits_out + b, nz_out + b, st);
}

__global__ void __launch_bounds__(kCoefMaxThreads, 1)
select_kernel(const int* __restrict__ c, const int* __restrict__ thr_ac,
              const int* __restrict__ seeds, int nb, int in_shared,
              int* __restrict__ scale_out, int* __restrict__ bits_out,
              int* __restrict__ nz_out, int* __restrict__ stats) {
  extern __shared__ uint4 smem_raw[];
  const long long start_clock = clock64();
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  uint16_t* mags = shared_mags(smem_raw);
  const int stride = (nb + 1) & ~1;
  const int b = blockIdx.x;
  const int* cf = c + static_cast<size_t>(b) * 63 * nb;
  init_shared(sh);

  // --- one pass over the frame: magnitudes to shared memory, and whether
  // every one fits 16 bits.
  int wide = 0;
  if (in_shared) {
    if (nb % 4 == 0 && reinterpret_cast<uintptr_t>(cf) % 16 == 0) {
      // stride == nb: the frame is one flat array in both memories.
      const int4* src = reinterpret_cast<const int4*>(cf);
      uint2* dst = reinterpret_cast<uint2*>(mags);
      const int nvec = 63 * nb / 4;
#pragma unroll 4
      for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const int4 v = src[i];
        const uint32_t a0 = v.x < 0 ? -v.x : v.x, a1 = v.y < 0 ? -v.y : v.y;
        const uint32_t a2 = v.z < 0 ? -v.z : v.z, a3 = v.w < 0 ? -v.w : v.w;
        wide |= (a0 | a1 | a2 | a3) >> 16;
        dst[i] = make_uint2((a0 & 0xFFFFu) | (a1 << 16),
                            (a2 & 0xFFFFu) | (a3 << 16));
      }
    } else {
      for (int i = threadIdx.x; i < 63 * stride; i += blockDim.x) {
        const int p = i / stride, n = i - p * stride;
        const int v = n < nb ? cf[p * nb + n] : 0;
        const uint32_t a = v < 0 ? -v : v;
        wide |= a >> 16;
        mags[i] = static_cast<uint16_t>(a);
      }
    }
  }
  // Also the barrier that makes the tables and the magnitudes visible.
  wide = __syncthreads_or(wide);

  const int seed = seeds ? seeds[b] : 0;
  int* st = stats ? stats + b * kStats : nullptr;
  if (in_shared && !wide)
    search(SharedReader{mags, stride}, sh, nb, thr_ac[b], seed, 0,
           start_clock, scale_out + b, bits_out + b, nz_out + b, st);
  else
    search(GlobalReader<int>{cf, nb, nb}, sh, nb, thr_ac[b], seed, 1,
           start_clock, scale_out + b, bits_out + b, nz_out + b, st);
}

// Shared-memory bytes of a launch and whether the frame's magnitudes are
// part of them: yes if they fit what a CTA of this device may opt in to.
int launch_shared_bytes(int nb, int* in_shared, cudaError_t* err) {
  int dev = 0, max_optin = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long need =
      static_cast<long long>(sizeof(Shared)) + 63LL * ((nb + 1) & ~1) * 2;
  *in_shared = *err == cudaSuccess && need <= max_optin;
  return static_cast<int>(*in_shared ? need : sizeof(Shared));
}

// Opts the kernel in to `bytes` of dynamic shared memory, once per device
// and size class (the attribute only ever grows).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || bytes <= allowed[dev]) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

bool bad_threads(int threads, int most) {
  return threads < 32 || threads > most || threads % 32 != 0;
}

}  // namespace

// The constants that ops/bs_cuda.py's plain model of the search has too;
// the wrappers compare the two copies before their first launch.
extern "C" int psx_select_constants(int* out) {
  const int values[6] = {kSubsample, kMaxGroups, kMaxFused, kPixMaxThreads,
                         kCoefMaxThreads, kStats};
  for (int i = 0; i < 6; ++i) out[i] = values[i];
  return 0;
}

extern "C" int psx_select_scale_pix(const void* pix, const void* thr_ac,
                                    const void* seeds, int batch, int nb,
                                    int nb_pad, int threads, void* scale,
                                    void* bits, void* nz, void* coefs,
                                    void* stats, void* stream) {
  static int allowed[64] = {0};
  if (batch == 0) return 0;
  if (bad_threads(threads, kPixMaxThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  int in_shared = 0;
  cudaError_t err;
  const int bytes = launch_shared_bytes(nb, &in_shared, &err);
  if (err == cudaSuccess)
    err = allow_shared(select_pix_kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_pix_kernel<<<batch, threads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pix), static_cast<const int*>(thr_ac),
      static_cast<const int*>(seeds), nb, nb_pad, in_shared,
      static_cast<int*>(scale), static_cast<int*>(bits),
      static_cast<int*>(nz), static_cast<int16_t*>(coefs),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psx_select_scale(const void* c, const void* thr_ac,
                                const void* seeds, int batch, int nb,
                                int threads, void* scale, void* bits,
                                void* nz, void* stats, void* stream) {
  static int allowed[64] = {0};
  if (batch == 0) return 0;
  if (bad_threads(threads, kCoefMaxThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  int in_shared = 0;
  cudaError_t err;
  const int bytes = launch_shared_bytes(nb, &in_shared, &err);
  if (err == cudaSuccess) err = allow_shared(select_kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<batch, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c), static_cast<const int*>(thr_ac),
      static_cast<const int*>(seeds), nb, in_shared, static_cast<int*>(scale),
      static_cast<int*>(bits), static_cast<int*>(nz),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}
