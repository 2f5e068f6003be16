// K5: ADPCM unit encoder with decoder-state threading over time.
//
// Replaces psxavenc_tpu/ops/adpcm_pallas.py::encode_units_pallas (_kernel).
// Plain version: ops/adpcm.py::encode_units_scan (packed by
// ops/adpcm_cuda.py::encode_units_plain); plain model of the segmented
// scheme: ops/adpcm_cuda.py::encode_units_segmented_plain.
//
// The input. Each stream is a row of int16 PCM, n samples; unit t of
// stream b starts at sample offsets[b * T + t] of its stream (the CLI's
// chunk layout, where a chunk's last unit is partial and the next chunk
// starts at the next sample), or at 28 t where offsets is null (the dense
// layout: the tensor API's (B, T, 28) units). The rows are either the
// rows of one (B, n) tensor, or, in the shared row (the batch runner's
// grouped call), every stream's samples back to back in one unpadded row:
// stream b is the len[b] samples from base[b]. A lane reads its two
// samples straight from the PCM. On the chunk layout and in the shared
// row the index is clamped to [0, n - 1] (n = len[b]) as ops/
// adpcm_cuda.py::gather_units_plain clamps it: a unit past the end
// repeats the last sample and its limit masks it; a stream of no samples
// reads zeros. The dense layout has n = 28 T (the wrapper holds it), so
// its indices need no clamp. No unit tensor is materialised: a sample
// costs 2 bytes on the card, a unit 4 more for its offset on the chunk
// layout; the shared row pads only the (B, T) limits and outputs.
//
// Per stream and per 28-sample unit, in time order: samples at or past the
// unit's limit count as 0; each filter's minimum shift comes from the
// residual extrema of the raw samples; every (filter, shift) candidate
// (3 shifts per filter, filter-major, shift ascending) runs the 28-step
// quantize/decode recurrence with the exact squared error; the first
// strictly best candidate gives the header, the packed sample words and
// the post-unit state, which the next unit starts from.
//
// The unit. A lane group of 16 encodes one unit: lane c runs candidate c,
// lanes at or past C run a copy of candidate 0 (it ties with candidate 0
// and loses on index). The unit is staged in shared memory; lane l folds
// the residuals of samples l and l+16 for every filter. The group reduces
// the extrema, then the winner, the least (error, candidate index):
// exactly "first strictly better". Where two groups share a warp the
// reductions are 16-lane xor shuffles; where a group has its warp alone
// (the walk) they are redux.sync, the winner on a 41-bit key (error << 4
// | index): fewer and shorter steps than the shuffles, but on the card a
// warp of two groups, each reducing under its own mask, ran slower with
// them. The next unit's samples and limit are loaded into registers while
// this one is encoded.
//
// Two routes. The TPU kernel made time a sequential grid axis with the
// state in VMEM scratch. Here:
// - Serial (S = 1, when the batch alone fills the card): a group walks one
//   stream in time order, two streams a warp in lockstep (a stream past
//   the batch edge computes on a clamped stream and stores nothing).
// - Segmented (S > 1, few streams): each stream is cut into S segments,
//   the plan's [k T / S, (k+1) T / S), and
//   1. spec_kernel encodes every segment at once, a group each: a stream's
//      first segment from the caller's state, every other from a guess
//      (the two raw samples before a warm-up of `warmup` units, masked by
//      their unit's limit) run through the warm-up, whose outputs are
//      dropped. It stores each segment's start state and end state.
//   2. `rounds` launches of round_kernel: a segment whose start state
//      differs from the (snapshot of the) end state of the segment before
//      it re-encodes from that state, overwriting each unit, and stops
//      after the first unit whose post-state equals the one stored there.
//   3. walk_kernel, a warp a stream: in time order it compares each
//      segment's start with the true state before it (16 boundaries a
//      step) and, where they differ, re-encodes unit by unit from the
//      true state, across segment ends, until a post-state equals the
//      stored one.
// Why that is exact. A unit's outputs depend only on the state before it
// and its own samples and limit. Every stored segment is the exact encode
// of its stored start state (a repair keeps that: after a merged unit the
// stored run goes on from the same state). So a segment whose start state
// is the true state before it is exact, and the walk makes every start
// true in time order. Nothing rests on a merge: where trajectories never
// meet (a loud steady tone) the walk re-encodes the stream, the serial
// route's work plus one launch of speculation and the rounds. Every
// launch count is fixed by (B, T), so the call replays in a CUDA graph.
//
// Arithmetic. |dec - s| <= 65535, so the squared step error fits in u32
// and the sum in u64. The two per-step shifts use the exact hoisted form
// of the TPU kernel: with r = shift_range - shift and bias = (1 << r) >> 1,
// (((s - pred) << shift) + half) >> shift_range == (s - pred + bias) >> r
// and the int16 reinterpretation of (enc << shift_range) >> shift equals
// enc << r (the plain version keeps adpcm.c's form). The step keeps enc << r
// instead of enc: (x >> r) << r == x & (-1 << r), clamped to the bounds
// times 1 << r, and the decoded sample's add and upper clamp are one DPX
// instruction (__viaddmin_s32). Each filter's minimum shift is one count
// of leading zeros of its extrema, where adpcm.c loops over the shifts.
//
// What bounds it on the H100. The work, int32 issue: per SPU unit about
// 15 x 28 dependent steps of about 20 integer operations against 88 bytes
// of traffic on the dense layout, 92 on the chunk layout (serial route at
// the batch shape). On few streams, the latency of one unit's chain (about
// 1.2 us: the 28-step recurrence, the reductions) times the longest chain:
// the speculation's L + warmup units, then each round's longest repair,
// then the walk's boundary steps (S / 16) and the units it re-encodes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 28;
constexpr int kGroup = 16;                       // lanes per unit
constexpr int kThreads = 128;
constexpr int kGroupsPerBlock = kThreads / kGroup;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// stats_out slots (ops/adpcm_cuda.py::STAT_NAMES).
constexpr int kStatSegments = 0;
constexpr int kStatSpec = 1;
constexpr int kStatRepair = 2;
constexpr int kStatRounds = 3;   // a bit a round during the call
constexpr int kStatWalked = 4;

__constant__ int kK1[5] = {0, 60, 115, 98, 122};
__constant__ int kK2[5] = {0, 0, -52, -55, -60};

template <int F, int SR>
struct Variant {
  static constexpr int C = F * 3;
  static constexpr int kBits = SR == 12 ? 4 : 8;
  static constexpr int kPerWord = 32 / kBits;
  static constexpr int W = (kSamples + kPerWord - 1) / kPerWord;
  static constexpr int kMask = 0xFFFF >> SR;
  static constexpr int kLo = -0x8000 >> SR;
  static constexpr int kHi = 0x7FFF >> SR;
  static_assert(C <= kGroup, "candidates must fit one lane group");
};

__device__ __forceinline__ int predict(int k1, int k2, int p1, int p2) {
  return (k1 * p1 + k2 * p2 + 32) >> 6;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Unit k of the plan's S segments of T units starts here.
__device__ __forceinline__ int seg_start(int k, int T, int S) {
  return static_cast<int>(static_cast<long long>(k) * T / S);
}

// A lane group: its lane (0..15), the mask of its lanes in the warp, and
// its 32 ints of shared memory.
struct Group {
  int lane;
  unsigned mask;
  int* raw;
};

// The call's input (the note at the top): without a shared row, n >= 1
// samples a stream (the wrapper hands a stream of none one zero sample),
// n = 28 T on the dense layout. Sample indices within a stream are int32:
// the wrapper holds every offset + 27, n and each len under 2^31; a
// stream's start in the shared row is int64.
struct Source {
  const int16_t* pcm;
  const int* offsets;      // null: unit t at sample 28 t
  const long long* base;   // null: stream b is row b of n samples
  const int* len;          // with base: stream b's sample count
  const int* limits;
  int n;
  int T;
};

// How a kernel reads stream b's samples: row b of a (B, n) tensor, the
// index clamped to [0, n - 1] on the chunk layout (a branch uniform over
// the launch), or, in the shared row, the len[b] samples from base[b],
// resolved once a stream so that no unit waits on their load, the index
// clamped to at most len[b] - 1 (offsets are non-negative: the wrapper
// holds them). A stream of no samples reads zeros: its units are masked
// whole (unit_limit), so its reads of sample 0 (the wrapper points it at
// the row's first sample) count for nothing; a test of the length at
// each load made the serial route 38% slower on the card.
template <bool kShared>
struct Samples;

template <>
struct Samples<false> {
  int b;
};

template <>
struct Samples<true> {
  const int16_t* pcm;
  int last;     // max(len[b] - 1, 0)
  bool empty;   // len[b] == 0
};

template <bool kShared>
__device__ __forceinline__ Samples<kShared> samples_of(const Source& src,
                                                       int b) {
  if constexpr (kShared) {
    const int len = __ldg(src.len + b);
    return {src.pcm + __ldg(src.base + b), max(len - 1, 0), len == 0};
  } else {
    return {b};
  }
}

// Where unit t of stream b starts in its stream.
__device__ __forceinline__ int unit_offset(const Source& src, int b, int t) {
  return src.offsets
             ? __ldg(src.offsets + static_cast<long long>(b) * src.T + t)
             : t * kSamples;
}

// Sample i of the unit that starts at `off` in the stream.
__device__ __forceinline__ int unit_sample(const Source& src,
                                           const Samples<false>& s, int off,
                                           int i) {
  const int j = src.offsets ? min(max(off + i, 0), src.n - 1) : off + i;
  return __ldg(src.pcm + static_cast<long long>(s.b) * src.n + j);
}

__device__ __forceinline__ int unit_sample(const Source&,
                                           const Samples<true>& s, int off,
                                           int i) {
  return __ldg(s.pcm + min(off + i, s.last));
}

// Unit t's limit, 0 in the shared row for a stream of no samples.
template <bool kShared>
__device__ __forceinline__ int unit_limit(const Source& src,
                                          const Samples<kShared>& s, int b,
                                          int t) {
  const int lim = __ldg(src.limits + static_cast<long long>(b) * src.T + t);
  if constexpr (kShared)
    return s.empty ? 0 : lim;
  else
    return lim;
}

// One unit's inputs as lane l holds them: samples l and l + 16 (the latter
// 0 for l >= 12) and the unit's limit. Loaded unconditionally, so the
// loads do not wait for the limit.
struct UnitIn {
  int a, b, lim;
};

template <bool kShared>
__device__ __forceinline__ UnitIn load_unit(const Source& src,
                                            const Samples<kShared>& s, int b,
                                            int t, int lane) {
  const int off = unit_offset(src, b, t);
  UnitIn in;
  in.a = unit_sample(src, s, off, lane);
  in.b = lane < kSamples - kGroup ? unit_sample(src, s, off, lane + kGroup)
                                  : 0;
  in.lim = unit_limit(src, s, b, t);
  return in;
}

// The stored post-state of unit u (every lane reads it: one broadcast).
__device__ __forceinline__ int2 load_state(const int* s1, const int* s2,
                                           long long u) {
  return make_int2(s1[u], s2[u]);
}

struct UnitOut {
  int hdr, p1, p2;
  unsigned word;   // lane k < W: the winner's word k
};

// Encodes the unit in `in` from state (p1, p2): all lanes of the group
// return the winner's header and post-state.
template <int F, int SR, bool kSolo = false>
__device__ __forceinline__ UnitOut encode_unit(const Group& g,
                                               const UnitIn& in, int p1,
                                               int p2) {
  using V = Variant<F, SR>;
  const int lane = g.lane;
  int* raw = g.raw;
  __syncwarp(g.mask);  // the previous unit's reads of raw are done
  raw[lane] = lane < in.lim ? in.a : 0;
  if (lane < kSamples - kGroup)
    raw[lane + kGroup] = lane + kGroup < in.lim ? in.b : 0;
  __syncwarp(g.mask);

  // This lane's candidate: filter f, shift offset d in {-1, 0, 1}.
  const int cand = lane < V::C ? lane : 0;
  const int f = cand / 3;
  const int d = cand % 3 - 1;
  const int k1 = kK1[f];
  const int k2 = kK2[f];

  // Minimum shift of each filter from the raw residual extrema
  // (adpcm.c:39-79); the history is raw, prev1 before sample 0.
  int my_min_shift = 0;
#pragma unroll
  for (int ff = 0; ff < F; ++ff) {
    int lo = 0, hi = 0;  // the extrema are clipped to 0 from both sides
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + h * kGroup;
      if (i < kSamples) {
        const int a1 = i >= 1 ? raw[i - 1] : p1;
        const int a2 = i >= 2 ? raw[i - 2] : (i == 1 ? p1 : p2);
        const int r = raw[i] - predict(kK1[ff], kK2[ff], a1, a2);
        lo = min(lo, r);
        hi = max(hi, r);
      }
    }
    if constexpr (kSolo) {
      lo = __reduce_min_sync(g.mask, lo);
      hi = __reduce_max_sync(g.mask, hi);
    } else {
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(g.mask, lo, o, kGroup));
        hi = max(hi, __shfl_xor_sync(g.mask, hi, o, kGroup));
      }
    }
    // The least r < SR with hi >> r <= kHi and lo >> r >= kLo, else SR.
    // With kHi + 1 = -kLo = 2^m, hi >= 0 and lo <= 0, both hold once r is
    // at least the bit length of hi | ~lo (~lo taken as 0 for lo = 0)
    // less m: one count of leading zeros for adpcm.c's loop of shifts.
    constexpr int m = 15 - SR;
    const int v = hi | max(~lo, 0);
    const int rs = min(max(32 - __clz(v) - m, 0), SR);
    if (ff == f) my_min_shift = SR - rs;
  }
  const int shift = clampi(my_min_shift + d, 0, SR);
  const int rsh = SR - shift;
  const int bias = (1 << rsh) >> 1;
  // enc << rsh without the shift pair: (x >> rsh) << rsh == x & (-1 << rsh),
  // and clamping enc to [kLo, kHi] is clamping enc << rsh to the bounds
  // times 1 << rsh.
  const int keep = -1 << rsh;
  const int lo_s = V::kLo * (1 << rsh);
  const int hi_s = V::kHi * (1 << rsh);

  // The 28-step quantize/decode recurrence (adpcm.c:81-140).
  int q1 = p1, q2 = p2;
  unsigned long long err = 0;
  unsigned w[V::W];
#pragma unroll
  for (int k = 0; k < V::W; ++k) w[k] = 0u;
#pragma unroll
  for (int i = 0; i < kSamples; ++i) {
    const int s = raw[i];
    const int pred = predict(k1, k2, q1, q2);
    const int t = clampi((s - pred + bias) & keep, lo_s, hi_s);  // enc << rsh
    const int enc = t >> rsh;
    const int dec = max(__viaddmin_s32(t, pred, 0x7FFF), -0x8000);
    const unsigned e = static_cast<unsigned>(abs(dec - s));
    err += e * e;
    w[i / V::kPerWord] |= static_cast<unsigned>(enc & V::kMask)
                          << (V::kBits * (i % V::kPerWord));
    q2 = q1;
    q1 = dec;
  }

  // First strictly best: the least (error, candidate index) over the group.
  int best;
  if constexpr (kSolo) {
    // The key (error << 4 | index) fits 41 bits (error < 28 * 65535^2 <
    // 2^37): the least high word, then the least low word among the lanes
    // that hold it.
    const unsigned long long key = (err << 4) | static_cast<unsigned>(lane);
    const unsigned key_hi = static_cast<unsigned>(key >> 32);
    const unsigned min_hi = __reduce_min_sync(g.mask, key_hi);
    const unsigned min_lo = __reduce_min_sync(
        g.mask, key_hi == min_hi ? static_cast<unsigned>(key) : 0xFFFFFFFFu);
    best = static_cast<int>(min_lo & (kGroup - 1));
  } else {
    unsigned long long best_err = err;
    best = lane;
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) {
      const unsigned long long oe =
          __shfl_xor_sync(g.mask, best_err, o, kGroup);
      const int oi = __shfl_xor_sync(g.mask, best, o, kGroup);
      if (oe < best_err || (oe == best_err && oi < best)) {
        best_err = oe;
        best = oi;
      }
    }
  }
  const int header = (shift & 0x0F) | (f << 4);
  UnitOut out;
  out.p1 = __shfl_sync(g.mask, q1, best, kGroup);
  out.p2 = __shfl_sync(g.mask, q2, best, kGroup);
  out.hdr = __shfl_sync(g.mask, header, best, kGroup);
  out.word = 0u;
#pragma unroll
  for (int k = 0; k < V::W; ++k) {
    const unsigned wk = __shfl_sync(g.mask, w[k], best, kGroup);
    if (lane == k) out.word = wk;
  }
  return out;
}

template <int F, int SR>
__device__ __forceinline__ void store_unit(const Group& g, long long u,
                                           const UnitOut& o, int* hdr,
                                           int* words, int* s1, int* s2) {
  constexpr int W = Variant<F, SR>::W;
  if (g.lane < W) words[u * W + g.lane] = static_cast<int>(o.word);
  if (g.lane == 0) {
    hdr[u] = o.hdr;
    s1[u] = o.p1;
    s2[u] = o.p2;
  }
}

__device__ __forceinline__ void count(unsigned long long* stats, int slot,
                                      long long n) {
  if (stats) atomicAdd(stats + slot, static_cast<unsigned long long>(n));
}

// ------------------------------------------------------------ serial route

template <int F, int SR, bool kShared>
__global__ void __launch_bounds__(kThreads)
adpcm_serial_kernel(const Source src, const int* __restrict__ prev1,
                    const int* __restrict__ prev2, int batch,
                    int* __restrict__ hdr, int* __restrict__ words,
                    int* __restrict__ s1, int* __restrict__ s2,
                    unsigned long long* __restrict__ stats) {
  __shared__ int s_raw[kGroupsPerBlock][32];
  const int slot = threadIdx.x / kGroup;
  const int stream = blockIdx.x * kGroupsPerBlock + slot;
  const bool live = stream < batch;
  const int b = live ? stream : batch - 1;
  const int T = src.T;
  // Both groups of a warp walk in lockstep: the whole warp's mask, known
  // at compile time (a per-group mask made this route slower on the card).
  const Group g{static_cast<int>(threadIdx.x & (kGroup - 1)), kFull,
                s_raw[slot]};

  const Samples<kShared> smp = samples_of<kShared>(src, b);
  int p1 = prev1[b];
  int p2 = prev2[b];
  UnitIn next = load_unit(src, smp, b, 0, g.lane);
  for (int t = 0; t < T; ++t) {
    const long long u = static_cast<long long>(b) * T + t;
    const UnitIn cur = next;
    if (t + 1 < T) next = load_unit(src, smp, b, t + 1, g.lane);
    const UnitOut o = encode_unit<F, SR>(g, cur, p1, p2);
    p1 = o.p1;
    p2 = o.p2;
    if (live) store_unit<F, SR>(g, u, o, hdr, words, s1, s2);
  }
  if (live && g.lane == 0) {
    count(stats, kStatSegments, 1);
    count(stats, kStatWalked, T);
  }
}

// --------------------------------------------------------- segmented route

// A group a segment (b, k), two a warp; the groups of a warp diverge, so
// every warp-level operation names the group's own lanes.
struct SegmentGroup {
  Group g;
  long long gi;   // b * S + k
  int b, k;
};

__device__ __forceinline__ bool segment_group(int* raw_base, int batch,
                                              int S, SegmentGroup* sg) {
  const int slot = threadIdx.x / kGroup;
  sg->gi = static_cast<long long>(blockIdx.x) * kGroupsPerBlock + slot;
  if (sg->gi >= static_cast<long long>(batch) * S) return false;
  sg->g = Group{static_cast<int>(threadIdx.x & (kGroup - 1)),
                0xFFFFu << (threadIdx.x & kGroup), raw_base + slot * 32};
  sg->b = static_cast<int>(sg->gi / S);
  sg->k = static_cast<int>(sg->gi % S);
  return true;
}

template <int F, int SR, bool kShared>
__global__ void __launch_bounds__(kThreads)
adpcm_spec_kernel(const Source src, const int* __restrict__ prev1,
                  const int* __restrict__ prev2, int batch, int S,
                  int warmup, int* __restrict__ hdr, int* __restrict__ words,
                  int* __restrict__ s1, int* __restrict__ s2,
                  int2* __restrict__ starts, int2* __restrict__ ends,
                  unsigned long long* __restrict__ stats) {
  __shared__ int s_raw[kGroupsPerBlock * 32];
  SegmentGroup sg;
  if (!segment_group(s_raw, batch, S, &sg)) return;
  const Group& g = sg.g;
  const int T = src.T;
  const int t0 = seg_start(sg.k, T, S);
  const int t1 = seg_start(sg.k + 1, T, S);
  const long long base = static_cast<long long>(sg.b) * T;
  const int w0 = sg.k == 0 ? 0 : max(0, t0 - warmup);
  const Samples<kShared> smp = samples_of<kShared>(src, sg.b);
  int p1, p2;
  if (w0 == 0) {
    p1 = prev1[sg.b];
    p2 = prev2[sg.b];
  } else {  // the guess: the raw samples before the warm-up
    const int off = unit_offset(src, sg.b, w0 - 1);
    const int lim = unit_limit(src, smp, sg.b, w0 - 1);
    p1 = lim > kSamples - 1 ? unit_sample(src, smp, off, kSamples - 1) : 0;
    p2 = lim > kSamples - 2 ? unit_sample(src, smp, off, kSamples - 2) : 0;
  }
  UnitIn next = load_unit(src, smp, sg.b, w0, g.lane);
  for (int t = w0; t < t1; ++t) {
    if (t == t0 && g.lane == 0) starts[sg.gi] = make_int2(p1, p2);
    const UnitIn cur = next;
    if (t + 1 < t1) next = load_unit(src, smp, sg.b, t + 1, g.lane);
    const UnitOut o = encode_unit<F, SR>(g, cur, p1, p2);
    p1 = o.p1;
    p2 = o.p2;
    if (t >= t0) store_unit<F, SR>(g, base + t, o, hdr, words, s1, s2);
  }
  if (g.lane == 0) {
    ends[sg.gi] = make_int2(p1, p2);
    count(stats, kStatSegments, 1);
    count(stats, kStatSpec, t1 - w0);
  }
}

template <int F, int SR, bool kShared>
__global__ void __launch_bounds__(kThreads)
adpcm_round_kernel(const Source src, int batch, int S, int round,
                   int* __restrict__ hdr, int* __restrict__ words,
                   int* __restrict__ s1, int* __restrict__ s2,
                   int2* __restrict__ starts,
                   const int2* __restrict__ ends_src,
                   int2* __restrict__ ends_dst,
                   unsigned long long* __restrict__ stats) {
  __shared__ int s_raw[kGroupsPerBlock * 32];
  SegmentGroup sg;
  if (!segment_group(s_raw, batch, S, &sg)) return;
  const Group& g = sg.g;
  const int2 end_here = ends_src[sg.gi];
  if (sg.k == 0) {  // a stream's first segment starts from the true state
    if (g.lane == 0) ends_dst[sg.gi] = end_here;
    return;
  }
  const int2 from = ends_src[sg.gi - 1];
  const int2 start = starts[sg.gi];
  if (from.x == start.x && from.y == start.y) {
    if (g.lane == 0) ends_dst[sg.gi] = end_here;
    return;
  }
  const int T = src.T;
  const int t0 = seg_start(sg.k, T, S);
  const int t1 = seg_start(sg.k + 1, T, S);
  const long long base = static_cast<long long>(sg.b) * T;
  int p1 = from.x, p2 = from.y;
  bool merged = false;
  int t = t0;
  const Samples<kShared> smp = samples_of<kShared>(src, sg.b);
  UnitIn next = load_unit(src, smp, sg.b, t0, g.lane);
  int2 stored_next = load_state(s1, s2, base + t0);
  while (t < t1) {
    const UnitIn cur = next;
    const int2 stored = stored_next;
    if (t + 1 < t1) {
      next = load_unit(src, smp, sg.b, t + 1, g.lane);
      stored_next = load_state(s1, s2, base + t + 1);
    }
    const UnitOut o = encode_unit<F, SR>(g, cur, p1, p2);
    p1 = o.p1;
    p2 = o.p2;
    store_unit<F, SR>(g, base + t, o, hdr, words, s1, s2);
    ++t;
    if (p1 == stored.x && p2 == stored.y) {
      merged = true;
      break;
    }
  }
  if (g.lane == 0) {
    starts[sg.gi] = from;
    ends_dst[sg.gi] = merged ? end_here : make_int2(p1, p2);
    count(stats, kStatRepair, t - t0);
    if (stats) atomicOr(stats + kStatRounds, 1ull << round);
  }
}

template <int F, int SR, bool kShared>
__global__ void __launch_bounds__(kThreads)
adpcm_walk_kernel(const Source src, int batch, int S,
                  int* __restrict__ hdr, int* __restrict__ words,
                  int* __restrict__ s1, int* __restrict__ s2,
                  const int2* __restrict__ starts,
                  unsigned long long* __restrict__ stats) {
  __shared__ int s_raw[kWarpsPerBlock][32];
  if (stats && blockIdx.x == 0 && threadIdx.x == 0)  // the rounds are done
    stats[kStatRounds] = __popcll(stats[kStatRounds]);
  // A warp a stream, its first 16 lanes; the walks of two streams diverge.
  const int warp = threadIdx.x / 32;
  const int stream = blockIdx.x * kWarpsPerBlock + warp;
  if (stream >= batch || (threadIdx.x & 31) >= kGroup) return;
  const Group g{static_cast<int>(threadIdx.x & (kGroup - 1)), 0xFFFFu,
                s_raw[warp]};
  const int T = src.T;
  const long long base = static_cast<long long>(stream) * T;
  const int2* st = starts + static_cast<long long>(stream) * S;
  const Samples<kShared> smp = samples_of<kShared>(src, stream);

  // The walk's true state before segment k; segment 0 is exact.
  int k = 1;
  const int2 e0 = load_state(s1, s2, base + seg_start(1, T, S) - 1);
  int p1 = e0.x, p2 = e0.y;
  long long walked = 0;
  while (k < S) {
    // Lane l checks boundary k + l: that segment's start against the
    // state before it (the walk's own for l = 0, else the stored end of
    // the segment before, exact when every boundary before it holds).
    const int kk = k + g.lane;
    int e1 = p1, e2 = p2;
    bool bad = false;
    if (kk < S) {
      if (g.lane > 0) {
        const int2 e = load_state(s1, s2, base + seg_start(kk, T, S) - 1);
        e1 = e.x;
        e2 = e.y;
      }
      const int2 sk = st[kk];
      bad = sk.x != e1 || sk.y != e2;
    }
    const unsigned m = __ballot_sync(g.mask, bad);
    if (m == 0u) {
      k = min(S, k + kGroup);
      if (k < S) {
        const int2 e = load_state(s1, s2, base + seg_start(k, T, S) - 1);
        p1 = e.x;
        p2 = e.y;
      }
      continue;
    }
    const int f = __ffs(m) - 1;
    k += f;
    p1 = __shfl_sync(g.mask, e1, f, kGroup);
    p2 = __shfl_sync(g.mask, e2, f, kGroup);

    // Re-encode from the true state, unit by unit, across segment ends,
    // until a post-state equals the stored one (or the stream ends).
    int t = seg_start(k, T, S);
    int seg_end = seg_start(k + 1, T, S);
    bool merged = false;
    UnitIn next = load_unit(src, smp, stream, t, g.lane);
    int2 stored_next = load_state(s1, s2, base + t);
    while (t < T) {
      const UnitIn cur = next;
      const int2 stored = stored_next;
      if (t + 1 < T) {
        next = load_unit(src, smp, stream, t + 1, g.lane);
        stored_next = load_state(s1, s2, base + t + 1);
      }
      const UnitOut o = encode_unit<F, SR, true>(g, cur, p1, p2);
      p1 = o.p1;
      p2 = o.p2;
      store_unit<F, SR>(g, base + t, o, hdr, words, s1, s2);
      ++t;
      ++walked;
      if (t == seg_end) seg_end = seg_start(++k + 1, T, S);
      if (p1 == stored.x && p2 == stored.y) {
        merged = true;
        break;
      }
    }
    if (!merged || k >= S) break;
    if (t != seg_start(k, T, S)) {
      // Merged inside segment k: the rest of it is exact, so is its end.
      const int2 e = load_state(s1, s2, base + seg_end - 1);
      p1 = e.x;
      p2 = e.y;
      ++k;
    }
  }
  if (g.lane == 0) count(stats, kStatWalked, walked);
}

template <int F, int SR, bool kShared>
int launch(const Source& src, const void* prev1, const void* prev2,
           int batch, int S, int warmup, int rounds, void* hdr, void* words,
           void* s1, void* s2, void* starts, void* ends, void* stats,
           cudaStream_t stream) {
  const int* p1 = static_cast<const int*>(prev1);
  const int* p2 = static_cast<const int*>(prev2);
  int* h = static_cast<int*>(hdr);
  int* w = static_cast<int*>(words);
  int* a = static_cast<int*>(s1);
  int* b = static_cast<int*>(s2);
  auto* st = static_cast<unsigned long long*>(stats);
  if (S <= 1) {
    const int grid = (batch + kGroupsPerBlock - 1) / kGroupsPerBlock;
    adpcm_serial_kernel<F, SR, kShared><<<grid, kThreads, 0, stream>>>(
        src, p1, p2, batch, h, w, a, b, st);
    return static_cast<int>(cudaGetLastError());
  }
  const long long groups = static_cast<long long>(batch) * S;
  const int grid = static_cast<int>((groups + kGroupsPerBlock - 1) /
                                    kGroupsPerBlock);
  int2* start = static_cast<int2*>(starts);
  int2* end[2] = {static_cast<int2*>(ends), static_cast<int2*>(ends) + groups};
  adpcm_spec_kernel<F, SR, kShared><<<grid, kThreads, 0, stream>>>(
      src, p1, p2, batch, S, warmup, h, w, a, b, start, end[0], st);
  int rc = static_cast<int>(cudaGetLastError());
  for (int r = 0; r < rounds && rc == 0; ++r) {
    adpcm_round_kernel<F, SR, kShared><<<grid, kThreads, 0, stream>>>(
        src, batch, S, r, h, w, a, b, start, end[r & 1], end[(r + 1) & 1],
        st);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  const int walk_grid = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  adpcm_walk_kernel<F, SR, kShared><<<walk_grid, kThreads, 0, stream>>>(
      src, batch, S, h, w, a, b, start, st);
  return static_cast<int>(cudaGetLastError());
}

// The shared row has kernels of its own, so that the other layouts' read
// as they would without it.
template <int F, int SR, typename... Args>
int launch_layout(const Source& src, Args... args) {
  return src.base ? launch<F, SR, true>(src, args...)
                  : launch<F, SR, false>(src, args...);
}

}  // namespace

// Returns a cudaError_t value; cudaErrorInvalidValue (1) for a
// (filter_count, shift_range) pair the kernel is not built for (it is
// built for SPU (5, 12) and XA (4, 12) and (4, 8)), and, without a shared
// row, for n < 1 and for a dense call with n != 28 T. `pcm` is (batch, n)
// int16, or with `base` the shared row (n unused): stream b is the
// `len`[b] samples from `base`[b] ((batch,) int64 and int32). `offsets`
// is (batch, T) int32, or null (unit t at sample 28 t of its stream);
// `limits` (batch, T) int32, clipped to [-(1 << 30), 28]. `segments` <= 1
// runs the serial route (one launch), else 2 + `rounds` launches;
// `starts` holds batch * segments int2 and `ends` twice that; `stats` (5
// u64, zeroed by the caller) may be null.
extern "C" int psx_adpcm_encode_pcm_units(
    const void* pcm, const void* offsets, const void* base, const void* len,
    const void* limits, const void* prev1, const void* prev2, int n,
    int batch, int T, int filter_count, int shift_range, int segments,
    int warmup, int rounds, void* hdr, void* words, void* s1, void* s2,
    void* starts, void* ends, void* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || T <= 0) return 0;
  if (rounds > 63 || (!base != !len) ||
      (!base && (n < 1 || (!offsets &&
                           n != static_cast<long long>(kSamples) * T))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Source src{static_cast<const int16_t*>(pcm),
                   static_cast<const int*>(offsets),
                   static_cast<const long long*>(base),
                   static_cast<const int*>(len),
                   static_cast<const int*>(limits), n, T};
  if (filter_count == 5 && shift_range == 12)
    return launch_layout<5, 12>(src, prev1, prev2, batch, segments, warmup,
                                rounds, hdr, words, s1, s2, starts, ends,
                                stats, st);
  if (filter_count == 4 && shift_range == 12)
    return launch_layout<4, 12>(src, prev1, prev2, batch, segments, warmup,
                                rounds, hdr, words, s1, s2, starts, ends,
                                stats, st);
  if (filter_count == 4 && shift_range == 8)
    return launch_layout<4, 8>(src, prev1, prev2, batch, segments, warmup,
                               rounds, hdr, words, s1, s2, starts, ends,
                               stats, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
