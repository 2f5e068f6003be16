// K5: ADPCM unit encoder with decoder-state threading over time.
//
// Replaces psxavenc_tpu/ops/adpcm_pallas.py::encode_units_pallas (_kernel).
// Plain version: ops/adpcm.py::encode_units_scan (packed by
// ops/adpcm_cuda.py::encode_units_plain).
//
// Per stream and per 28-sample unit, in time order: samples at or past the
// unit's limit count as 0; each filter's minimum shift comes from the
// residual extrema of the raw samples; every (filter, shift) candidate
// (3 shifts per filter, filter-major, shift ascending) runs the 28-step
// quantize/decode recurrence with the exact squared error; the first
// strictly best candidate gives the header, the packed sample words and
// the post-unit state, which the next unit starts from.
//
// Mapping. The TPU kernel put streams on lanes and candidates on sublanes
// and made time a sequential grid axis with the state in VMEM scratch.
// Blocks on the GPU run in no order, so the loop over T is inside the
// kernel and the state lives in registers. A stream owns a 16-lane group
// (two streams per warp); lane c runs candidate c, lanes at or past C run
// a copy of candidate 0 (it ties with candidate 0 and loses on index).
// The unit is staged in shared memory; lane l folds the residuals of
// samples l and l+16 for every filter, and 16-lane xor shuffles reduce
// the extrema. The winner is a 16-lane shuffle reduction on (error,
// candidate index), lexicographic: exactly "first strictly better".
// Streams past the batch edge compute on a clamped stream and store
// nothing, so every shuffle runs with the full warp.
//
// Arithmetic. |dec - s| <= 65535, so the squared step error fits in u32
// and the sum in u64. The two per-step shifts use the exact hoisted form
// of the TPU kernel: with r = shift_range - shift and bias = (1 << r) >> 1,
// (((s - pred) << shift) + half) >> shift_range == (s - pred + bias) >> r
// and the int16 reinterpretation of (enc << shift_range) >> shift equals
// enc << r (the plain version keeps adpcm.c's form).
//
// What bounds it on the H100: int32 issue. Per SPU unit about 15 x 28
// dependent steps of about 20 integer operations against 144 bytes of
// traffic; one dependent chain per lane, so with two streams per warp the
// card needs many resident warps to hide the latency of each step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 28;
constexpr int kGroup = 16;                       // lanes per stream
constexpr int kThreads = 128;
constexpr int kStreamsPerBlock = kThreads / kGroup;
constexpr unsigned kFull = 0xFFFFFFFFu;

__constant__ int kK1[5] = {0, 60, 115, 98, 122};
__constant__ int kK2[5] = {0, 0, -52, -55, -60};

__device__ __forceinline__ int predict(int k1, int k2, int p1, int p2) {
  return (k1 * p1 + k2 * p2 + 32) >> 6;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

template <int F, int SR>
__global__ void __launch_bounds__(kThreads)
adpcm_units_kernel(const int* __restrict__ units,
                   const int* __restrict__ limits,
                   const int* __restrict__ prev1,
                   const int* __restrict__ prev2, int batch, int T,
                   int* __restrict__ hdr, int* __restrict__ words,
                   int* __restrict__ s1, int* __restrict__ s2) {
  constexpr int C = F * 3;
  constexpr int kBits = SR == 12 ? 4 : 8;
  constexpr int kPerWord = 32 / kBits;
  constexpr int W = (kSamples + kPerWord - 1) / kPerWord;
  constexpr int kMask = 0xFFFF >> SR;
  constexpr int kLo = -0x8000 >> SR;
  constexpr int kHi = 0x7FFF >> SR;
  static_assert(C <= kGroup, "candidates must fit one lane group");

  __shared__ int s_raw[kStreamsPerBlock][32];

  const int lane = threadIdx.x & (kGroup - 1);
  const int slot = threadIdx.x / kGroup;
  const int stream = blockIdx.x * kStreamsPerBlock + slot;
  const bool live = stream < batch;
  const long long b = live ? stream : batch - 1;

  // This lane's candidate: filter f, shift offset d in {-1, 0, 1}.
  const int cand = lane < C ? lane : 0;
  const int f = cand / 3;
  const int d = cand % 3 - 1;
  const int k1 = kK1[f];
  const int k2 = kK2[f];

  int p1 = prev1[b];
  int p2 = prev2[b];
  int* raw = s_raw[slot];

  for (int t = 0; t < T; ++t) {
    const long long u = b * T + t;
    const int lim = limits[u];
    const int* src = units + u * kSamples;
    __syncwarp();  // the previous unit's reads of raw are done
    raw[lane] = lane < lim ? src[lane] : 0;
    if (lane < kSamples - kGroup)
      raw[lane + kGroup] = lane + kGroup < lim ? src[lane + kGroup] : 0;
    __syncwarp();

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
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(kFull, lo, o, kGroup));
        hi = max(hi, __shfl_xor_sync(kFull, hi, o, kGroup));
      }
      int rs = SR;
#pragma unroll
      for (int r = SR - 1; r >= 0; --r)
        if ((hi >> r) <= kHi && (lo >> r) >= kLo) rs = r;
      if (ff == f) my_min_shift = SR - rs;
    }
    const int shift = clampi(my_min_shift + d, 0, SR);
    const int rsh = SR - shift;
    const int bias = (1 << rsh) >> 1;

    // The 28-step quantize/decode recurrence (adpcm.c:81-140).
    int q1 = p1, q2 = p2;
    unsigned long long err = 0;
    unsigned w[W];
#pragma unroll
    for (int k = 0; k < W; ++k) w[k] = 0u;
#pragma unroll
    for (int i = 0; i < kSamples; ++i) {
      const int s = raw[i];
      const int pred = predict(k1, k2, q1, q2);
      const int enc = clampi((s - pred + bias) >> rsh, kLo, kHi);
      const int dec = clampi(enc * (1 << rsh) + pred, -0x8000, 0x7FFF);
      const unsigned e = static_cast<unsigned>(abs(dec - s));
      err += e * e;
      w[i / kPerWord] |= static_cast<unsigned>(enc & kMask)
                         << (kBits * (i % kPerWord));
      q2 = q1;
      q1 = dec;
    }

    // First strictly best: least (error, index) over the group.
    unsigned long long best_err = err;
    int best = lane;
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) {
      const unsigned long long oe =
          __shfl_xor_sync(kFull, best_err, o, kGroup);
      const int oi = __shfl_xor_sync(kFull, best, o, kGroup);
      if (oe < best_err || (oe == best_err && oi < best)) {
        best_err = oe;
        best = oi;
      }
    }
    const int header = (shift & 0x0F) | (f << 4);
    const int win_hdr = __shfl_sync(kFull, header, best, kGroup);
    p1 = __shfl_sync(kFull, q1, best, kGroup);
    p2 = __shfl_sync(kFull, q2, best, kGroup);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const unsigned wk = __shfl_sync(kFull, w[k], best, kGroup);
      if (live && lane == k) words[u * W + k] = static_cast<int>(wk);
    }
    if (live && lane == 0) {
      hdr[u] = win_hdr;
      s1[u] = p1;
      s2[u] = p2;
    }
  }
}

template <int F, int SR>
int launch(const void* units, const void* limits, const void* prev1,
           const void* prev2, int batch, int T, void* hdr, void* words,
           void* s1, void* s2, cudaStream_t stream) {
  const int grid = (batch + kStreamsPerBlock - 1) / kStreamsPerBlock;
  adpcm_units_kernel<F, SR><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(units), static_cast<const int*>(limits),
      static_cast<const int*>(prev1), static_cast<const int*>(prev2), batch,
      T, static_cast<int*>(hdr), static_cast<int*>(words),
      static_cast<int*>(s1), static_cast<int*>(s2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t value; cudaErrorInvalidValue (1) for a
// (filter_count, shift_range) pair the kernel is not built for: it is
// built for SPU (5, 12) and XA (4, 12) and (4, 8).
extern "C" int psx_adpcm_encode_units(const void* units, const void* limits,
                                      const void* prev1, const void* prev2,
                                      int batch, int T, int filter_count,
                                      int shift_range, void* hdr, void* words,
                                      void* s1, void* s2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || T <= 0) return 0;
  if (filter_count == 5 && shift_range == 12)
    return launch<5, 12>(units, limits, prev1, prev2, batch, T, hdr, words,
                         s1, s2, st);
  if (filter_count == 4 && shift_range == 12)
    return launch<4, 12>(units, limits, prev1, prev2, batch, T, hdr, words,
                         s1, s2, st);
  if (filter_count == 4 && shift_range == 8)
    return launch<4, 8>(units, limits, prev1, prev2, batch, T, hdr, words,
                        s1, s2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
