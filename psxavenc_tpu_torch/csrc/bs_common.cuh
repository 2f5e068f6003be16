// Shared device code of the BS and block-stream kernels: the islow FDCT,
// the quantizer divide, the closed-form MDEC Huffman tables, bulk copies
// that report to an mbarrier, and the block-stream placement.
//
// Every function computes the same integers as its namesake in
// psxavenc_tpu_torch/ops/bs.py and ops/fdct.py (the plain versions the
// kernels are checked against). All shift counts stay in [0, 31]: C++
// leaves larger ones undefined where XLA defines them as 0.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace psx {

// The current device's SM count (read once; host code).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// ----------------------------------------------------------------- tables

// QUANT_PSX at the zigzag scan positions 1..63 (mdec.c:189-222).
__constant__ int kQuantZZ[63] = {
    16, 16, 19, 16, 19, 22, 22, 22, 22, 22, 22, 26, 24, 26, 27, 27,
    27, 26, 26, 26, 26, 27, 27, 27, 29, 29, 29, 34, 34, 34, 29, 29,
    29, 27, 27, 29, 29, 32, 32, 34, 34, 37, 38, 37, 35, 35, 34, 35,
    38, 38, 40, 40, 40, 48, 48, 46, 46, 56, 56, 58, 69, 69, 83};

// Scan position - 1 of each row-major coefficient 1..63 (the inverse of
// ZAGZIG); index 0 (DC) is unused.
__constant__ int kZigzagRow[64] = {
    -1, 0,  4,  5,  13, 14, 26, 27, 1,  3,  6,  12, 15, 25, 28, 41,
    2,  7,  11, 16, 24, 29, 40, 42, 8,  10, 17, 23, 30, 39, 43, 52,
    9,  18, 22, 31, 38, 44, 51, 53, 19, 21, 32, 37, 45, 50, 54, 59,
    20, 33, 36, 46, 49, 55, 58, 60, 34, 35, 47, 48, 56, 57, 61, 62};

// Closed-form AC Huffman constants, packed exactly as _ACBC_W* and _ACC_W8
// in ops/bs.py: (prefix << 4 | bits - 3) combos three per word, 6-bit
// prefixes five per word.
__constant__ uint32_t kAcbcW1[8] = {0x520C430, 0x7418C73, 0x7511054,
                                    0x2369D855, 0xE881A26, 0x1FA220D8,
                                    0x17A669AA, 0x16A};
__constant__ uint32_t kAcbcW2[4] = {0x4519042, 0x983E246, 0x11A569EA,
                                    0x42D1B};
__constant__ uint32_t kAcbcW37[6] = {0xB895853, 0x12B4A9CA, 0xC81954E,
                                     0x2664ED4A, 0x21652DBA, 0x15B2A16B};
__constant__ uint32_t kAccW8 = 0x41361D;
constexpr int kEsc10 = 0x7FFF;

// ------------------------------------------------------------------- FDCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 4;

__device__ __forceinline__ int descale(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

__device__ __forceinline__ int wrap16(int x) {
  return ((x & 0xFFFF) ^ 0x8000) - 0x8000;
}

// One 1-D islow pass in place on d0..d7 (ops/fdct.py:_pass_rows). Pass 1
// scales the even outputs up by PASS1_BITS and stores through int16.
template <bool kFirst>
__device__ __forceinline__ void islow_pass(int& d0, int& d1, int& d2,
                                           int& d3, int& d4, int& d5,
                                           int& d6, int& d7) {
  constexpr int kDescale = kFirst ? kConstBits - kPass1Bits
                                  : kConstBits + kPass1Bits;
  const int tmp0 = d0 + d7, tmp7 = d0 - d7;
  const int tmp1 = d1 + d6, tmp6 = d1 - d6;
  const int tmp2 = d2 + d5, tmp5 = d2 - d5;
  const int tmp3 = d3 + d4, tmp4 = d3 - d4;
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  int out0, out4;
  if (kFirst) {
    out0 = (tmp10 + tmp11) * (1 << kPass1Bits);
    out4 = (tmp10 - tmp11) * (1 << kPass1Bits);
  } else {
    out0 = descale(tmp10 + tmp11, kPass1Bits);
    out4 = descale(tmp10 - tmp11, kPass1Bits);
  }
  int z1 = (tmp12 + tmp13) * 4433;
  const int out2 = descale(z1 + tmp13 * 6270, kDescale);
  const int out6 = descale(z1 - tmp12 * 15137, kDescale);

  z1 = tmp4 + tmp7;
  int z2 = tmp5 + tmp6;
  int z3 = tmp4 + tmp6;
  int z4 = tmp5 + tmp7;
  const int z5 = (z3 + z4) * 9633;
  const int t4 = tmp4 * 2446;
  const int t5 = tmp5 * 16819;
  const int t6 = tmp6 * 25172;
  const int t7 = tmp7 * 12299;
  z1 = z1 * -7373;
  z2 = z2 * -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;

  d0 = out0;
  d1 = descale(t7 + z1 + z4, kDescale);
  d2 = out2;
  d3 = descale(t6 + z2 + z3, kDescale);
  d4 = out4;
  d5 = descale(t5 + z2 + z4, kDescale);
  d6 = out6;
  d7 = descale(t4 + z1 + z3, kDescale);
  if (kFirst) {
    d0 = wrap16(d0); d1 = wrap16(d1); d2 = wrap16(d2); d3 = wrap16(d3);
    d4 = wrap16(d4); d5 = wrap16(d5); d6 = wrap16(d6); d7 = wrap16(d7);
  }
}

// islow FDCT of one 8x8 block in place: v[8r + c] is sample (r, c) on
// entry and coefficient (r, c) on exit. Only compile-time indices touch v,
// so it stays in registers.
__device__ __forceinline__ void fdct_islow(int (&v)[64]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    islow_pass<true>(v[8 * r + 0], v[8 * r + 1], v[8 * r + 2],
                     v[8 * r + 3], v[8 * r + 4], v[8 * r + 5],
                     v[8 * r + 6], v[8 * r + 7]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    islow_pass<false>(v[c], v[8 + c], v[16 + c], v[24 + c], v[32 + c],
                      v[40 + c], v[48 + c], v[56 + c]);
}

// -------------------------------------------------------------- quantizer

// floor(t / d) for 0 <= t < 2^17 and 1 <= d <= 2^13, from an f32
// reciprocal estimate (within one of the quotient) and one integer
// remainder correction, so the result is exact (ops/bs.py:_div_rounded_fast).
__device__ __forceinline__ int div_floor(int t, int d, float rcp) {
  const int q0 = __float2int_rz(__fmul_rn(static_cast<float>(t), rcp));
  const int r = t - q0 * d;
  return q0 + (r >= d) - (r < 0);
}

// ---------------------------------------------------------- AC Huffman

// Code length of (run, |level| >= 1); escapes are 22 bits
// (ops/bs.py:ac_bits_closed_form).
__device__ __forceinline__ int ac_bits(int r, int a) {
  switch (a) {
    case 1:
      return r > 31 ? 22
                    : 3 + (r >= 1) + (r >= 2) + (r >= 3) + (r >= 5) +
                          (r >= 8) + (r >= 10) + 2 * (r >= 14) +
                          2 * (r >= 17) + (r >= 22) + 3 * (r >= 27);
    case 2:
      return r > 16 ? 22
                    : 5 + 2 * (r >= 1) + (r >= 2) + (r >= 3) +
                          2 * (r >= 4) + 2 * (r >= 6) + (r >= 9) +
                          3 * (r >= 11);
    case 3:
      return r > 6 ? 22
                   : 6 + 3 * (r >= 1) + 2 * (r >= 2) + 2 * (r >= 3) +
                         (r >= 5) + 3 * (r >= 6);
    case 4:
      return r > 3 ? 22 : 8 + 3 * (r >= 1) + 2 * (r >= 2) + (r >= 3);
    case 5:
      return r > 2 ? 22 : 9 + 4 * (r >= 1) + (r >= 2);
    case 6:
      return r > 1 ? 22 : 9 + 5 * (r >= 1);
    case 7:
      return r > 1 ? 22 : 11 + 3 * (r >= 1);
    default:
      if (r == 0) return a <= 40 ? 13 + (a >= 12) + (a >= 16) + (a >= 32)
                                 : 22;
      if (r == 1) return a <= 18 ? 16 + (a >= 15) : 22;
      return 22;
  }
}

__device__ __forceinline__ int packed10(const uint32_t* words, int idx) {
  return static_cast<int>((words[idx / 3] >> ((idx % 3) * 10)) & 0x3FF);
}

// (bits, code) of a nonzero signed level ``ac`` at run ``r``
// (ops/bs.py:ac_bits_code_closed_form).
__device__ __forceinline__ void ac_bits_code(int r, int ac, int& bits,
                                             uint32_t& code) {
  const int a = ac < 0 ? -ac : ac;
  int combo;
  if (a == 1) {
    combo = r < 22   ? packed10(kAcbcW1, r)
            : r < 27 ? ((0x1F - (r - 22)) << 4) | (14 - 3)
                     : ((0x1F - (r - 27)) << 4) | (17 - 3);
    if (r > 31) combo = kEsc10;
  } else if (a == 2) {
    combo = r < 11 ? packed10(kAcbcW2, r)
                   : ((0x1A - (r - 11)) << 4) | (17 - 3);
    if (r > 16) combo = kEsc10;
  } else if (a <= 7) {
    const int off = a == 3 ? 0 : a == 4 ? 7 : a == 5 ? 11 : a == 6 ? 14 : 16;
    const int rmax = a == 3 ? 6 : a == 4 ? 3 : a == 5 ? 2 : 1;
    combo = r > rmax ? kEsc10 : packed10(kAcbcW37, off + r);
  } else if (r == 0 && a <= 40) {
    const int p = a < 12   ? static_cast<int>((kAccW8 >> ((a - 8) * 6)) & 0x3F)
                  : a < 16 ? 0x1A - (a - 12)
                  : a < 32 ? 0x1F - (a - 16)
                           : 0x18 - (a - 32);
    combo = (p << 4) | (13 + (a >= 12) + (a >= 16) + (a >= 32) - 3);
  } else if (r == 1 && a <= 18) {
    const int p = a < 15 ? 0x1F - (a - 8) : 0x13 - (a - 15);
    combo = (p << 4) | (16 + (a >= 15) - 3);
  } else {
    combo = kEsc10;
  }
  if (combo == kEsc10) {
    bits = 22;
    code = (1u << 16) | static_cast<uint32_t>((r << 10) | (ac & 0x3FF));
  } else {
    bits = (combo & 0xF) + 3;
    code = (static_cast<uint32_t>(combo >> 4) << 1) | (ac < 0 ? 1u : 0u);
  }
}

// ---------------------------------------------------------- DC Huffman

// BS v3 DC-delta (bits, code) of a 9-bit delta key; is_y selects the luma
// tree (ops/bs.py:dc_bits_code_closed_form).
__device__ __forceinline__ void dc_bits_code(bool is_y, int key, int& bits,
                                             int& code) {
  int sd = ((key & 0x1FF) ^ 0x100) - 0x100;
  sd = sd < -255 ? -255 : sd;
  const int mag = sd < 0 ? -sd : sd;
  if (mag == 0) {
    bits = is_y ? 3 : 2;
    code = is_y ? 4 : 0;
    return;
  }
  const int db = (mag >= 2) + (mag >= 4) + (mag >= 8) + (mag >= 16) +
                 (mag >= 32) + (mag >= 64) + (mag >= 128);
  bits = db == 0 ? 3 : 2 * db + 2;
  if (is_y && db >= 3) bits = 2 * db + 1;
  const int pv_c = db == 0 ? 1 : (1 << (db + 1)) - 2;
  const int pv_y = db >= 4 ? (1 << db) - 2 : db == 3 ? 6 : db == 2 ? 5 : db;
  const int pv = is_y ? pv_y : pv_c;
  const int mask = (1 << (db + 1)) - 1;
  const int suffix = sd > 0 ? (sd & mask) : ((sd - 1) & mask);
  code = (pv << (db + 1)) | suffix;
}

// ------------------------------------------------ asynchronous copies

// Bulk copies (the card's copy engine moves a whole row per instruction) that
// report to a barrier in shared memory: the barrier's phase ends when the
// one expected arrival has come and every expected byte has landed.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
      shared_addr(bar)));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void barrier_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}
// ``bytes``: a multiple of 16, both addresses on 16-byte boundaries.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}
// Waits for the end of the barrier's phase of parity ``phase``.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, int phase) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------- block streams

// One block's placed u32 words (ops/bitpack.py:streams_to_u32): its 16
// MSB-first u16 stream words ``w`` shifted to the sub-word part of global
// bit offset ``g`` and packed as little-endian u16 pairs into nine u32
// words, the first at u32 offset g >> 5.
__device__ __forceinline__ void stream_to_u32(const uint32_t (&w)[16], int g,
                                              uint32_t (&vals)[9]) {
  const int sh = g & 15;
  uint32_t contrib[17];
  uint32_t prev = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    contrib[i] = (w[i] >> sh) | ((prev << (16 - sh)) & 0xFFFFu);
    prev = w[i];
  }
  contrib[16] = (prev << (16 - sh)) & 0xFFFFu;
  const bool odd = (g >> 4) & 1;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    // odd: [0, c0, .., c16]; even: [c0, .., c16, 0]
    const uint32_t lo = odd ? (j ? contrib[2 * j - 1] : 0u) : contrib[2 * j];
    const uint32_t hi =
        odd ? contrib[2 * j] : (j < 8 ? contrib[2 * j + 1] : 0u);
    vals[j] = lo | (hi << 16);
  }
}

}  // namespace psx
