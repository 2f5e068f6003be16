// K3: winner emission + per-block packing + placement prep, one CTA per
// frame.
//
// Replaces psxavenc_tpu/ops/bs_pallas.py::emit_prep_pallas
// (_emit_prep_kernel, _emit_chunk_windows). Plain version:
// ops/bs_cuda.py::emit_prep_plain.
//
// Per frame, at its chosen scale:
//  1. one thread per block quantizes the 63 AC positions (round half away
//     from zero, clamp to [-0x200, 0x1FE]), keeps the zero-run length as a
//     counter, and places DC, the nonzero ACs' closed-form codes and the
//     EOB into eight MSB-first u32 windows held in registers (256 bits;
//     longer blocks are cut here and sent down the exact overflow path by
//     the caller, which gates on block_bits);
//  2. a CTA-wide exclusive scan over the block totals, with the 10-bit EOF
//     block at index NB, gives each block's frame-global bit offset;
//  3. each block's windows are funnel-shifted to their sub-word alignment
//     and packed as little-endian u16 pairs into nine u32 words
//     (ops/bitpack.py:streams_to_u32), at u32 offset e0 = goff >> 5.
// Outputs have NB + 1 entries per frame (no lane padding).
//
// What bounds it on the H100: integer issue rate of the per-block symbol
// walk (63 positions x quantize + Huffman + two-row window update). The
// windows live in registers (every window index is a compile-time
// constant), the raw windows wait for the scan in the vals32 output
// itself (read back by the thread that wrote them), and only the block
// totals pass through shared memory.
#include "bs_common.cuh"

namespace {

constexpr int kThreads = 512;

// OR a ``b``-bit code into the eight MSB-first windows at in-block bit
// offset ``o`` (bs_pallas.py:_emit_chunk_windows place(), with its shift
// clips). Bits past the 256th are dropped.
__device__ __forceinline__ void place(uint32_t (&acc)[8], int o, int b,
                                      uint32_t code) {
  const int q = o >> 5;
  const int sbits = 64 - (o & 31) - b;
  const int sh = min(max(sbits - 32, 0), 31);
  const int sl = min(max(32 - sbits, 0), 31);
  const uint32_t hi = sbits >= 32 ? code << sh : code >> sl;
  const uint32_t lo = sbits < 32 ? code << min(max(sbits, 0), 31) : 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k == q) acc[k] |= hi;
    if (k == q + 1) acc[k] |= lo;
  }
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

__global__ void __launch_bounds__(kThreads)
emit_prep_kernel(const int16_t* __restrict__ coefs_in, int nb_pad, int nb,
                 const int* __restrict__ scale_in,
                 const int* __restrict__ dc_code_in,
                 const int* __restrict__ dc_bits_in, int eof, int* vals_out,
                 int* __restrict__ e0_out, int* __restrict__ bbits_out,
                 int* __restrict__ total_out) {
  extern __shared__ int goff[];  // nb + 1 block totals, then offsets
  __shared__ int qd[63];
  __shared__ float qrcp[63];
  __shared__ int scratch[32];

  const int b = blockIdx.x;
  const int nbe = nb + 1;
  const int16_t* coefs = coefs_in + static_cast<size_t>(b) * 64 * nb_pad;
  int* vals = vals_out + static_cast<size_t>(b) * nbe * 9;
  const int s = scale_in[b];
  if (threadIdx.x < 63) {
    const int d = psx::kQuantZZ[threadIdx.x] * s;
    qd[threadIdx.x] = d;
    qrcp[threadIdx.x] = 1.0f / static_cast<float>(d);
  }
  __syncthreads();

  // --- 1. per-block emission into registers; raw windows parked in vals.
  for (int n = threadIdx.x; n < nb; n += blockDim.x) {
    uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const int dcb = dc_bits_in[static_cast<size_t>(b) * nb + n];
    place(acc, 0, dcb,
          static_cast<uint32_t>(dc_code_in[static_cast<size_t>(b) * nb + n]));
    int o = dcb, run = 0;
    for (int p = 0; p < 63; ++p) {
      const int c = coefs[p * nb_pad + n];
      const int d = qd[p];
      const int mag = psx::div_floor((c < 0 ? -c : c) + (d >> 1), d, qrcp[p]);
      int ac = c < 0 ? -mag : mag;
      ac = min(max(ac, -0x200), 0x1FE);
      if (ac) {
        int bits;
        uint32_t code;
        psx::ac_bits_code(run, ac, bits, code);
        place(acc, o, bits, code);
        o += bits;
        run = 0;
      } else {
        ++run;
      }
    }
    place(acc, o, 2, 0x2u);  // EOB
    o += 2;
    goff[n] = o;
    bbits_out[static_cast<size_t>(b) * nb + n] = o;
#pragma unroll
    for (int k = 0; k < 8; ++k) vals[n * 9 + k] = static_cast<int>(acc[k]);
  }
  if (threadIdx.x == 0) goff[nb] = 10;  // the end-of-frame code
  __syncthreads();

  // --- 2. frame-global bit offsets.
  const int total = block_exclusive_scan(goff, nbe, scratch);
  if (threadIdx.x == 0) total_out[b] = total;

  // --- 3. funnel shift + LE u16-pair packing (streams_to_u32).
  for (int n = threadIdx.x; n < nbe; n += blockDim.x) {
    uint32_t acc[8];
    if (n < nb) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] = static_cast<uint32_t>(vals[n * 9 + k]);
    } else {
      // The EOF block: a lone 10-bit code at the top of stream word 0.
      acc[0] = static_cast<uint32_t>(eof) << 22;
#pragma unroll
      for (int k = 1; k < 8; ++k) acc[k] = 0;
    }
    const int g = goff[n];
    const int sh = g & 15;
    uint32_t contrib[17];
    uint32_t prev = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // Stream word i: the high then the low half of window i / 2.
      const uint32_t w =
          (i & 1) ? (acc[i >> 1] & 0xFFFFu) : (acc[i >> 1] >> 16);
      contrib[i] = (w >> sh) | ((prev << (16 - sh)) & 0xFFFFu);
      prev = w;
    }
    contrib[16] = (prev << (16 - sh)) & 0xFFFFu;
    const bool odd = (g >> 4) & 1;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      // odd: [0, c0, .., c16]; even: [c0, .., c16, 0]
      const uint32_t lo =
          odd ? (j ? contrib[2 * j - 1] : 0u) : contrib[2 * j];
      const uint32_t hi =
          odd ? contrib[2 * j] : (j < 8 ? contrib[2 * j + 1] : 0u);
      vals[n * 9 + j] = static_cast<int>(lo | (hi << 16));
    }
    e0_out[static_cast<size_t>(b) * nbe + n] = g >> 5;
  }
}

}  // namespace

extern "C" int psx_emit_prep(const void* coefs, int batch, int nb_pad,
                             int nb, const void* scale, const void* dc_code,
                             const void* dc_bits, int eof, void* vals32,
                             void* e0, void* block_bits, void* total_bits,
                             void* stream) {
  const size_t smem = static_cast<size_t>(nb + 1) * sizeof(int);
  cudaFuncSetAttribute(emit_prep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  emit_prep_kernel<<<batch, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), nb_pad, nb,
      static_cast<const int*>(scale), static_cast<const int*>(dc_code),
      static_cast<const int*>(dc_bits), eof, static_cast<int*>(vals32),
      static_cast<int*>(e0), static_cast<int*>(block_bits),
      static_cast<int*>(total_bits));
  return static_cast<int>(cudaGetLastError());
}
