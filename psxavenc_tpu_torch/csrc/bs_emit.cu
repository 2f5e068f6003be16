// K3 and K7: winner emission + per-block packing, one thread per block.
//
// K3 replaces psxavenc_tpu/ops/bs_pallas.py::emit_prep_pallas
// (_emit_prep_kernel, _emit_chunk_windows); plain version:
// ops/bs_cuda.py::emit_prep_plain. K7 replaces bs_pallas.py::
// emit_pack_pallas (_emit_pack_kernel); plain version: ops/bs_cuda.py::
// emit_pack_plain. Both run emit_block below.
//
// emit_block, per block at the frame's chosen scale: quantize the 63 AC
// positions (round half away from zero, clamp to [-0x200, 0x1FE]), keep
// the zero-run length as a counter, and place DC, the nonzero ACs'
// closed-form codes and the EOB into eight MSB-first u32 windows held in
// registers (256 bits; longer blocks are cut here and sent down the exact
// overflow path by the caller, which gates on block_bits).
//
// K3, one CTA per frame, then:
//  2. a CTA-wide exclusive scan over the block totals, with the 10-bit EOF
//     block at index NB, gives each block's frame-global bit offset;
//  3. each block's windows are funnel-shifted to their sub-word alignment
//     and packed as little-endian u16 pairs into nine u32 words
//     (ops/bitpack.py:streams_to_u32), at u32 offset e0 = goff >> 5.
// Outputs have NB + 1 entries per frame (no lane padding).
//
// K7, a 2-D grid (block tiles x frames), writes each block's windows as
// its 16-word u16 stream (word 2k = window k >> 16, word 2k + 1 = window k
// & 0xFFFF) with four 16-byte stores, and its bit count. It reads either
// coefficient form: K1's (64, nb_pad) int16 rows or the sweep's (63, NB)
// int32 rows; blocks at or past the true NB (dc_code's width) emit
// nothing.
//
// What bounds them on the H100: integer issue rate of the per-block symbol
// walk (63 positions x quantize + Huffman + two-row window update). The
// windows live in registers (every window index is a compile-time
// constant); K3's raw windows wait for the scan in the vals32 output
// itself (read back by the thread that wrote them), and only the block
// totals pass through shared memory.
#include "bs_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPackThreads = 256;

// The frame's 63 AC divisors and their f32 reciprocals, into shared memory.
__device__ void load_divisors(int* qd, float* qrcp, int s) {
  if (threadIdx.x < 63) {
    const int d = psx::kQuantZZ[threadIdx.x] * s;
    qd[threadIdx.x] = d;
    qrcp[threadIdx.x] = 1.0f / static_cast<float>(d);
  }
  __syncthreads();
}

// Emission of block ``n`` (coefficient rows 0..62 at ``stride``) into the
// windows ``acc``; returns its bits (DC + ACs + EOB, uncut).
template <typename T>
__device__ __forceinline__ int emit_block(const T* coefs, int stride, int n,
                                          int dcb, uint32_t dcc,
                                          const int* qd, const float* qrcp,
                                          uint32_t (&acc)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0;
  psx::place_code(acc, 0, dcb, dcc);
  int o = dcb, run = 0;
  for (int p = 0; p < 63; ++p) {
    const int c = coefs[p * stride + n];
    const int d = qd[p];
    const int mag = psx::div_floor((c < 0 ? -c : c) + (d >> 1), d, qrcp[p]);
    int ac = c < 0 ? -mag : mag;
    ac = min(max(ac, -0x200), 0x1FE);
    if (ac) {
      int bits;
      uint32_t code;
      psx::ac_bits_code(run, ac, bits, code);
      psx::place_code(acc, o, bits, code);
      o += bits;
      run = 0;
    } else {
      ++run;
    }
  }
  psx::place_code(acc, o, 2, 0x2u);  // EOB
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
  load_divisors(qd, qrcp, scale_in[b]);

  // --- 1. per-block emission into registers; raw windows parked in vals.
  for (int n = threadIdx.x; n < nb; n += blockDim.x) {
    const size_t i = static_cast<size_t>(b) * nb + n;
    uint32_t acc[8];
    const int o = emit_block(coefs, nb_pad, n, dc_bits_in[i],
                             static_cast<uint32_t>(dc_code_in[i]), qd, qrcp,
                             acc);
    goff[n] = o;
    bbits_out[i] = o;
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
    uint32_t w[16], v[9];
#pragma unroll
    for (int i = 0; i < 16; ++i)  // word i: high, then low half of window i/2
      w[i] = (i & 1) ? (acc[i >> 1] & 0xFFFFu) : (acc[i >> 1] >> 16);
    const int g = goff[n];
    psx::stream_to_u32(w, g, v);
#pragma unroll
    for (int j = 0; j < 9; ++j) vals[n * 9 + j] = static_cast<int>(v[j]);
    e0_out[static_cast<size_t>(b) * nbe + n] = g >> 5;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPackThreads)
emit_pack_kernel(const T* __restrict__ coefs_in, int rows, int stride, int nb,
                 const int* __restrict__ scale_in,
                 const int* __restrict__ dc_code_in,
                 const int* __restrict__ dc_bits_in,
                 int* __restrict__ streams_out, int* __restrict__ bbits_out) {
  __shared__ int qd[63];
  __shared__ float qrcp[63];
  const int b = blockIdx.y;
  const T* coefs = coefs_in + static_cast<size_t>(b) * rows * stride;
  load_divisors(qd, qrcp, scale_in[b]);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= nb) return;
  const size_t i = static_cast<size_t>(b) * nb + n;
  uint32_t acc[8];
  bbits_out[i] = emit_block(coefs, stride, n, dc_bits_in[i],
                            static_cast<uint32_t>(dc_code_in[i]), qd, qrcp,
                            acc);
  int4* out = reinterpret_cast<int4*>(streams_out + i * 16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = make_int4(static_cast<int>(acc[2 * k] >> 16),
                       static_cast<int>(acc[2 * k] & 0xFFFFu),
                       static_cast<int>(acc[2 * k + 1] >> 16),
                       static_cast<int>(acc[2 * k + 1] & 0xFFFFu));
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

// coefs_int16: 1 for K1's (B, 64, nb_pad) int16 rows, 0 for (B, 63, NB)
// int32 rows; ``rows`` and ``stride`` are the coefficient tensor's last two
// dimensions.
extern "C" int psx_emit_pack(const void* coefs, int coefs_int16, int batch,
                             int rows, int stride, int nb, const void* scale,
                             const void* dc_code, const void* dc_bits,
                             void* streams, void* block_bits, void* stream) {
  if (batch == 0 || nb == 0) return 0;
  const dim3 grid((nb + kPackThreads - 1) / kPackThreads, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(scale);
  const int* dcc = static_cast<const int*>(dc_code);
  const int* dcb = static_cast<const int*>(dc_bits);
  int* out = static_cast<int*>(streams);
  int* bb = static_cast<int*>(block_bits);
  if (coefs_int16)
    emit_pack_kernel<int16_t><<<grid, kPackThreads, 0, s>>>(
        static_cast<const int16_t*>(coefs), rows, stride, nb, sc, dcc, dcb,
        out, bb);
  else
    emit_pack_kernel<int><<<grid, kPackThreads, 0, s>>>(
        static_cast<const int*>(coefs), rows, stride, nb, sc, dcc, dcb, out,
        bb);
  return static_cast<int>(cudaGetLastError());
}
