// NV21 frames into K1's pixel rows and each block's quantized DC, in one
// pass over the frames.
//
// Replaces no TPU kernel. It replaces the glue in front of the fused select
// that psxavenc_tpu leaves to XLA (psxavenc_tpu/api.py:96
// _frames_to_pixrows, and the DC sums of psxavenc_tpu/ops/bs.py:742), which
// the port ran as plain torch ops. Plain version:
// ops/bs_cuda.py::nv21_pix_dc_plain (ops/bs.py::rearrange_nv21_rows, then
// ops/bs.py::dc_quant_from_pixrows).
//
// What it computes. frames: (B, w*h*3/2) uint8 NV21, the w x h luma plane
// and then h/2 rows of w/2 interleaved (V, U) pairs; w and h multiples of
// 16. pix: (B, 64, NB) int8, NB = 6 (w/16) (h/16); column n is block n in
// encode order (macroblocks column-major, blocks Cr, Cb, Y1-Y4;
// mdec.c:605-634) and row 8r + c its sample (r, c) as p ^ 0x80 = p - 128.
// dc_q: (B, NB) int32, the block's centered sum, which is the islow FDCT's
// DC, quantized by 16 with round half away, wrapped to int16 and clamped to
// [-0x200, 0x1FE] (mdec.c:257-267, 438, 671).
//
// What bounds it on the H100: bytes. It reads 1.5 bytes a pixel and writes
// a byte of rows and 1/16 of a DC word a pixel, with a few integer
// operations a byte: 14.7 MB in and 15.7 MB out at B = 128, 320x240, 0.0091
// ms at 3.35 TB/s. The glue it replaces made the rows through three uint8
// copies (the stacked blocks, the XOR, the transposed copy) and summed them
// through an int32 copy (56.25 MiB at once), in 0.206 ms on an H100.
//
// Design. A CTA takes kRun consecutive macroblocks of the batch (the run
// may cross MB columns and frames), a thread for each of their 6 kRun
// blocks. Each thread first loads four of the run's 24 kRun input rows of
// 16 bytes (a macroblock has 16 luma rows of 16 pixels and 8 chroma rows
// of 8 VU pairs), all four loads in flight at once, then scatters them
// into a (64, 6 kRun) shared-memory image of the CTA's output columns: each
// of an input row's 8 sample columns is two neighbouring blocks' samples
// (Y1 and Y2, or Y3 and Y4, or Cr and Cb), one 16-bit store. After one
// barrier each thread walks its own block's column of the image: it stores
// the 64 samples a byte a row, so that a warp's store covers 32
// consecutive columns of one output row, and sums them in a register for
// the DC. Nothing goes through int32 in device memory; there are no atomics
// and no second pass.
#include "bs_common.cuh"

namespace {

constexpr int kRun = 32;                  // macroblocks a CTA
constexpr int kThreads = 6 * kRun;        // a thread a block
constexpr int kInRows = 24;               // 16-byte input rows a macroblock
constexpr int kLoads = kInRows * kRun / kThreads;  // input rows a thread
// The image's row stride in bytes (49 words): the 8 image rows that one
// input row's columns go to fall in 4 banks, not 1.
constexpr int kStride = kThreads + 4;

__global__ void __launch_bounds__(kThreads)
nv21_pix_dc_kernel(const uint8_t* __restrict__ frames, int total_mb,
                   int width, int height, int8_t* __restrict__ pix,
                   int* __restrict__ dc_q) {
  __shared__ __align__(16) uint8_t image[64 * kStride];
  const int mb_y = height >> 4;
  const int mbs = (width >> 4) * mb_y;    // a frame's macroblocks
  const int nb = 6 * mbs;
  const size_t frame_bytes = static_cast<size_t>(width) * height * 3 / 2;
  const size_t luma_bytes = static_cast<size_t>(width) * height;
  const int g0 = blockIdx.x * kRun;
  const int run = min(kRun, total_mb - g0);

  // Input row i of the run is row i % 24 of macroblock i / 24: luma rows
  // 0-15, then chroma rows 0-7.
  uint4 v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kInRows * run) {
      const int j = i / kInRows, q = i - kInRows * j;
      const int g = g0 + j;
      const int b = g / mbs, m = g - b * mbs;
      const int mx = m / mb_y, my = m - mx * mb_y;
      const size_t row = q < 16 ? 16 * my + q
                                : luma_bytes / width + 8 * my + q - 16;
      v[k] = *reinterpret_cast<const uint4*>(
          frames + b * frame_bytes + row * width + 16 * mx);
    }
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kInRows * run) {
      const int j = i / kInRows, q = i - kInRows * j;
      const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      // Luma row q: sample row q % 8 of Y1 and Y2 (q < 8) or Y3 and Y4,
      // pixel c of the left block and pixel 8 + c of the right one.
      // Chroma row q - 16: sample row q - 16 of Cr and Cb, the pair c.
      const bool luma = q < 16;
      const int r = luma ? q & 7 : q - 16;
      uint8_t* dst = image + 8 * r * kStride + 6 * j
                     + (luma ? 2 + 2 * (q >> 3) : 0);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int sh = 8 * (c & 3);
        const uint32_t pair =
            luma ? ((w[c >> 2] >> sh) & 0xFF)
                       | (((w[2 + (c >> 2)] >> sh) & 0xFF) << 8)
                 : (w[c >> 1] >> (16 * (c & 1))) & 0xFFFF;
        *reinterpret_cast<uint16_t*>(dst + c * kStride) =
            static_cast<uint16_t>(pair ^ 0x8080);
      }
    }
  }
  __syncthreads();

  if (threadIdx.x < 6 * run) {
    const int j = threadIdx.x / 6;
    const int g = g0 + j;
    const int b = g / mbs, m = g - b * mbs;
    const size_t n = 6 * m + threadIdx.x - 6 * j;
    int8_t* out = pix + static_cast<size_t>(b) * 64 * nb + n;
    const int8_t* col = reinterpret_cast<const int8_t*>(image) + threadIdx.x;
    int sum = 0;
#pragma unroll 16
    for (int r = 0; r < 64; ++r) {
      const int8_t s = col[r * kStride];
      out[static_cast<size_t>(r) * nb] = s;
      sum += s;
    }
    // ops/bs.py::_div_rounded(sum, 16), then _clamp_coeff.
    const int a = (abs(sum) + 8) >> 4;
    const int dc = psx::wrap16(sum < 0 ? -a : a);
    dc_q[static_cast<size_t>(b) * nb + n] = min(max(dc, -0x200), 0x1FE);
  }
}

}  // namespace

// frames: (batch, width * height * 3 / 2) uint8, 16-byte aligned; pix:
// (batch, 64, NB) int8; dc_q: (batch, NB) int32. The wrapper checks the
// shapes, that width and height are multiples of 16 and that the frames
// hold under 2^31 bytes.
extern "C" int psx_nv21_pix_dc(const void* frames, int batch, int width,
                               int height, void* pix, void* dc_q,
                               void* stream) {
  const int total_mb = batch * (width >> 4) * (height >> 4);
  if (total_mb == 0) return 0;
  nv21_pix_dc_kernel<<<(total_mb + kRun - 1) / kRun, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), total_mb, width, height,
      static_cast<int8_t*>(pix), static_cast<int*>(dc_q));
  return static_cast<int>(cudaGetLastError());
}
