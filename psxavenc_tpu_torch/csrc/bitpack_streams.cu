// K10: dense per-block packing of symbol tensors, and K9: placement of the
// per-block streams, one thread per block.
//
// K10 replaces psxavenc_tpu/ops/bitpack_pallas.py::pack_block_streams_pallas
// (_pack_kernel); plain version: ops/bitpack_cuda.py::
// pack_block_streams_plain (ops/bitpack.py:_pack_block_streams). Each
// block's S (code, bits) symbols are placed in order into eight MSB-first
// u32 windows in registers (psx::place_code) and
// written as its 16-word u16 stream and its bit count. Symbols of 0 bits
// are skipped and each code is masked to its length, as the windowed
// shift/mask of _pack_block_streams does; bits past the 256th are cut
// there and here alike. A CTA stages its 64 blocks' symbols (contiguous
// rows of the (B, NBe, S) tensors) through shared memory with coalesced
// loads; a thread then reads its own row at a stride of S words, which is
// odd for S = 65, so the reads hit distinct banks.
//
// K9 replaces bitpack_pallas.py::place_streams_pallas (_kernel); plain
// version: ops/bitpack_cuda.py::place_streams_plain (ops/bitpack.py:
// _place_streams). The TPU kernel swept each frame's blocks in order
// through a sliding 256-lane window with dynamic lane rotates, because it
// has no scatter; here each block computes its nine placed u32 words
// (psx::stream_to_u32) and ORs every nonzero one below cap32
// into the zeroed output with atomicOr. Different blocks' words are
// bit-disjoint, so the order does not matter. Words at or past cap32 drop
// (the TPU kernel instead clamps its flushes for an unfittable frame); the
// kernel writes nothing outside the (B, cap32) output.
//
// What bounds them on the H100: memory traffic. K10 reads 2 x 65 int32
// words and writes 17 per block (about 0.11 GB at 128 x 1,801 blocks); K9
// reads 17 words per block and ORs at most nine into the L2-resident
// output.
#include "bs_common.cuh"

namespace {

constexpr int kPackRows = 64;
constexpr int kPlaceThreads = 256;

__global__ void __launch_bounds__(kPackRows)
pack_kernel(const int* __restrict__ codes, const int* __restrict__ bits,
            long long rows, int nsym, int* __restrict__ streams,
            int* __restrict__ block_bits) {
  extern __shared__ int sym[];  // kPackRows * nsym codes, then their bits
  int* sc = sym;
  int* sb = sym + kPackRows * nsym;
  const long long r0 = static_cast<long long>(blockIdx.x) * kPackRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kPackRows),
                                      rows - r0));
  const size_t base = static_cast<size_t>(r0) * nsym;
  for (int i = threadIdx.x; i < nr * nsym; i += blockDim.x) {
    sc[i] = codes[base + i];
    sb[i] = bits[base + i];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= nr) return;

  const int* c = sc + threadIdx.x * nsym;
  const int* bl = sb + threadIdx.x * nsym;
  uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int o = 0;
  for (int i = 0; i < nsym; ++i) {
    const int b = bl[i];
    if (b > 0) {
      const uint32_t mask = b >= 32 ? 0xFFFFFFFFu : (1u << b) - 1u;
      psx::place_code(acc, o, b, static_cast<uint32_t>(c[i]) & mask);
    }
    o += b;
  }
  const size_t r = static_cast<size_t>(r0) + threadIdx.x;
  block_bits[r] = o;
  int4* out = reinterpret_cast<int4*>(streams + r * 16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = make_int4(static_cast<int>(acc[2 * k] >> 16),
                       static_cast<int>(acc[2 * k] & 0xFFFFu),
                       static_cast<int>(acc[2 * k + 1] >> 16),
                       static_cast<int>(acc[2 * k + 1] & 0xFFFFu));
}

__global__ void __launch_bounds__(kPlaceThreads)
place_streams_kernel(const int* __restrict__ streams,
                     const int* __restrict__ goff, long long nblocks, int nbe,
                     int cap32, unsigned int* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nblocks) return;
  const int4* s4 = reinterpret_cast<const int4*>(streams + idx * 16);
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 q = s4[k];
    w[4 * k] = static_cast<uint32_t>(q.x);
    w[4 * k + 1] = static_cast<uint32_t>(q.y);
    w[4 * k + 2] = static_cast<uint32_t>(q.z);
    w[4 * k + 3] = static_cast<uint32_t>(q.w);
  }
  const int g = goff[idx];
  uint32_t v[9];
  psx::stream_to_u32(w, g, v);
  unsigned int* frame_out = out + (idx / nbe) * cap32;
  const int e0 = g >> 5;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int word = e0 + j;
    if (v[j] && word >= 0 && word < cap32) atomicOr(frame_out + word, v[j]);
  }
}

}  // namespace

extern "C" int psx_pack_block_streams(const void* codes, const void* bits,
                                      int rows, int nsym, void* streams,
                                      void* block_bits, void* stream) {
  if (rows == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(kPackRows) * nsym * sizeof(int);
  cudaFuncSetAttribute(pack_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int grid = (rows + kPackRows - 1) / kPackRows;
  pack_kernel<<<grid, kPackRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), static_cast<const int*>(bits), rows,
      nsym, static_cast<int*>(streams), static_cast<int*>(block_bits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psx_place_streams(const void* streams, const void* goff,
                                 int batch, int nbe, int cap32, void* out,
                                 void* stream) {
  const long long nblocks = static_cast<long long>(batch) * nbe;
  if (nblocks == 0) return 0;
  const long long grid = (nblocks + kPlaceThreads - 1) / kPlaceThreads;
  place_streams_kernel<<<static_cast<unsigned int>(grid), kPlaceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(goff),
      nblocks, nbe, cap32, static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}
