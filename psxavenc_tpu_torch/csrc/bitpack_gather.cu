// K8: bitstream placement, output-stationary: one thread per (frame, output
// u32 word).
//
// Replaces psxavenc_tpu/ops/bitpack_pallas.py::place_vals_gather_pallas
// (_gather_kernel). Plain version: ops/bitpack_cuda.py::
// place_vals_gather_plain. Same function as K4 (csrc/bitpack_place.cu):
// frame b's word w is the OR of vals32[b, j, w - e0[b, j]] over the blocks
// j with 0 <= w - e0[b, j] < 9, for w < cap32.
//
// The TPU kernel finds each 128-lane output tile's candidate blocks with
// two searchsorteds over the monotone offsets, loads 32-row windows at
// 8-aligned starts from padded, sentinel-filled rows, applies nine
// compare/selects per candidate and sums over the candidates (the
// contributions are bit-disjoint). The scalar prefetch, the alignment and
// padding and the sequential grid do not carry over. Here each thread
// binary-searches its frame's non-decreasing e0 row for the last block with
// e0 <= w, then walks back over the blocks with e0 >= w - 8 (ties
// included), ORing the one slot each contributes. It writes its word
// exactly once, zeros included: no atomics and no zero-fill (the wrapper
// allocates with torch.empty). Words of an unfittable frame past cap32 are
// never computed, so they drop as K4 drops them.
//
// What bounds it on the H100: memory traffic, the same bytes as K4 (each
// block's 40 bytes read once, the (B, cap32) words written once: 11.5 MB at
// 128 frames of 320x240 and 18,144 bytes, about 0.0034 ms at 3.35 TB/s).
// Neighbouring threads search the same e0 row and read overlapping blocks,
// so the repeated reads hit L1/L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ vals32, const int* __restrict__ e0,
              int nbe, int cap32, unsigned int* __restrict__ out) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= cap32) return;
  const long long frame = blockIdx.y;
  const int* e = e0 + frame * nbe;
  const int* v = vals32 + frame * nbe * 9;
  // lo: the first block with e0 > w (upper bound).
  int lo = 0, hi = nbe;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(e + mid) <= w) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  uint32_t acc = 0;
  for (int j = lo - 1; j >= 0; --j) {
    const int d = w - __ldg(e + j);
    if (d > 8) break;
    acc |= static_cast<uint32_t>(__ldg(v + static_cast<long long>(j) * 9 + d));
  }
  out[frame * cap32 + w] = acc;
}

}  // namespace

extern "C" int psx_place_vals_gather(const void* vals32, const void* e0,
                                     int batch, int nbe, int cap32, void* out,
                                     void* stream) {
  if (batch <= 0 || cap32 <= 0) return 0;
  const dim3 grid((cap32 + kThreads - 1) / kThreads, batch);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vals32), static_cast<const int*>(e0), nbe, cap32,
      static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}
