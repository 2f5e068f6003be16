// K4: bitstream placement, one thread per (frame, block, word slot).
//
// Replaces psxavenc_tpu/ops/bitpack_pallas.py::place_vals_mxu_pallas
// (_mxu_place_kernel). Plain version: ops/bitpack_cuda.py::place_vals_plain.
//
// Each block contributes nine u32 words at u32 offset e0; contributions of
// different blocks are bit-disjoint, so the frame's words are their OR,
// independent of order. The TPU kernel spread byte planes with one-hot
// bf16 matmuls because it has an MXU and no scatter; here every nonzero
// word is one atomicOr into the zeroed output. Words at or past cap32 are
// dropped (an unfittable frame, emitted at scale 1, can run past its
// budget; the caller raises for it).
//
// What bounds it on the H100: memory traffic, about 40 bytes read per
// block plus the atomics into the L2-resident output (128 x 18 KB at the
// headline size).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ vals32, const int* __restrict__ e0,
             int nbe, int cap32, long long count,
             unsigned int* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  const uint32_t v = static_cast<uint32_t>(vals32[idx]);
  if (v == 0) return;
  const long long block = idx / 9;
  const int slot = static_cast<int>(idx - block * 9);
  const long long frame = block / nbe;
  const long long w = static_cast<long long>(e0[block]) + slot;
  if (w < 0 || w >= cap32) return;
  atomicOr(out + frame * cap32 + w, v);
}

}  // namespace

extern "C" int psx_place_vals(const void* vals32, const void* e0, int batch,
                              int nbe, int cap32, void* out, void* stream) {
  const long long count = static_cast<long long>(batch) * nbe * 9;
  const long long grid = (count + kThreads - 1) / kThreads;
  place_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vals32), static_cast<const int*>(e0), nbe,
      cap32, count, static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}
