// K2: BS v3/v3dc DC-delta chain + closed-form DC Huffman, one CTA per
// frame.
//
// Replaces psxavenc_tpu/ops/bs_pallas.py::dc_stage_pallas
// (_dc_chain_kernel). Plain version: ops/bs_cuda.py::dc_stage_plain.
//
// Reference semantics (mdec.c:455-480): per block type (Cr, Cb, Y), in
// encode order, delta = round_half_away((dc - last) / 4), last += 4 * delta;
// v3dc then wraps the delta into [-0x80, 0x80] (``last`` keeps the
// unwrapped value). The key delta & 0x1FF gets its closed-form DC code.
//
// What bounds it on the H100: the chains are sequential and short (at most
// 4 * NB / 6 = 1,200 steps at 320x240), so it is latency bound. The TPU
// kernel ran the chain as a log-depth threshold-function scan over lanes;
// here the CTA stages the frame's DCs in shared memory with coalesced
// loads, three threads walk the Cr, Cb and Y chains at shared-memory
// latency, and the codes go back out coalesced.
#include "bs_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
dc_chain_kernel(const int* __restrict__ dc_q, int nb, int v3dc,
                int* __restrict__ bits_out, int* __restrict__ code_out) {
  extern __shared__ int smem[];
  int* dc = smem;            // nb
  int* bits = smem + nb;     // nb
  int* code = smem + 2 * nb; // nb
  const size_t base = static_cast<size_t>(blockIdx.x) * nb;
  for (int n = threadIdx.x; n < nb; n += blockDim.x) dc[n] = dc_q[base + n];
  __syncthreads();

  const int chain = threadIdx.x;  // 0 = Cr, 1 = Cb, 2 = Y
  if (chain < 3) {
    const int mb = nb / 6;
    const int len = chain < 2 ? mb : 4 * mb;
    int last = 0;
    for (int k = 0; k < len; ++k) {
      const int idx = chain < 2 ? 6 * k + chain : 6 * (k >> 2) + 2 + (k & 3);
      const int diff = dc[idx] - last;
      const int q = ((diff < 0 ? -diff : diff) + 2) >> 2;
      int delta = diff < 0 ? -q : q;
      last += 4 * delta;
      if (v3dc) {
        if (delta < -0x80) delta += 0x100;
        if (delta > 0x80) delta -= 0x100;
      }
      int b, c;
      psx::dc_bits_code(chain == 2, delta & 0x1FF, b, c);
      bits[idx] = b;
      code[idx] = c;
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < nb; n += blockDim.x) {
    bits_out[base + n] = bits[n];
    code_out[base + n] = code[n];
  }
}

}  // namespace

extern "C" int psx_dc_stage(const void* dc_q, int batch, int nb, int v3dc,
                            void* bits, void* code, void* stream) {
  const size_t smem = static_cast<size_t>(3) * nb * sizeof(int);
  cudaFuncSetAttribute(dc_chain_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dc_chain_kernel<<<batch, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dc_q), nb, v3dc, static_cast<int*>(bits),
      static_cast<int*>(code));
  return static_cast<int>(cudaGetLastError());
}
