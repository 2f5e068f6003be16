// K2: BS v3/v3dc DC-delta chain + closed-form DC Huffman, the chains as
// segmented scans of threshold functions, a warp per chain part.
//
// Replaces psxavenc_tpu/ops/bs_pallas.py::dc_stage_pallas
// (_dc_chain_kernel). Plain version: ops/bs_cuda.py::dc_stage_plain; the
// plain model of this decomposition: ops/bs_cuda.py::
// dc_stage_segmented_plain.
//
// Reference semantics (mdec.c:455-480): per block type (Cr, Cb, Y), in
// encode order, delta = round_half_away((dc - last) / 4), last += 4 * delta;
// v3dc then wraps the delta into [-0x80, 0x80] (``last`` keeps the
// unwrapped value). The key delta & 0x1FF gets its closed-form DC code.
//
// ``last`` stays a multiple of 4, so each block maps it through a threshold
// function f(x) = a if x < t else b (ops/bs.py:dc_chain): a DC that is 2
// mod 4 gives t = dc, a = dc + 2, b = dc - 2; any other DC is a constant
// (t = NEG_INF, a = b). Such functions compose into one of the same form:
// p then q is (t_p, q(a_p), q(b_p)).
//
// What bounds it on the H100: latency. Its bytes (0.0008 ms at B = 128,
// 320x240) are below one launch's own cost; walking a chain in order costs
// a dependent step per block (1,200 for the Y chain at 320x240). Here a
// frame's chains are cut into six parts of NB / 6 blocks each: Cr, Cb, and
// the Y chain in four quarters, a warp each (192 threads a frame; up to
// four frames a CTA when the batch outnumbers the SMs). The CTA stages its
// frames' DCs in shared memory in chain order with coalesced loads. Then
// each lane composes its own contiguous segment of its part into one
// (t, a, b), a 5-step shuffle scan over the lanes gives each lane the
// composition of the segments before it, the Y quarters apply the earlier
// quarters' totals to 0 (at most three steps), and each lane walks its
// segment again from its entry ``last``, computing the deltas and their
// codes into shared memory, which the CTA then stores coalesced. A step of
// a walk is a compare and two selects; at 320x240 a lane has 10 blocks.
#include "bs_common.cuh"

namespace {

constexpr int kParts = 6;                 // Cr, Cb, four Y quarters
constexpr int kFrameThreads = 32 * kParts;
constexpr int kMaxFrames = 4;             // frames a CTA
constexpr int kNegInf = -0x7FFFFFFF;       // ops/bs.py:_NEG_INF
constexpr unsigned kAllLanes = 0xFFFFFFFFu;  // every lane scans (the
                                             // lanes past a part's end hold
                                             // the identity)

// A threshold function x -> x < t ? a : b, or the identity.
struct Step {
  int t, a, b;
  bool id;
  __device__ __forceinline__ int apply(int x) const {
    return id ? x : (x < t ? a : b);
  }
};

__device__ __forceinline__ Step block_step(int d) {
  const int r = d & 3;
  if (r == 2) return {d, d + 2, d - 2, false};
  const int c = r == 0 ? d : r == 1 ? d - 1 : d + 1;
  return {kNegInf, c, c, false};
}

// p, then q.
__device__ __forceinline__ Step compose(const Step& p, const Step& q) {
  if (q.id) return p;
  if (p.id) return q;
  return {p.t, q.apply(p.a), q.apply(p.b), false};
}

__device__ __forceinline__ Step shfl_up(const Step& s, int off) {
  return {__shfl_up_sync(kAllLanes, s.t, off),
          __shfl_up_sync(kAllLanes, s.a, off),
          __shfl_up_sync(kAllLanes, s.b, off),
          __shfl_up_sync(kAllLanes, static_cast<int>(s.id), off) != 0};
}

// Block n of a frame -> its place in chain order: Cr (mb), Cb (mb), then
// the Y chain (4 mb), whose quarters are parts 2-5.
__device__ __forceinline__ int chain_pos(int n, int mb) {
  const int m = n / 6, r = n - 6 * m;
  return r < 2 ? r * mb + m : 2 * mb + 4 * m + r - 2;
}

__global__ void __launch_bounds__(kFrameThreads * kMaxFrames)
dc_chain_kernel(const int* __restrict__ dc_q, int batch, int nb,
                int frames_per_cta, int v3dc, int* __restrict__ bits_out,
                int* __restrict__ code_out) {
  extern __shared__ int smem[];
  __shared__ Step totals[kMaxFrames][kParts];
  const int mb = nb / 6;
  const int f = threadIdx.x / kFrameThreads;
  const int frame = blockIdx.x * frames_per_cta + f;
  const bool live = f < frames_per_cta && frame < batch;
  int* dc = smem + f * 2 * nb;   // chain order; the bits overwrite the DCs
  int* code = dc + nb;
  const size_t base = static_cast<size_t>(frame) * nb;
  const int ft = threadIdx.x - f * kFrameThreads;
  if (live)
    for (int n = ft; n < nb; n += kFrameThreads)
      dc[chain_pos(n, mb)] = dc_q[base + n];
  __syncthreads();

  const int part = ft >> 5, lane = threadIdx.x & 31;
  const int seg = (mb + 31) >> 5;
  const int e0 = min(lane * seg, mb), e1 = min(e0 + seg, mb);
  int* pd = dc + part * mb;
  int* pc = code + part * mb;

  // Pass 1: the lane's segment composed into one function (the identity
  // for a lane past the part's end).
  Step s = {0, 0, 0, true};
  if (live && e0 < e1) {
    s = block_step(pd[e0]);
    for (int e = e0 + 1; e < e1; ++e) {
      const Step q = block_step(pd[e]);
      s.a = q.apply(s.a);
      s.b = q.apply(s.b);
    }
  }
  // Inclusive scan over the lanes, then the exclusive prefix.
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Step p = shfl_up(s, off);
    if (lane >= off) s = compose(p, s);
  }
  Step before = shfl_up(s, 1);
  if (lane == 0) before.id = true;
  if (lane == 31 && live) totals[f][part] = s;
  __syncthreads();

  if (live) {
    // A Y quarter starts where the quarters before it leave ``last``.
    int x = 0;
    for (int q = 2; q < part; ++q) x = totals[f][q].apply(x);
    int last = before.apply(x);
    // Pass 2: the deltas and their codes.
    for (int e = e0; e < e1; ++e) {
      const int next = block_step(pd[e]).apply(last);
      int delta = (next - last) >> 2;
      last = next;
      if (v3dc) {
        if (delta < -0x80) delta += 0x100;
        if (delta > 0x80) delta -= 0x100;
      }
      int b, c;
      psx::dc_bits_code(part >= 2, delta & 0x1FF, b, c);
      pd[e] = b;
      pc[e] = c;
    }
  }
  __syncthreads();
  if (live)
    for (int n = ft; n < nb; n += kFrameThreads) {
      const int p = chain_pos(n, mb);
      bits_out[base + n] = dc[p];
      code_out[base + n] = code[p];
    }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int psx_dc_stage(const void* dc_q, int batch, int nb, int v3dc,
                            void* bits, void* code, void* stream) {
  if (batch == 0) return 0;
  const size_t frame_smem = static_cast<size_t>(2) * nb * sizeof(int);
  // More than one frame a CTA only when the frames outnumber the SMs, and
  // as many as shared memory holds.
  const int sms = psx::sm_count();
  const int fpc = std::max(
      1, std::min({(batch + sms - 1) / sms, kMaxFrames,
                   static_cast<int>(200 * 1024 / frame_smem)}));
  const size_t smem = fpc * frame_smem;
  cudaFuncSetAttribute(dc_chain_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int grid = (batch + fpc - 1) / fpc;
  dc_chain_kernel<<<grid, fpc * kFrameThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dc_q), batch, nb, fpc, v3dc,
      static_cast<int*>(bits), static_cast<int*>(code));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel at a given grid: the floor of a launch, against which
// K2's time is read.
extern "C" int psx_empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
