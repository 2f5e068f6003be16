// K1 and K6: first-fit quantization-scale search, one CTA per frame.
//
// K1 replaces psxavenc_tpu/ops/bs_pallas.py::select_scale_pix_pallas
// (_select_pix_kernel, _search_store, ladder_lb, _exact_totals); plain
// version: ops/bs_cuda.py::select_scale_pix_plain. K6 replaces
// bs_pallas.py::select_scale_pallas (_select_kernel); plain version:
// ops/bs_cuda.py::select_scale_plain. Both run search() below, templated
// on the coefficient type and row stride: K1 on its own int16 FDCT output
// (64, nb_pad), K6 on the sweep layout's int32 (63, NB) rows.
//
// K1 first FDCTs every block of the (64, NB) int8 pixel rows into the
// int16 signed zigzag coefficient output (row 63 and the pad lanes up to
// nb_pad are zero). search() finds the first scale s in 1..63 whose exact
// AC bit total is <= thr_ac: bisect the monotone ladder lower bound for the
// first scale that can fit, then walk upward with exact totals. Every scale
// below the bisection's answer has LB > thr, hence exact bits > thr, so the
// walk finds the reference retry loop's choice (mdec.c:663-722). 64 = no
// scale fits (a negative threshold included: LB >= 0); its bits and nz
// are 0.
//
// What bounds it on the H100: integer issue rate. One evaluation at 320x240
// is 63 x 1,800 quantize + run + Huffman steps per frame, and a frame
// needs about six ladder and a few exact evaluations. The TPU kernels
// carried the previous frame's answer as the next frame's search seed
// across their sequential grid; CTAs run in no order here, so every frame
// starts cold (the answer never depends on the seed). The search reads
// the coefficients from global memory: a 320x240 frame's 63 x 1,800 int16
// values (227 KB) stay in L2 across K1's evaluations (128 frames = 29 MB of
// the 50 MB); as K6's int32 rows they are 454 KB a frame, 58 MB for 128
// frames, so K6's evaluations partly stream from device memory.
// Threads own strided blocks, so every coefficient row is read coalesced,
// and the run length is a per-thread counter along the 63 positions
// instead of the TPU's log-shift cummax.
#include "bs_common.cuh"

namespace {

constexpr int kThreads = 512;

struct Divisors {
  int d[63];
  float rcp[63];
};

__device__ void set_divisors(Divisors& dv, int s) {
  if (threadIdx.x < 63) {
    const int d = psx::kQuantZZ[threadIdx.x] * s;
    dv.d[threadIdx.x] = d;
    dv.rcp[threadIdx.x] = 1.0f / static_cast<float>(d);
  }
  __syncthreads();
}

// Exact AC (bits, nonzero count) of this thread's blocks at the divisors.
template <typename T>
__device__ void exact_partial(const T* coefs, int stride, int nb,
                              const Divisors& dv, int& bits, int& nz) {
  bits = 0;
  nz = 0;
  for (int n = threadIdx.x; n < nb; n += blockDim.x) {
    int run = 0;
    for (int p = 0; p < 63; ++p) {
      int a = coefs[p * stride + n];
      a = a < 0 ? -a : a;
      const int d = dv.d[p];
      const int mag = psx::div_floor(a + (d >> 1), d, dv.rcp[p]);
      if (mag) {
        bits += psx::ac_bits(run, mag);
        ++nz;
        run = 0;
      } else {
        ++run;
      }
    }
  }
}

// Ladder lower bound of this thread's blocks (bs_pallas.py:ladder_lb):
// per nonzero, the run-0 class weight plus a run-aware bonus.
template <typename T>
__device__ int ladder_partial(const T* coefs, int stride, int nb,
                              const Divisors& dv) {
  int lb = 0;
  for (int n = threadIdx.x; n < nb; n += blockDim.x) {
    int run = 0;
    for (int p = 0; p < 63; ++p) {
      int a = coefs[p * stride + n];
      a = a < 0 ? -a : a;
      const int d = dv.d[p];
      const int mag = psx::div_floor(a + (d >> 1), d, dv.rcp[p]);
      if (mag) {
        const int c2 = mag >= 2, c3 = mag >= 3;
        const int g = (run < 3 ? run : 3) + (run >= 5) + (run >= 8) +
                      (run >= 10) + 2 * (run >= 14) + (run >= 17);
        lb += 3 + 2 * c2 + c3 + 2 * (mag >= 4) + (mag >= 5) +
              2 * (mag >= 7) + (run >= 1 ? c2 + c3 : 0) + g;
        run = 0;
      } else {
        ++run;
      }
    }
  }
  return lb;
}

// The first-fit search over one frame's coefficient rows 0..62 (at
// ``stride``), by the whole CTA; thread 0 stores the result.
template <typename T>
__device__ void search(const T* coefs, int stride, int nb, int thr,
                       Divisors& dv, int* scratch, int* scale_out,
                       int* bits_out, int* nz_out) {
  // --- lower_bound over [1, 63] of LB(s) <= thr (LB is non-increasing
  // in s); 64 = no scale's bound fits.
  int lo = 0, hi = 64;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    set_divisors(dv, mid);
    const int lb = psx::block_sum(ladder_partial(coefs, stride, nb, dv),
                                  scratch);
    if (lb <= thr) hi = mid; else lo = mid;
  }

  // --- exact first-fit walk from the bound's answer.
  int scale = 64, bits = 0, nz = 0;
  for (int s = hi; s < 64; ++s) {
    set_divisors(dv, s);
    int pb, pn;
    exact_partial(coefs, stride, nb, dv, pb, pn);
    const int tb = psx::block_sum(pb, scratch);
    const int tn = psx::block_sum(pn, scratch);
    if (tb <= thr) {
      scale = s;
      bits = tb;
      nz = tn;
      break;
    }
  }
  if (threadIdx.x == 0) {
    *scale_out = scale;
    *bits_out = bits;
    *nz_out = nz;
  }
}

__global__ void __launch_bounds__(kThreads)
select_pix_kernel(const int8_t* __restrict__ pix,
                  const int* __restrict__ thr_ac, int nb, int nb_pad,
                  int* __restrict__ scale_out, int* __restrict__ bits_out,
                  int* __restrict__ nz_out, int16_t* coefs_out) {
  __shared__ Divisors dv;
  __shared__ int scratch[32];
  const int b = blockIdx.x;
  const int8_t* px = pix + static_cast<size_t>(b) * 64 * nb;
  int16_t* coefs = coefs_out + static_cast<size_t>(b) * 64 * nb_pad;

  // --- FDCT, one block per thread at a time.
  for (int n = threadIdx.x; n < nb_pad; n += blockDim.x) {
    if (n >= nb) {
      for (int p = 0; p < 64; ++p) coefs[p * nb_pad + n] = 0;
      continue;
    }
    int v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) v[i] = px[i * nb + n];
    psx::fdct_islow(v);
#pragma unroll
    for (int k = 1; k < 64; ++k)
      coefs[psx::kZigzagRow[k] * nb_pad + n] = static_cast<int16_t>(v[k]);
    coefs[63 * nb_pad + n] = 0;
  }
  // Makes this CTA's coefficient stores visible to all its threads.
  __syncthreads();

  search(coefs, nb_pad, nb, thr_ac[b], dv, scratch, scale_out + b,
         bits_out + b, nz_out + b);
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const int* __restrict__ c, const int* __restrict__ thr_ac,
              int nb, int* __restrict__ scale_out, int* __restrict__ bits_out,
              int* __restrict__ nz_out) {
  __shared__ Divisors dv;
  __shared__ int scratch[32];
  const int b = blockIdx.x;
  search(c + static_cast<size_t>(b) * 63 * nb, nb, nb, thr_ac[b], dv,
         scratch, scale_out + b, bits_out + b, nz_out + b);
}

}  // namespace

extern "C" int psx_select_scale_pix(const void* pix, const void* thr_ac,
                                    int batch, int nb, int nb_pad,
                                    void* scale, void* bits, void* nz,
                                    void* coefs, void* stream) {
  select_pix_kernel<<<batch, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pix), static_cast<const int*>(thr_ac), nb,
      nb_pad, static_cast<int*>(scale), static_cast<int*>(bits),
      static_cast<int*>(nz), static_cast<int16_t*>(coefs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psx_select_scale(const void* c, const void* thr_ac, int batch,
                                int nb, void* scale, void* bits, void* nz,
                                void* stream) {
  if (batch == 0) return 0;
  select_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c), static_cast<const int*>(thr_ac), nb,
      static_cast<int*>(scale), static_cast<int*>(bits),
      static_cast<int*>(nz));
  return static_cast<int>(cudaGetLastError());
}
