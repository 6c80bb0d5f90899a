// K1: low-resolution FastGuidedFilter coefficient chain, for Hopper.
//
// Replaces primestereomatch_tpu/kernels/lowmaps_pallas.py::_lowmaps_kernel
// (body _maps_chain, _box_valid). Per cost slice p (one disparity of one
// view) it computes box(p) and box(I_c * p) for the three guide channels,
// the covariance, (a_r, a_g, a_b, b) through the symmetric inverse, and a
// box average of each map again. k x k boxes, reflect-101 borders.
//
// What bounds it: at the slice's shapes (Teddy D=64 at 93x112, 2K D=256 at
// 310x552, k=5) it moves 4 output maps per input cost value and does about
// 100 flops per value, so device memory traffic is the bound. The design
// reads each cost value once per tile (plus a halo of 2*(k/2) on each
// side), keeps the whole chain in shared memory, and writes each map once.
// The 12 guide-statistic planes are shared by all D slices and stay in L2.
//
// The chain itself (fgf_chain.cuh) is shared with K4 and K10 and follows
// ops/guided_filter.py step for step; built with -fmad=false, the maps
// agree with the plain version bit for bit.
//
// Layout: p (B, D, h, w) f32, stats (B, 12, h, w) f32 = [ch 0..2, box
// means 0..2, inverse covariance rr rg rb gg gb bb], out (B, 4, D, h, w).
// Grid (ceil(w/TW), ceil(h/TH), B*D), one block per output tile and slice.

#include <cuda_runtime.h>

#include "fgf_chain.cuh"

namespace {

constexpr int TH = 32;
constexpr int TW = 32;
constexpr int NTHREADS = 256;

struct StoreMaps {
  float* out;   // the view's (4, D, h, w) maps at this slice and tile origin
  size_t cstride;
  int w;
  __device__ void operator()(int c, int ty, int tx, float v) const {
    out[c * cstride + (size_t)ty * w + tx] = v;
  }
};

template <int K>
__global__ void __launch_bounds__(NTHREADS)
lowmaps_kernel(const float* __restrict__ p, const float* __restrict__ stats,
               float* __restrict__ out, int D, int h, int w, int k,
               float inv_k2) {
  extern __shared__ __align__(16) float smem[];
  const int kk = K > 0 ? K : k;       // the box size, at compile time where K is
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int bd = blockIdx.z;          // b * D + d
  const int b = bd / D;
  const size_t hw = (size_t)h * w;
  const float* ps = p + (size_t)bd * hw;
  const float* st = stats + (size_t)b * 12 * hw;
  const int tid = threadIdx.x;
  const int M = 2 * (kk / 2);

  // band of p and ch_c * p
  for (int i = tid; i < (TH + 2 * M) * (TW + 2 * M); i += NTHREADS) {
    int iy, ix;
    fgf::band_index(i, TW, kk, y0, x0, h, w, &iy, &ix);
    const size_t o = (size_t)iy * w + ix;
    fgf::band_store(smem, TH, TW, kk, i, ps[o], st[o], st[hw + o], st[2 * hw + o]);
  }
  const StoreMaps store{
      out + ((size_t)b * 4 * D + (bd - b * D)) * hw + (size_t)y0 * w + x0,
      (size_t)D * hw, w};
  fgf::chain<NTHREADS, K>(smem, st, h, w, kk, inv_k2, TH, TW, y0, x0,
                          min(TH, h - y0), min(TW, w - x0), tid, store);
}

template <int K>
int launch(const float* p, const float* stats, float* out, int B, int D, int h,
           int w, int k, float inv_k2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fgf::chain_floats(TH, TW, k);
  cudaError_t err = cudaFuncSetAttribute(
      lowmaps_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B * D);
  lowmaps_kernel<K><<<grid, NTHREADS, smem, stream>>>(p, stats, out, D, h, w, k, inv_k2);
  return (int)cudaGetLastError();
}

}  // namespace

// The boxes of subsample 8, 4, 2 and 1 at gif_radius 8 are instantiated;
// any other odd k takes the run-time instance.
extern "C" int psm_lowmaps(const float* p, const float* stats, float* out,
                           int B, int D, int h, int w, int k, float inv_k2,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 3: return launch<3>(p, stats, out, B, D, h, w, k, inv_k2, s);
    case 5: return launch<5>(p, stats, out, B, D, h, w, k, inv_k2, s);
    case 9: return launch<9>(p, stats, out, B, D, h, w, k, inv_k2, s);
    case 17: return launch<17>(p, stats, out, B, D, h, w, k, inv_k2, s);
    default: return launch<0>(p, stats, out, B, D, h, w, k, inv_k2, s);
  }
}
