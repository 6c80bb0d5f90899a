// K4: the sampled matching cost built inside the low-maps kernel, for Hopper.
//
// Replaces primestereomatch_tpu/kernels/cvc_lowmaps_pallas.py::
// _cvc_lowmaps_kernel. Per disparity d of one view it evaluates the cost
// at the FGF's sample grid (full-resolution rows yi, columns xi; the other
// view read at xi - d for a left view, xi + d for a right one, the border
// cost where that falls outside the image) and runs K1's coefficient chain
// on it, so the (D, h, w) cost volume never exists in device memory.
//
// The TPU kernel cuts the other view into polyphase planes, rotates lanes
// by the whole-pixel shift and rebuilds the reflect-101 column margins in
// place, because reflection does not commute with the disparity shift.
// Here each entry of the block's shared-memory band is simply the cost at
// the reflected in-image low-res pixel, which is reflect-101 of the cost
// plane exactly; the sample tables serve every geometry.
//
// What bounds it: it writes 4 maps per cost value and reads only the
// images, their gradients and the 12 statistic planes, so the map writes
// are the function's bound (bytes). All D slices of a tile read the same
// image rows, shifted; the second and later reads come from L2.
//
// Numerics: the cost follows ops/cost_volume.py::_pair_cost term by term
// and the chain is fgf_chain.cuh; built with -fmad=false the maps equal the
// plain version's (sampled cost volume, then K1's plain version) bit for bit.
//
// Layout: views (2B, H, W, 3) f32 and their Sobel-x gradients (2B, H, W),
// the B left views first and then the B right ones: view v < B is matched
// against view v + B at x - d, view v >= B against view v - B at x + d.
// stats (2B, 12, h, w), yi (h,) and xi (w,) int32, out (2B, 4, D, h, w).
// Grid (ceil(w/TW), ceil(h/TH), 2B*D).

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

__global__ void __launch_bounds__(NTHREADS)
cvc_lowmaps_kernel(const float* __restrict__ views, const float* __restrict__ grds,
                   const float* __restrict__ stats, const int* __restrict__ yi,
                   const int* __restrict__ xi, float* __restrict__ out, int B,
                   int D, int H, int W, int h, int w, int k, float inv_k2,
                   fgf::CostParams cp) {
  extern __shared__ float smem[];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int vd = blockIdx.z;          // v * D + d
  const int v = vd / D, d = vd - v * D;
  const bool is_left = v < B;
  const int ov = is_left ? v + B : v - B;
  const size_t hw = (size_t)h * w, HW = (size_t)H * W;
  const float* img = views + (size_t)v * HW * 3;
  const float* grd = grds + (size_t)v * HW;
  const float* oimg = views + (size_t)ov * HW * 3;
  const float* ogrd = grds + (size_t)ov * HW;
  const float* st = stats + (size_t)v * 12 * hw;
  const int tid = threadIdx.x;
  const int M = 2 * (k / 2);

  // band of the cost and ch_c * cost at the reflected in-image pixels
  for (int i = tid; i < (TH + 2 * M) * (TW + 2 * M); i += NTHREADS) {
    int iy, ix;
    fgf::band_index(i, TW, k, y0, x0, h, w, &iy, &ix);
    const int X = xi[ix];
    const size_t row = (size_t)yi[iy] * W;
    const float* a3 = img + (row + X) * 3;
    const float a[4] = {a3[0], a3[1], a3[2], grd[row + X]};
    const float p = fgf::sampled_cost(a, oimg + row * 3, ogrd + row, X, d,
                                      is_left, W, cp);
    fgf::band_store(smem, TH, TW, k, i, p, a[0], a[1], a[2]);
  }
  const StoreMaps store{
      out + ((size_t)v * 4 * D + d) * hw + (size_t)y0 * w + x0,
      (size_t)D * hw, w};
  fgf::chain<NTHREADS>(smem, st, h, w, k, inv_k2, TH, TW, y0, x0,
                       min(TH, h - y0), min(TW, w - x0), tid, store);
}

}  // namespace

extern "C" int psm_cvc_lowmaps(const float* views, const float* grds,
                               const float* stats, const int* yi, const int* xi,
                               float* out, int B, int D, int H, int W, int h,
                               int w, int k, float inv_k2, float alpha,
                               float one_minus_alpha, float border, float tau1,
                               float tau2, void* stream) {
  const size_t smem = sizeof(float) * fgf::chain_floats(TH, TW, k);
  cudaError_t err = cudaFuncSetAttribute(
      cvc_lowmaps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const fgf::CostParams cp{alpha, one_minus_alpha, border, tau1, tau2};
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, 2 * B * D);
  cvc_lowmaps_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      views, grds, stats, yi, xi, out, B, D, H, W, h, w, k, inv_k2, cp);
  return (int)cudaGetLastError();
}
