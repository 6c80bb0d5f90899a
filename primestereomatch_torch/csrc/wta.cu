// K2: bilinear upsample of the FGF maps, guide combine, and first-minimum
// argmin over disparities d >= 1, to uint8.
//
// Replaces primestereomatch_tpu/kernels/wta_pallas.py::_wta_kernel_poly
// (launcher _wta_poly_run) and ::_wta_kernel, the generic-ratio kernel the
// TPU falls to where its polyphase layout does not apply. The TPU kernels'
// banded matmuls and polyphase column lerp are layout choices for its
// matrix unit; here the OpenCV INTER_LINEAR tables (row/column source index
// and fraction, computed on the host in float64) serve every ratio: quasi
// (Teddy 112 -> 450), exact (2K 552 -> 2208), below 2x (48 -> 90) and 1
// (subsample=1, where the maps are full resolution) alike.
//
// What bounds it: the function needs each map row-lerped once per (output
// row, low-res column) and column-lerped per output pixel, ~22 flops per
// pixel and disparity at a 4x ratio, and one read of the maps
// (4 x D x h x w f32); the two take about equal time on the H100. This
// kernel redoes both row lerps at every pixel (~43 flops) to stay simple.
// The design is one thread per output pixel looping d = 1..D-1: the 2x2
// taps of a warp's 32 neighbouring pixels fall on a few low-res columns, so the
// loads are served by L1, and the filtered full-resolution volume never
// exists. No atomics, no shared state: the result does not depend on the
// schedule.
//
// Numerics follow ops/guided_filter.py::fgf_wta_low_maps: each map is
// lerped rows first (t[y0]*(1-fy) + t[y1]*fy at both tap columns), then
// columns, and q = a_r*I0 + a_g*I1 + a_b*I2 + b in that order; built with
// -fmad=false, q is bitwise the plain version's, and the strict `<`
// keeps the first minimum.
//
// Layout: maps (B, 4, D, h, w) f32, guide (B, H, W, 3) f32, yi/yf (H,),
// xi/xf (W,) int32/f32, out (B, H, W) uint8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ float up(const float* __restrict__ t, int o00,
                                    int o01, int o10, int o11, float gy,
                                    float fy, float gx, float fx) {
  const float r0 = t[o00] * gy + t[o10] * fy;   // column x0, rows y0/y1
  const float r1 = t[o01] * gy + t[o11] * fy;   // column x1
  return r0 * gx + r1 * fx;
}

__global__ void __launch_bounds__(BX * BY)
upsample_wta_kernel(const float* __restrict__ maps,
                    const float* __restrict__ guide,
                    const int* __restrict__ yi, const float* __restrict__ yf,
                    const int* __restrict__ xi, const float* __restrict__ xf,
                    uint8_t* __restrict__ out, int D, int h, int w, int H,
                    int W) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;

  const int y0 = yi[y], y1 = min(y0 + 1, h - 1);
  const int x0 = xi[x], x1 = min(x0 + 1, w - 1);
  const float fy = yf[y], gy = 1.0f - fy;
  const float fx = xf[x], gx = 1.0f - fx;
  const int o00 = y0 * w + x0, o01 = y0 * w + x1;
  const int o10 = y1 * w + x0, o11 = y1 * w + x1;

  const size_t pix = ((size_t)b * H + y) * W + x;
  const float i0 = guide[pix * 3 + 0];
  const float i1 = guide[pix * 3 + 1];
  const float i2 = guide[pix * 3 + 2];

  const size_t plane = (size_t)h * w;
  const size_t mstride = (size_t)D * plane;
  const float* m0 = maps + (size_t)b * 4 * mstride;

  float best = 0.0f;
  int arg = 1;
  for (int d = 1; d < D; ++d) {
    const float* a_r = m0 + d * plane;
    const float u0 = up(a_r, o00, o01, o10, o11, gy, fy, gx, fx);
    const float u1 = up(a_r + mstride, o00, o01, o10, o11, gy, fy, gx, fx);
    const float u2 = up(a_r + 2 * mstride, o00, o01, o10, o11, gy, fy, gx, fx);
    const float u3 = up(a_r + 3 * mstride, o00, o01, o10, o11, gy, fy, gx, fx);
    const float q = u0 * i0 + u1 * i1 + u2 * i2 + u3;
    if (d == 1 || q < best) {
      best = q;
      arg = d;
    }
  }
  out[pix] = (uint8_t)arg;
}

}  // namespace

extern "C" int psm_upsample_wta(const float* maps, const float* guide,
                                const int* yi, const float* yf, const int* xi,
                                const float* xf, uint8_t* out, int B, int D,
                                int h, int w, int H, int W, void* stream) {
  dim3 block(BX, BY);
  dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
  upsample_wta_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      maps, guide, yi, yf, xi, xf, out, D, h, w, H, W);
  return (int)cudaGetLastError();
}
