// K10: matching cost, FGF coefficient chain, bilinear upsample, guide
// combine and first-minimum argmin in one kernel, for Hopper.
//
// Replaces primestereomatch_tpu/kernels/cvc_wta_pallas.py::_cvc_wta_kernel
// and ::_cvc_wta_kernel_fori (two schedules of one function on the TPU; one
// kernel here). Neither the (D, h, w) cost volume nor the (4, D, h, w)
// coefficient maps ever exist in device memory: the function reads the two
// views, their gradients and the statistic planes and writes uint8
// disparities, so arithmetic bounds it, not bytes.
//
// Design, simple first: one block per 64 x 64 tile of output pixels. The
// tile's bilinear taps span a small window of low-res pixels (18 x 18 at a
// 4x ratio); the block stages the sampled local view of that window plus
// the chain's halo in shared memory once, then loops d = 1..D-1: cost band
// (fgf_chain.cuh::sampled_cost, the other view's reads served by L1/L2),
// chain (fgf_chain.cuh::chain) into four finished map tiles in shared
// memory, and every thread lerps its 16 output pixels from them and folds
// a strict `<` running (min, argmin) in registers. The band's halo is
// recomputed by every tile (2.6x the window's cost values at k = 5); the
// TPU kernel's row tiles recompute a row halo likewise.
//
// d = 0 is never a candidate, so the TPU kernel's d = 0 poison has no
// counterpart, and the OpenCV INTER_LINEAR tables are clamped at every
// column, so neither has its left-edge fix-up pass.
//
// Numerics: cost and chain as K4 (cvc_lowmaps.cu), lerp and combine in
// wta.cu's order (rows, then columns, then q = a_r*I0 + a_g*I1 + a_b*I2 + b);
// built with -fmad=false the result equals K4 followed by K2 bit for bit.
//
// Layout: views, grds, stats, yi, xi as cvc_lowmaps.cu (the B left views
// first, then the B right ones); ly0/lyf (H,) and lx0/lxf (W,) the
// upsampling tables (low index int32, fraction f32); out (2B, H, W) uint8.
// (lth, ltw) is the largest low-res window any tile needs. Grid
// (ceil(W/64), ceil(H/64), 2B).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fgf_chain.cuh"

namespace {

constexpr int OT = 64;                      // output tile edge
constexpr int NTHREADS = 256;
constexpr int ROWS_PER_PASS = NTHREADS / OT;
constexpr int PPT = OT / ROWS_PER_PASS;     // output pixels per thread

struct StoreTile {
  float* fin;   // 4 planes lth x ltw
  int plane, ltw;
  __device__ void operator()(int c, int ty, int tx, float v) const {
    fin[c * plane + ty * ltw + tx] = v;
  }
};

__device__ __forceinline__ float up(const float* __restrict__ t, int o00,
                                    int o01, int o10, int o11, float gy,
                                    float fy, float gx, float fx) {
  const float r0 = t[o00] * gy + t[o10] * fy;   // column x0, rows y0/y1
  const float r1 = t[o01] * gy + t[o11] * fy;   // column x1
  return r0 * gx + r1 * fx;
}

// Floats of dynamic shared memory: the chain's, the finished map tiles, the
// staged local view (4 planes) and the band's full-resolution (row, column).
inline size_t smem_floats(int lth, int ltw, int k) {
  const int M = 2 * (k / 2);
  const size_t nb = (size_t)(lth + 2 * M) * (ltw + 2 * M);
  return fgf::chain_floats(lth, ltw, k) + 4 * (size_t)lth * ltw + 6 * nb;
}

template <int K>
__global__ void __launch_bounds__(NTHREADS)
cvc_wta_kernel(const float* __restrict__ views, const float* __restrict__ grds,
               const float* __restrict__ stats, const int* __restrict__ yi,
               const int* __restrict__ xi, const int* __restrict__ ly0,
               const float* __restrict__ lyf, const int* __restrict__ lx0,
               const float* __restrict__ lxf, uint8_t* __restrict__ out, int B,
               int D, int H, int W, int h, int w, int k, float inv_k2, int lth,
               int ltw, fgf::CostParams cp) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_r0[OT], s_r1[OT];    // tap rows of each output row, x ltw
  __shared__ float s_fy[OT];

  const int M = 2 * (k / 2);
  const int nb = (lth + 2 * M) * (ltw + 2 * M);
  float* fin = smem + fgf::chain_floats(lth, ltw, k);
  float* lv = fin + 4 * lth * ltw;      // local view b, g, r, grad per band entry
  int* bY = (int*)(lv + 4 * nb);        // full-resolution row of a band entry
  int* bX = bY + nb;                    // and its column

  const int tid = threadIdx.x;
  const int v = blockIdx.z;
  const bool is_left = v < B;
  const int ov = is_left ? v + B : v - B;
  const size_t hw = (size_t)h * w, HW = (size_t)H * W;
  const float* img = views + (size_t)v * HW * 3;
  const float* grd = grds + (size_t)v * HW;
  const float* oimg = views + (size_t)ov * HW * 3;
  const float* ogrd = grds + (size_t)ov * HW;
  const float* st = stats + (size_t)v * 12 * hw;

  // the tile's output pixels and the low-res window their taps span
  const int X0 = blockIdx.x * OT, Y0 = blockIdx.y * OT;
  const int ylo = ly0[Y0], yhi = min(ly0[min(Y0 + OT, H) - 1] + 1, h - 1);
  const int xlo = lx0[X0], xhi = min(lx0[min(X0 + OT, W) - 1] + 1, w - 1);
  const int oh = yhi - ylo + 1, ow = xhi - xlo + 1;

  for (int i = tid; i < nb; i += NTHREADS) {
    int iy, ix;
    fgf::band_index(i, ltw, k, ylo, xlo, h, w, &iy, &ix);
    const int Y = yi[iy], X = xi[ix];
    const size_t o = (size_t)Y * W + X;
    lv[i] = img[o * 3];
    lv[nb + i] = img[o * 3 + 1];
    lv[2 * nb + i] = img[o * 3 + 2];
    lv[3 * nb + i] = grd[o];
    bY[i] = Y;
    bX[i] = X;
  }
  if (tid < OT) {
    const int y = min(Y0 + tid, H - 1);
    const int y0 = ly0[y];
    s_r0[tid] = (y0 - ylo) * ltw;
    s_r1[tid] = (min(y0 + 1, h - 1) - ylo) * ltw;
    s_fy[tid] = lyf[y];
  }

  // this thread's column and its PPT rows
  const int tx = tid % OT, ty0 = tid / OT;
  const int x = X0 + tx;
  const bool x_in = x < W;
  const int xc = min(x, W - 1);
  const int c0 = lx0[xc] - xlo, c1 = min(lx0[xc] + 1, w - 1) - xlo;
  const float fx = lxf[xc], gx = 1.0f - fx;
  float g0[PPT], g1[PPT], g2[PPT], best[PPT];
  int arg[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int y = min(Y0 + ty0 + ROWS_PER_PASS * j, H - 1);
    const size_t pix = ((size_t)v * H + y) * W + xc;
    g0[j] = views[pix * 3];
    g1[j] = views[pix * 3 + 1];
    g2[j] = views[pix * 3 + 2];
    best[j] = 0.0f;
    arg[j] = 1;
  }
  __syncthreads();

  const StoreTile store{fin, lth * ltw, ltw};
  for (int d = 1; d < D; ++d) {
    for (int i = tid; i < nb; i += NTHREADS) {
      const float a[4] = {lv[i], lv[nb + i], lv[2 * nb + i], lv[3 * nb + i]};
      const size_t row = (size_t)bY[i] * W;
      const float p = fgf::sampled_cost(a, oimg + row * 3, ogrd + row, bX[i], d,
                                        is_left, W, cp);
      fgf::band_store(smem, lth, ltw, k, i, p, a[0], a[1], a[2]);
    }
    fgf::chain<NTHREADS, K>(smem, st, h, w, k, inv_k2, lth, ltw, ylo, xlo, oh, ow,
                            tid, store);
    __syncthreads();   // the map tiles are whole; the band may be refilled

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int ty = ty0 + ROWS_PER_PASS * j;
      const int r0 = s_r0[ty], r1 = s_r1[ty];
      const float fy = s_fy[ty], gy = 1.0f - fy;
      const int o00 = r0 + c0, o01 = r0 + c1, o10 = r1 + c0, o11 = r1 + c1;
      const float u0 = up(fin, o00, o01, o10, o11, gy, fy, gx, fx);
      const float u1 = up(fin + store.plane, o00, o01, o10, o11, gy, fy, gx, fx);
      const float u2 = up(fin + 2 * store.plane, o00, o01, o10, o11, gy, fy, gx, fx);
      const float u3 = up(fin + 3 * store.plane, o00, o01, o10, o11, gy, fy, gx, fx);
      const float q = u0 * g0[j] + u1 * g1[j] + u2 * g2[j] + u3;
      if (d == 1 || q < best[j]) {
        best[j] = q;
        arg[j] = d;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int y = Y0 + ty0 + ROWS_PER_PASS * j;
    if (x_in && y < H) out[((size_t)v * H + y) * W + x] = (uint8_t)arg[j];
  }
}

template <int K>
int launch(const float* views, const float* grds, const float* stats, const int* yi,
           const int* xi, const int* ly0, const float* lyf, const int* lx0,
           const float* lxf, uint8_t* out, int B, int D, int H, int W, int h, int w,
           int k, float inv_k2, int lth, int ltw, fgf::CostParams cp, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cvc_wta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + OT - 1) / OT, (H + OT - 1) / OT, 2 * B);
  cvc_wta_kernel<K><<<grid, NTHREADS, smem, stream>>>(
      views, grds, stats, yi, xi, ly0, lyf, lx0, lxf, out, B, D, H, W, h, w, k,
      inv_k2, lth, ltw, cp);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns -1, launching nothing, when a tile needs more dynamic shared
// memory than the card allows a block (227 KB on Hopper). The chain's box
// size is a template argument for k = 3, 5, 9 and 17.
extern "C" int psm_cvc_wta(const float* views, const float* grds,
                           const float* stats, const int* yi, const int* xi,
                           const int* ly0, const float* lyf, const int* lx0,
                           const float* lxf, uint8_t* out, int B, int D, int H,
                           int W, int h, int w, int k, float inv_k2, int lth,
                           int ltw, float alpha, float one_minus_alpha,
                           float border, float tau1, float tau2, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(lth, ltw, k);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + sizeof(int) * 3 * OT > (size_t)limit) return -1;
  const fgf::CostParams cp{alpha, one_minus_alpha, border, tau1, tau2};
  cudaStream_t s = (cudaStream_t)stream;
#define PSM_CVC_WTA_LAUNCH(K)                                                      \
  return launch<K>(views, grds, stats, yi, xi, ly0, lyf, lx0, lxf, out, B, D, H, W, \
                   h, w, k, inv_k2, lth, ltw, cp, smem, s)
  switch (k) {
    case 3: PSM_CVC_WTA_LAUNCH(3);
    case 5: PSM_CVC_WTA_LAUNCH(5);
    case 9: PSM_CVC_WTA_LAUNCH(9);
    case 17: PSM_CVC_WTA_LAUNCH(17);
    default: PSM_CVC_WTA_LAUNCH(0);
  }
#undef PSM_CVC_WTA_LAUNCH
}
