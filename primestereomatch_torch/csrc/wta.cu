// K2: bilinear upsample of the FGF maps, guide combine, and first-minimum
// argmin over disparities d >= 1, to uint8.
//
// Replaces primestereomatch_tpu/kernels/wta_pallas.py::_wta_kernel_poly
// (launcher _wta_poly_run) and ::_wta_kernel, the generic-ratio kernel the
// TPU falls to where its polyphase layout does not apply. The TPU kernels'
// banded matmuls and polyphase column lerp are layout choices for its
// matrix unit; here the OpenCV INTER_LINEAR tables (row/column source index
// and fraction, computed on the host in float64) serve every ratio.
//
// What bounds it: the function needs each map row-lerped once per (output
// row, low-res column) and column-lerped per output pixel, ~22 flops per
// pixel and disparity at a 4x ratio, and one read of the maps
// (4 x D x h x w f32); the two take about equal time on the H100.
//
// Two kernels, chosen by the wrapper (kernels/wta.py::staged_window) from the
// tables:
//
//   * upsample_wta_staged_kernel, wherever a tile's low-res window is small
//     (ratios above 2: Teddy's quasi 112 -> 450, the exact 552 -> 2208):
//     the separable lerp, staged. A block owns TX x TY output pixels and
//     the low-res window their taps span (18 x 6 at the 4x ratio). Per
//     chunk of DC disparities it copies the window's four maps into shared
//     memory once (cp.async), row-lerps them into r[d][output row][low-res
//     column], one float4 (a_r, a_g, a_b, b) per entry, and then every
//     thread column-lerps and combines its pixels from r (two 128-bit
//     loads a pixel and disparity) and folds the running (min, argmin) in
//     registers. Each row lerp is computed once for every pixel that taps
//     it, and the device memory is read once per block. A thread takes
//     TY / 4 pixels of one column, 4 rows apart, so a warp reads 32
//     neighbouring pixels' taps: 9 neighbouring float4.
//   * upsample_wta_kernel, for the other ratios (1 at subsample=1, where a
//     window is as large as its tile): one thread per output pixel lerps
//     its 2x2 taps straight from L1, both row lerps at every pixel.
//
// The -D knobs below are for tune_gif_tail.py, which times the shapes that
// were tried: PX > 1 gives a thread PX neighbouring pixels of a row, whose
// taps lie in NC = 3 columns loaded once and picked per pixel by selects
// (fewer loads, more instructions: slower on the H100), and STAGES = 2
// keeps the next chunk's copies in flight (no faster with 3 blocks an SM).
//
// No atomics, no shared state across blocks: the result does not depend
// on the schedule.
//
// Numerics follow ops/guided_filter.py::fgf_wta_low_maps: each map is
// lerped rows first (t[y0]*(1-fy) + t[y1]*fy at both tap columns), then
// columns, and q = a_r*I0 + a_g*I1 + a_b*I2 + b in that order; built with
// -fmad=false, q is bitwise the plain version's in both kernels (a staged
// row lerp is the same two products and one sum), and the strict `<`
// keeps the first minimum.
//
// Layout: maps (B, 4, D, h, w) f32, guide (B, H, W, 3) f32, yi/yf (H,),
// xi/xf (W,) int32/f32, out (B, H, W) uint8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastdiv.cuh"

// The staged kernel's shape; kernels/wta.py mirrors the defaults.
#ifndef PSM_WTA_TX
#define PSM_WTA_TX 64       // output tile width
#endif
#ifndef PSM_WTA_TY
#define PSM_WTA_TY 16       // output tile height
#endif
#ifndef PSM_WTA_DC
#define PSM_WTA_DC 8        // disparities per staged chunk
#endif
#ifndef PSM_WTA_PX
#define PSM_WTA_PX 1        // neighbouring pixels of a row per thread
#endif
#ifndef PSM_WTA_NC
#define PSM_WTA_NC 2        // low-res columns those pixels' taps span
#endif
#ifndef PSM_WTA_STAGES
#define PSM_WTA_STAGES 1    // buffers of the raw window; 2 copies ahead
#endif
#ifndef PSM_WTA_MINB
#define PSM_WTA_MINB 3      // blocks an SM should hold (bounds the registers)
#endif

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

// ---- the staged kernel ---------------------------------------------------

constexpr int TX = PSM_WTA_TX, TY = PSM_WTA_TY, DC = PSM_WTA_DC;
constexpr int PX = PSM_WTA_PX, NC = PSM_WTA_NC, STAGES = PSM_WTA_STAGES;
constexpr int NT = 256;
constexpr int TCOLS = TX / PX;          // threads along x
constexpr int TROWS = NT / TCOLS;       // and along y
constexpr int RY = TY / TROWS;          // rows per thread, TROWS apart
constexpr int MAXW = 2;                 // window entries a thread copies per plane
static_assert(TX % PX == 0 && NT % TCOLS == 0 && TY % TROWS == 0 && RY >= 1,
              "the tile must divide among the threads");
static_assert((NC == 2 || NC == 3) && (STAGES == 1 || STAGES == 2), "bad staging shape");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Bytes of dynamic shared memory for windows of up to lth x ltw low-res
// pixels: STAGES raw windows of 4 maps x DC disparities, and r.
inline size_t staged_smem(int lth, int ltw) {
  return sizeof(float) * (size_t)STAGES * 4 * DC * lth * ltw +
         sizeof(float4) * (size_t)DC * TY * ltw;
}

// Copies of one window entry (offset `goff` in a map plane, `soff` in a
// staged plane) for the 4 maps and the n disparities from d0.
__device__ __forceinline__ void fetch_entry(float* dst, const float* __restrict__ m0,
                                            size_t plane, int D, int d0, int n, int win,
                                            int goff, int soff) {
  for (int m = 0; m < 4; ++m)
    for (int dd = 0; dd < n; ++dd)
      cp_async4(dst + (m * DC + dd) * win + soff,
                m0 + ((size_t)m * D + d0 + dd) * plane + goff);
}

__global__ void __launch_bounds__(NT, PSM_WTA_MINB)
upsample_wta_staged_kernel(const float* __restrict__ maps,
                           const float* __restrict__ guide,
                           const int* __restrict__ yi, const float* __restrict__ yf,
                           const int* __restrict__ xi, const float* __restrict__ xf,
                           uint8_t* __restrict__ out, int D, int h, int w, int H,
                           int W, int lth, int ltw) {
  extern __shared__ float4 smem4[];
  __shared__ int s_r0[TY], s_r1[TY];    // tap rows of each output row, x ltw
  __shared__ float s_fy[TY];

  const int win = lth * ltw;
  float4* r = smem4;                               // [DC][TY][ltw]
  float* raw = (float*)(smem4 + DC * TY * ltw);    // [STAGES][4][DC][lth][ltw]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int X0 = blockIdx.x * TX, Y0 = blockIdx.y * TY;
  const int oh_t = min(TY, H - Y0);     // output rows of this tile
  // the low-res window the tile's taps span
  const int ylo = yi[Y0], yhi = min(yi[Y0 + oh_t - 1] + 1, h - 1);
  const int xlo = xi[X0], xhi = min(xi[min(X0 + TX, W) - 1] + 1, w - 1);
  const int wh = yhi - ylo + 1, ow = xhi - xlo + 1;

  const size_t plane = (size_t)h * w;
  const float* m0 = maps + (size_t)b * 4 * D * plane;

  // this thread's entries of the window: offset in a map plane and in a
  // staged plane (-1: none)
  const FastDiv by_ow(ow);
  static_assert(MAXW == 2, "a thread keeps two window entries");
  const int ry0 = by_ow.div(tid), ry1 = by_ow.div(tid + NT);
  const int goff0 = (ylo + ry0) * w + xlo + tid - ry0 * ow;
  const int goff1 = (ylo + ry1) * w + xlo + tid + NT - ry1 * ow;
  const int soff0 = tid < wh * ow ? ry0 * ltw + tid - ry0 * ow : -1;
  const int soff1 = tid + NT < wh * ow ? ry1 * ltw + tid + NT - ry1 * ow : -1;
  if (tid < TY) {
    const int y = min(Y0 + tid, H - 1);
    const int y0 = yi[y];
    s_r0[tid] = (y0 - ylo) * ltw;
    s_r1[tid] = (min(y0 + 1, h - 1) - ylo) * ltw;
    s_fy[tid] = yf[y];
  }

  // this thread's PX neighbouring pixels of RY rows
  const int tx = tid % TCOLS, ty = tid / TCOLS;
  const int xf0 = X0 + tx * PX;
  const int c0 = xi[min(xf0, W - 1)] - xlo;        // first low-res column it taps
  int cidx[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) cidx[i] = min(c0 + i, ow - 1);
  float fx[PX], gx[PX];
  unsigned sel = 0;   // a bit a pixel: its first column is the run's second (NC = 3)
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int xc = min(xf0 + j, W - 1);
    fx[j] = xf[xc];
    gx[j] = 1.0f - fx[j];
    sel |= (unsigned)(xi[xc] - xlo - c0) << j;
  }
  float g0[RY][PX], g1[RY][PX], g2[RY][PX], best[RY][PX];
  int arg[RY][PX];
#pragma unroll
  for (int jr = 0; jr < RY; ++jr) {
    const int y = min(Y0 + ty + TROWS * jr, H - 1);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const size_t pix = ((size_t)b * H + y) * W + min(xf0 + j, W - 1);
      g0[jr][j] = guide[pix * 3];
      g1[jr][j] = guide[pix * 3 + 1];
      g2[jr][j] = guide[pix * 3 + 2];
      best[jr][j] = 0.0f;
      arg[jr][j] = 1;
    }
  }

  // copy the window of chunk c (disparities 1 + c * DC ...) into a stage
  auto fetch = [=](int c) {
    const int d0 = 1 + c * DC;
    const int n = min(DC, D - d0);
    float* dst = raw + (STAGES == 2 ? (c & 1) : 0) * 4 * DC * win;
    if (soff0 >= 0) fetch_entry(dst, m0, plane, D, d0, n, win, goff0, soff0);
    if (soff1 >= 0) fetch_entry(dst, m0, plane, D, d0, n, win, goff1, soff1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int nchunks = (D - 1 + DC - 1) / DC;
  if (STAGES == 2) fetch(0);
  for (int c = 0; c < nchunks; ++c) {
    const int d0 = 1 + c * DC;
    const int n = min(DC, D - d0);
    if (STAGES == 2) {
      if (c + 1 < nchunks) {
        fetch(c + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
    } else {
      fetch(c);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();   // the chunk's window has arrived; r is free again

    // row lerp: r[dd][row][col] for the tile's rows and the window's columns
    const float* src = raw + (STAGES == 2 ? (c & 1) : 0) * 4 * DC * win;
    for (int e = tid; e < oh_t * ow; e += NT) {
      const int row = by_ow.div(e), col = e - row * ow;
      const int o0 = s_r0[row] + col, o1 = s_r1[row] + col;
      const float fy = s_fy[row], gy = 1.0f - fy;
      for (int dd = 0; dd < n; ++dd) {
        const float* t = src + dd * win;
        float4 v;
        v.x = t[o0] * gy + t[o1] * fy;
        v.y = t[DC * win + o0] * gy + t[DC * win + o1] * fy;
        v.z = t[2 * DC * win + o0] * gy + t[2 * DC * win + o1] * fy;
        v.w = t[3 * DC * win + o0] * gy + t[3 * DC * win + o1] * fy;
        r[(dd * TY + row) * ltw + col] = v;
      }
    }
    __syncthreads();   // r is whole; the stage may be refilled

    for (int dd = 0; dd < n; ++dd) {
      const int d = d0 + dd;
#pragma unroll
      for (int jr = 0; jr < RY; ++jr) {
        const float4* rr = r + (dd * TY + ty + TROWS * jr) * ltw;
        // the columns as separate values, not an array: a select between
        // array elements would be compiled to an indexed load from local memory
        const float4 ca = rr[cidx[0]], cb = rr[cidx[1]];
        const float4 cc = NC == 3 ? rr[cidx[NC - 1]] : cb;
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          float4 lo = ca, hi = cb;
          if (NC == 3) {
            const bool t = (sel >> j) & 1u;
            lo.x = t ? cb.x : ca.x;
            lo.y = t ? cb.y : ca.y;
            lo.z = t ? cb.z : ca.z;
            lo.w = t ? cb.w : ca.w;
            hi.x = t ? cc.x : cb.x;
            hi.y = t ? cc.y : cb.y;
            hi.z = t ? cc.z : cb.z;
            hi.w = t ? cc.w : cb.w;
          }
          const float u0 = lo.x * gx[j] + hi.x * fx[j];
          const float u1 = lo.y * gx[j] + hi.y * fx[j];
          const float u2 = lo.z * gx[j] + hi.z * fx[j];
          const float u3 = lo.w * gx[j] + hi.w * fx[j];
          const float q = u0 * g0[jr][j] + u1 * g1[jr][j] + u2 * g2[jr][j] + u3;
          if (d == 1 || q < best[jr][j]) {
            best[jr][j] = q;
            arg[jr][j] = d;
          }
        }
      }
    }
  }

#pragma unroll
  for (int jr = 0; jr < RY; ++jr) {
    const int y = Y0 + ty + TROWS * jr;
#pragma unroll
    for (int j = 0; j < PX; ++j)
      if (y < H && xf0 + j < W) out[((size_t)b * H + y) * W + xf0 + j] = (uint8_t)arg[jr][j];
  }
}

}  // namespace

// (lth, ltw) > 0: the staged kernel, for tiles whose taps span at most
// lth x ltw low-res pixels (and, for PX > 1, whose aligned runs of PX pixels
// tap at most NC columns: the caller's check); it returns -1, launching nothing, when
// such a window does not fit. (0, 0): the per-pixel kernel.
extern "C" int psm_upsample_wta(const float* maps, const float* guide,
                                const int* yi, const float* yf, const int* xi,
                                const float* xf, uint8_t* out, int B, int D,
                                int h, int w, int H, int W, int lth, int ltw,
                                void* stream) {
  if (lth <= 0 || ltw <= 0) {
    dim3 block(BX, BY);
    dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
    upsample_wta_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        maps, guide, yi, yf, xi, xf, out, D, h, w, H, W);
    return (int)cudaGetLastError();
  }
  const size_t smem = staged_smem(lth, ltw);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (lth * ltw > MAXW * NT || smem + sizeof(int) * 3 * TY > (size_t)limit) return -1;
  err = cudaFuncSetAttribute(upsample_wta_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  upsample_wta_staged_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      maps, guide, yi, yf, xi, xf, out, D, h, w, H, W, lth, ltw);
  return (int)cudaGetLastError();
}
