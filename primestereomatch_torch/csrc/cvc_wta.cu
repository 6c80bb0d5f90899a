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
// Design: K4's block (cvc_lowmaps.cu) feeding K2's staged WTA (wta.cu)
// through shared memory. A block of NT = 512 threads owns an output tile of
// `oty` x OTX = 128 pixels (oty = 64, 32 or 16, picked per geometry by
// kernels/cvc_wta.py::plan_tile) and the low-res window its bilinear taps
// span (18 x 34 at the 4x ratio of 2K with oty = 64). It stages the band of
// that window once: the local view's (b, g, r, gradient) as one float4 and
// the sample's full-resolution (row, column) packed in one word. Then, a
// step of `groups` (1 or 2) disparities at a time:
//   * each group of NT / groups warps fills its own cost band for its own
//     disparity from the staged samples and the other view's row (loads of
//     four entries issued together, clamped in-bounds and replaced by the
//     border cost where they fall outside) and runs the chain
//     (fgf_chain.cuh::chain) on it into its own four map planes, with a
//     barrier of its own: the two chains overlap, so one group's barrier
//     waits are the other's issue slots;
//   * K2's row lerp, one float4 (a_r, a_g, a_b, b) per (disparity, output
//     row, window column): a thread loads the two map rows of a window
//     column once and writes every output row that taps them;
//   * per pixel, in order of d, the column lerp (two 128-bit loads) and
//     the guide combine, folded into a strict `<` running (min, argmin);
//     a thread folds all of its MAX_PPT pixel slots (those past a short
//     tile fold stale rows and are never stored), so the loop has no exit
//     and its loads issue together.
// A thread keeps oty / 4 pixels of one column (4 rows apart, a warp on 32
// neighbouring columns): its guide and best value in registers, its
// arguments four to a word as uint8. The larger window cuts the chain's
// halo recompute (the band is 2.1x the window's own low-res pixels at 2K,
// 2.6x with the 64 x 64 tiles before); the row lerp removes the per-pixel
// row lerps of all four maps.
//
// d = 0 is never a candidate, so the TPU kernel's d = 0 poison has no
// counterpart, and the OpenCV INTER_LINEAR tables are clamped at every
// column, so neither has its left-edge fix-up pass.
//
// Numerics: cost and chain as K4, lerp and combine in K2's order (rows,
// then columns, then q = a_r*I0 + a_g*I1 + a_b*I2 + b); built with
// -fmad=false the result equals K4 followed by K2 bit for bit.
//
// Layout: views, grds, stats, yi, xi as cvc_lowmaps.cu (the B left views
// first, then the B right ones); ly0/lyf (H,) and lx0/lxf (W,) the
// upsampling tables (low index int32, fraction f32); out (2B, H, W) uint8.
// (lth, ltw) is the largest low-res window any tile needs. Grid
// (ceil(W/OTX), ceil(H/oty), 2B). H and W are below 2**16 (a sample's row
// and column share one word).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fgf_chain.cuh"

// threads a block, output columns a tile and blocks an SM the registers
// are bounded for (timing variants; kernels/cvc_wta.py mirrors the
// defaults)
#ifndef PSM_K10_NT
#define PSM_K10_NT 512
#endif
#ifndef PSM_K10_OTX
#define PSM_K10_OTX 128
#endif
#ifndef PSM_K10_MINB
#define PSM_K10_MINB 1
#endif

namespace {

constexpr int NT = PSM_K10_NT;
constexpr int OTX = PSM_K10_OTX;
constexpr int ROWS_PER_PASS = NT / OTX;   // a thread's pixels lie this many rows apart
constexpr int MAX_PPT = 16;               // pixels a thread at most
constexpr int MAX_OTY = MAX_PPT * ROWS_PER_PASS;
constexpr int BAND_BATCH = 4;             // band entries a thread loads at once
static_assert(NT % OTX == 0 && ROWS_PER_PASS >= 1 && NT % 64 == 0, "bad tile shape");

// The barrier of group g of G: the whole block where there is one group,
// else a named barrier of the group's NT / G threads.
template <int G>
struct GroupSync {
  int g;
  __device__ __forceinline__ void operator()() const {
    if (G == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(NT / G) : "memory");
  }
};

struct StoreTile {
  float* fin;   // 4 planes lth x ltw
  int plane, ltw;
  __device__ void operator()(int c, int ty, int tx, float v) const {
    fin[c * plane + ty * ltw + tx] = v;
  }
};

// Floats of dynamic shared memory: per group the chain's, its four
// finished map planes and the row-lerped float4 of MAX_OTY output rows
// (every row a thread's pixels can reach, so that the pixel loop needs no
// bound); the staged samples (one float4 a band entry) and their packed
// positions.
inline size_t smem_floats(int lth, int ltw, int k, int groups) {
  const int M = 2 * (k / 2);
  const size_t nb = (size_t)(lth + 2 * M) * (ltw + 2 * M);
  return groups * (fgf::chain_floats(lth, ltw, k) + 4 * (size_t)lth * ltw +
                   4 * (size_t)MAX_OTY * ltw) + 5 * nb;
}

template <int K, int G>
__global__ void __launch_bounds__(NT, PSM_K10_MINB)
cvc_wta_kernel(const float* __restrict__ views, const float* __restrict__ grds,
               const float* __restrict__ stats, const int* __restrict__ yi,
               const int* __restrict__ xi, const int* __restrict__ ly0,
               const float* __restrict__ lyf, const int* __restrict__ lx0,
               const float* __restrict__ lxf, uint8_t* __restrict__ out, int B,
               int D, int H, int W, int h, int w, int k, float inv_k2, int lth,
               int ltw, int oty, fgf::CostParams cp) {
  constexpr int GT = NT / G;          // threads of a group
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_r0[MAX_OTY], s_r1[MAX_OTY];   // tap rows of each output row, x ltw
  __shared__ float s_fy[MAX_OTY];
  __shared__ int s_head[MAX_OTY + 1];            // first output row of each tap-row pair
  __shared__ int s_nh;

  const int kk = K > 0 ? K : k;
  const int M = 2 * (kk / 2);
  const int nb = (lth + 2 * M) * (ltw + 2 * M);
  const int plane = lth * ltw;
  const int chain_fl = (int)fgf::chain_floats(lth, ltw, kk);
  const int area = chain_fl + 4 * plane;          // a group's chain and map planes
  float4* rl = reinterpret_cast<float4*>(smem + G * area);        // [G][MAX_OTY][ltw]
  float4* lv = rl + G * MAX_OTY * ltw;                            // [nb]
  unsigned* pos = reinterpret_cast<unsigned*>(lv + nb);           // row << 16 | column

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
  const int X0 = blockIdx.x * OTX, Y0 = blockIdx.y * oty;
  const int ohr = min(oty, H - Y0);     // output rows of this tile
  const int ylo = ly0[Y0], yhi = min(ly0[Y0 + ohr - 1] + 1, h - 1);
  const int xlo = lx0[X0], xhi = min(lx0[min(X0 + OTX, W) - 1] + 1, w - 1);
  const int oh = yhi - ylo + 1, ow = xhi - xlo + 1;

  for (int i = tid; i < nb; i += NT) {
    int iy, ix;
    fgf::band_index(i, ltw, kk, ylo, xlo, h, w, &iy, &ix);
    const int Y = yi[iy], X = xi[ix];
    const size_t o = (size_t)Y * W + X;
    lv[i] = make_float4(img[o * 3], img[o * 3 + 1], img[o * 3 + 2], grd[o]);
    pos[i] = (unsigned)Y << 16 | (unsigned)X;
  }
  if (tid < ohr) {
    const int y = Y0 + tid;
    const int y0 = ly0[y];
    s_r0[tid] = (y0 - ylo) * ltw;
    s_r1[tid] = (min(y0 + 1, h - 1) - ylo) * ltw;
    s_fy[tid] = lyf[y];
  }
  if (tid == 0) {
    // output rows with the same tap rows are consecutive (ly0 is monotone)
    int nh = 0;
    for (int r = 0; r < ohr; ++r)
      if (r == 0 || ly0[Y0 + r] != ly0[Y0 + r - 1]) s_head[nh++] = r;
    s_head[nh] = ohr;
    s_nh = nh;
  }

  // this thread's column and its pixels, ROWS_PER_PASS rows apart
  const int tx = tid % OTX, ty0 = tid / OTX;
  const int x = X0 + tx;
  const int xc = min(x, W - 1);
  const int c0 = lx0[xc] - xlo, c1 = min(lx0[xc] + 1, w - 1) - xlo;
  const float fx = lxf[xc], gx = 1.0f - fx;
  float g0[MAX_PPT], g1[MAX_PPT], g2[MAX_PPT], best[MAX_PPT];
  unsigned arg[MAX_PPT / 4];            // four uint8 arguments a word
#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    const int y = min(Y0 + ty0 + ROWS_PER_PASS * j, H - 1);
    const size_t pix = ((size_t)v * H + y) * W + xc;
    g0[j] = views[pix * 3];
    g1[j] = views[pix * 3 + 1];
    g2[j] = views[pix * 3 + 2];
    best[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < MAX_PPT / 4; ++j) arg[j] = 0x01010101u;
  __syncthreads();

  // group g runs the chain of disparity d0 + g in its own area
  const int g = tid / GT, gtid = tid - g * GT;
  float* cs = smem + g * area;
  const StoreTile store{cs + chain_fl, plane, ltw};
  const int nh = s_nh;
  const FastDiv by_ow(ow), by_heads(nh * ow);
  for (int d0 = 1; d0 < D; d0 += G) {
    const int nd = min(G, D - d0);      // disparities of this step
    if (g < nd) {
      const int d = d0 + g;
      for (int i0 = gtid; i0 < nb; i0 += BAND_BATCH * GT) {
        float4 l[BAND_BATCH];
        float b[BAND_BATCH][4];
        bool valid[BAND_BATCH];
#pragma unroll
        for (int u = 0; u < BAND_BATCH; ++u) {
          const int i = min(i0 + u * GT, nb - 1);
          l[u] = lv[i];
          const int Y = pos[i] >> 16, X = pos[i] & 0xffff;
          valid[u] = is_left ? (X >= d) : (X < W - d);
          const int Xo = min(max(is_left ? X - d : X + d, 0), W - 1);
          const size_t o = (size_t)Y * W + Xo;
          b[u][0] = oimg[3 * o];
          b[u][1] = oimg[3 * o + 1];
          b[u][2] = oimg[3 * o + 2];
          b[u][3] = ogrd[o];
        }
#pragma unroll
        for (int u = 0; u < BAND_BATCH; ++u) {
          const int i = i0 + u * GT;
          if (i >= nb) break;
          const float a[4] = {l[u].x, l[u].y, l[u].z, l[u].w};
          const float p = valid[u] ? fgf::pair_cost(a, b[u][0], b[u][1], b[u][2], b[u][3], cp)
                                   : fgf::pair_cost(a, cp.border, cp.border, cp.border,
                                                    cp.border, cp);
          fgf::band_store(cs, lth, ltw, kk, i, p, a[0], a[1], a[2]);
        }
      }
      fgf::chain<GT, K>(cs, st, h, w, kk, inv_k2, lth, ltw, ylo, xlo, oh, ow, gtid, store,
                        GroupSync<G>{g});
    }
    __syncthreads();   // the map planes are whole; the bands may be refilled

    // row lerp of the four maps into one float4 per (disparity, output row,
    // window column): a thread takes a window column and a pair of tap rows
    for (int e = tid; e < nd * nh * ow; e += NT) {
      const int q = by_heads.div(e), e1 = e - q * nh * ow;   // q: the disparity of the step
      const int hd = by_ow.div(e1), col = e1 - hd * ow;
      const int rb = s_head[hd], re = s_head[hd + 1];
      const float* fin = smem + q * area + chain_fl;
      const int o0 = s_r0[rb] + col, o1 = s_r1[rb] + col;
      const float t00 = fin[o0], t01 = fin[o1];
      const float t10 = fin[plane + o0], t11 = fin[plane + o1];
      const float t20 = fin[2 * plane + o0], t21 = fin[2 * plane + o1];
      const float t30 = fin[3 * plane + o0], t31 = fin[3 * plane + o1];
      for (int r = rb; r < re; ++r) {
        const float fy = s_fy[r], gy = 1.0f - fy;
        rl[(q * MAX_OTY + r) * ltw + col] =
            make_float4(t00 * gy + t01 * fy, t10 * gy + t11 * fy, t20 * gy + t21 * fy,
                        t30 * gy + t31 * fy);
      }
    }
    __syncthreads();   // the row lerps are whole

    for (int q = 0; q < nd; ++q) {
      const int d = d0 + q;
      const float4* rq = rl + (q * MAX_OTY + ty0) * ltw;
#pragma unroll
      for (int j = 0; j < MAX_PPT; ++j) {
        // rows past the tile fold stale values that are never stored
        const float4* rr = rq + ROWS_PER_PASS * j * ltw;
        const float4 lo = rr[c0], hi = rr[c1];
        const float u0 = lo.x * gx + hi.x * fx;
        const float u1 = lo.y * gx + hi.y * fx;
        const float u2 = lo.z * gx + hi.z * fx;
        const float u3 = lo.w * gx + hi.w * fx;
        const float s = u0 * g0[j] + u1 * g1[j] + u2 * g2[j] + u3;
        if (d == 1 || s < best[j]) {
          best[j] = s;
          const int sh = 8 * (j & 3);
          arg[j >> 2] = (arg[j >> 2] & ~(0xffu << sh)) | ((unsigned)d << sh);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    const int y = Y0 + ty0 + ROWS_PER_PASS * j;
    if (ty0 + ROWS_PER_PASS * j < ohr && x < W)
      out[((size_t)v * H + y) * W + x] = (uint8_t)(arg[j >> 2] >> (8 * (j & 3)));
  }
}

template <int K, int G>
int launch(const float* views, const float* grds, const float* stats, const int* yi,
           const int* xi, const int* ly0, const float* lyf, const int* lx0,
           const float* lxf, uint8_t* out, int B, int D, int H, int W, int h, int w,
           int k, float inv_k2, int lth, int ltw, int oty, fgf::CostParams cp, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cvc_wta_kernel<K, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + OTX - 1) / OTX, (H + oty - 1) / oty, 2 * B);
  cvc_wta_kernel<K, G><<<grid, NT, smem, stream>>>(
      views, grds, stats, yi, xi, ly0, lyf, lx0, lxf, out, B, D, H, W, h, w, k,
      inv_k2, lth, ltw, oty, cp);
  return (int)cudaGetLastError();
}

}  // namespace

// `oty` output rows a tile (a multiple of NT / OTX up to MAX_OTY: 4 and 64
// as built by default), `groups` (1 or 2) chains at once; returns -1,
// launching nothing, for another oty or groups or when a tile needs more
// dynamic shared memory than the card allows a block (227 KB on Hopper).
// The chain's box size is a template argument for k = 3, 5, 9 and 17.
extern "C" int psm_cvc_wta(const float* views, const float* grds,
                           const float* stats, const int* yi, const int* xi,
                           const int* ly0, const float* lyf, const int* lx0,
                           const float* lxf, uint8_t* out, int B, int D, int H,
                           int W, int h, int w, int k, float inv_k2, int lth,
                           int ltw, int oty, int groups, float alpha,
                           float one_minus_alpha, float border, float tau1, float tau2,
                           void* stream) {
  if (oty < ROWS_PER_PASS || oty > MAX_OTY || oty % ROWS_PER_PASS) return -1;
  if (groups != 1 && groups != 2) return -1;
  const size_t smem = sizeof(float) * smem_floats(lth, ltw, k, groups);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + sizeof(int) * (4 * MAX_OTY + 2) > (size_t)limit) return -1;
  const fgf::CostParams cp{alpha, one_minus_alpha, border, tau1, tau2};
  cudaStream_t s = (cudaStream_t)stream;
#define PSM_CVC_WTA_LAUNCH(K)                                                          \
  return groups == 2                                                                    \
             ? launch<K, 2>(views, grds, stats, yi, xi, ly0, lyf, lx0, lxf, out, B, D, \
                            H, W, h, w, k, inv_k2, lth, ltw, oty, cp, smem, s)         \
             : launch<K, 1>(views, grds, stats, yi, xi, ly0, lyf, lx0, lxf, out, B, D, \
                            H, W, h, w, k, inv_k2, lth, ltw, oty, cp, smem, s)
  switch (k) {
    case 3: PSM_CVC_WTA_LAUNCH(3);
    case 5: PSM_CVC_WTA_LAUNCH(5);
    case 9: PSM_CVC_WTA_LAUNCH(9);
    case 17: PSM_CVC_WTA_LAUNCH(17);
    default: PSM_CVC_WTA_LAUNCH(0);
  }
#undef PSM_CVC_WTA_LAUNCH
}
