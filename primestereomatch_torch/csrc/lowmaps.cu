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
// Numerics follow ops/guided_filter.py step for step: every box sums its k
// taps in order, rows first and then columns, and scales by 1/(k*k); the
// solve keeps the plain version's term order. Built with -fmad=false, the
// maps agree with the plain version bit for bit. The first-level maps at
// the tile's halo positions are those of the reflected in-image pixel, so
// the second box sees exactly the reflect-101 padding the plain version
// applies to the maps.
//
// Layout: p (B, D, h, w) f32, stats (B, 12, h, w) f32 = [ch 0..2, box
// means 0..2, inverse covariance rr rg rb gg gb bb], out (B, 4, D, h, w).
// Grid (ceil(w/TW), ceil(h/TH), B*D), one block per output tile and slice.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;
constexpr int TW = 32;
constexpr int NTHREADS = 256;

__device__ __forceinline__ int refl(int i, int n) {
  // reflect-101 for indices within one period of the axis
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(NTHREADS)
lowmaps_kernel(const float* __restrict__ p, const float* __restrict__ stats,
               float* __restrict__ out, int D, int h, int w, int k,
               float inv_k2) {
  extern __shared__ float smem[];
  const int m1 = k / 2;
  const int M = 2 * m1;
  const int bh = TH + 2 * M, bw = TW + 2 * M;  // input band
  const int mh = TH + 2 * m1, mw = TW + 2 * m1;  // first-level maps
  float* band = smem;                 // 4 planes bh x bw: p, ch0*p, ch1*p, ch2*p
  float* rs = band + 4 * bh * bw;     // 4 planes mh x bw: row sums
  float* mid = rs + 4 * mh * bw;      // 4 planes mh x mw: a_r a_g a_b b
  float* rs2 = band;                  // 4 planes TH x mw: second row sums (reuses band)

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int bd = blockIdx.z;          // b * D + d
  const int b = bd / D;
  const size_t hw = (size_t)h * w;
  const float* ps = p + (size_t)bd * hw;
  const float* st = stats + (size_t)b * 12 * hw;
  const int tid = threadIdx.x;
  // rows/cols of the tile that hold outputs, and the halos they need
  const int oh = min(TH, h - y0), ow = min(TW, w - x0);
  const int nmh = oh + 2 * m1, nmw = ow + 2 * m1;
  const int by0 = y0 - M, bx0 = x0 - M;

  // 1. band of p and ch_c * p; the entries addressed below are in-image
  for (int i = tid; i < bh * bw; i += NTHREADS) {
    const int iy = clampi(refl(by0 + i / bw, h), h);
    const int ix = clampi(refl(bx0 + i % bw, w), w);
    const size_t o = (size_t)iy * w + ix;
    const float v = ps[o];
    band[i] = v;
    band[bh * bw + i] = st[o] * v;
    band[2 * bh * bw + i] = st[hw + o] * v;
    band[3 * bh * bw + i] = st[2 * hw + o] * v;
  }
  __syncthreads();

  // 2. row sums for first-level map rows cy = refl(y0 - m1 + r)
  for (int i = tid; i < nmh * bw; i += NTHREADS) {
    const int r = i / bw, jx = i % bw;
    const int cy = refl(y0 - m1 + r, h);
    for (int c = 0; c < 4; ++c) {
      const float* pl = band + c * bh * bw + jx;
      float s = pl[(refl(cy - m1, h) - by0) * bw];
      for (int t = 1; t < k; ++t) s = s + pl[(refl(cy - m1 + t, h) - by0) * bw];
      rs[c * mh * bw + r * bw + jx] = s;
    }
  }
  __syncthreads();

  // 3. first-level maps at (refl(y0 - m1 + r), refl(x0 - m1 + q))
  for (int i = tid; i < nmh * nmw; i += NTHREADS) {
    const int r = i / nmw, q = i % nmw;
    const int cy = refl(y0 - m1 + r, h), cx = refl(x0 - m1 + q, w);
    float box[4];
    for (int c = 0; c < 4; ++c) {
      const float* row = rs + c * mh * bw + r * bw;
      float s = row[refl(cx - m1, w) - bx0];
      for (int t = 1; t < k; ++t) s = s + row[refl(cx - m1 + t, w) - bx0];
      box[c] = s * inv_k2;
    }
    const size_t o = (size_t)cy * w + cx;
    const float mr = st[3 * hw + o], mg = st[4 * hw + o], mb = st[5 * hw + o];
    const float irr = st[6 * hw + o], irg = st[7 * hw + o], irb = st[8 * hw + o];
    const float igg = st[9 * hw + o], igb = st[10 * hw + o], ibb = st[11 * hw + o];
    const float mp = box[0];
    const float cov0 = box[1] - mr * mp;
    const float cov1 = box[2] - mg * mp;
    const float cov2 = box[3] - mb * mp;
    const float a_r = irr * cov0 + irg * cov1 + irb * cov2;
    const float a_g = irg * cov0 + igg * cov1 + igb * cov2;
    const float a_b = irb * cov0 + igb * cov1 + ibb * cov2;
    const float bb = mp - a_r * mr - a_g * mg - a_b * mb;
    const int m = r * mw + q;
    mid[m] = a_r;
    mid[mh * mw + m] = a_g;
    mid[2 * mh * mw + m] = a_b;
    mid[3 * mh * mw + m] = bb;
  }
  __syncthreads();

  // 4. second box, valid over the first-level tile: rows then columns
  for (int i = tid; i < oh * nmw; i += NTHREADS) {
    const int ty = i / nmw, q = i % nmw;
    for (int c = 0; c < 4; ++c) {
      const float* col = mid + c * mh * mw + ty * mw + q;
      float s = col[0];
      for (int t = 1; t < k; ++t) s = s + col[t * mw];
      rs2[c * TH * mw + ty * mw + q] = s;
    }
  }
  __syncthreads();

  for (int i = tid; i < oh * ow; i += NTHREADS) {
    const int ty = i / ow, tx = i % ow;
    const size_t o = (size_t)(y0 + ty) * w + (x0 + tx);
    for (int c = 0; c < 4; ++c) {
      const float* row = rs2 + c * TH * mw + ty * mw + tx;
      float s = row[0];
      for (int t = 1; t < k; ++t) s = s + row[t];
      // out[b][c][d] plane
      out[((size_t)(b * 4 + c) * D + (bd - b * D)) * hw + o] = s * inv_k2;
    }
  }
}

}  // namespace

extern "C" int psm_lowmaps(const float* p, const float* stats, float* out,
                           int B, int D, int h, int w, int k, float inv_k2,
                           void* stream) {
  const int M = 2 * (k / 2);
  const int bh = TH + 2 * M, bw = TW + 2 * M;
  const int mh = TH + M, mw = TW + M;
  const size_t smem = sizeof(float) * 4 * ((size_t)bh * bw + (size_t)mh * bw + (size_t)mh * mw);
  cudaError_t err = cudaFuncSetAttribute(
      lowmaps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B * D);
  lowmaps_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      p, stats, out, D, h, w, k, inv_k2);
  return (int)cudaGetLastError();
}
