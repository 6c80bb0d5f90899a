// The low-resolution FastGuidedFilter coefficient chain of one tile, shared
// by lowmaps.cu (K1), cvc_lowmaps.cu (K4) and cvc_wta.cu (K10), and the
// sampled matching cost K4 and K10 build their bands from.
//
// A block owns an output tile of up to th x tw low-res pixels at (y0, x0)
// and a band of shared memory around it: M = 2 * (k / 2) more pixels on
// each side. The caller fills the band's four planes (p, ch0 * p, ch1 * p,
// ch2 * p) with `band_index` / `band_store`; `chain` then computes box(p)
// and box(ch_c * p), the covariance, (a_r, a_g, a_b, b) through the
// symmetric inverse, and a box average of each map again, and hands every
// finished value to `emit(c, ty, tx, value)`.
//
// Numerics follow ops/guided_filter.py step for step: every box sums its k
// taps in order, rows first and then columns, and scales by 1 / (k * k);
// the solve keeps the plain version's term order. Built with -fmad=false,
// the maps agree with the plain version bit for bit, whatever the tiling:
// each value is a fixed-order sum of values that depend on their position
// only. Band entries and first-level maps at halo positions are those of
// the reflected in-image pixel, so both boxes see exactly the reflect-101
// padding the plain version applies (to the cost, then to the maps).

#pragma once

#include <cuda_runtime.h>

namespace fgf {

__device__ __forceinline__ int refl(int i, int n) {
  // reflect-101 for indices within one period of the axis
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Floats of shared memory the chain needs for tiles of th x tw and k x k
// boxes: the band, the row sums and the first-level maps, 4 planes each.
__host__ __device__ inline size_t chain_floats(int th, int tw, int k) {
  const int M = 2 * (k / 2);
  const size_t bh = th + 2 * M, bw = tw + 2 * M, mh = th + M, mw = tw + M;
  return 4 * (bh * bw + mh * bw + mh * mw);
}

// Band entry i -> the in-image low-res pixel whose values it holds. The
// entries the chain addresses lie within one reflection of the image; the
// clamp only keeps the others' reads in bounds.
__device__ __forceinline__ void band_index(int i, int tw, int k, int y0, int x0,
                                           int h, int w, int* iy, int* ix) {
  const int M = 2 * (k / 2);
  const int bw = tw + 2 * M;
  *iy = clampi(refl(y0 - M + i / bw, h), h);
  *ix = clampi(refl(x0 - M + i % bw, w), w);
}

__device__ __forceinline__ void band_store(float* band, int th, int tw, int k,
                                           int i, float p, float c0, float c1,
                                           float c2) {
  const int M = 2 * (k / 2);
  const int n = (th + 2 * M) * (tw + 2 * M);
  band[i] = p;
  band[n + i] = c0 * p;
  band[2 * n + i] = c1 * p;
  band[3 * n + i] = c2 * p;
}

// The chain over a filled band. `smem` is the block's chain_floats(th, tw,
// k) floats, the band first; `st` the view's 12 statistic planes (h x w
// each: channels, box means, inverse covariance rr rg rb gg gb bb); (oh, ow)
// the part of the tile that holds outputs. Every thread of the block calls
// it; it synchronises before it reads the band and between its steps, not
// after the last `emit`.
template <int NT, class Emit>
__device__ __forceinline__ void chain(float* smem, const float* __restrict__ st,
                                      int h, int w, int k, float inv_k2, int th,
                                      int tw, int y0, int x0, int oh, int ow,
                                      int tid, Emit emit) {
  const int m1 = k / 2;
  const int M = 2 * m1;
  const int bh = th + 2 * M, bw = tw + 2 * M;  // input band
  const int mh = th + 2 * m1, mw = tw + 2 * m1;  // first-level maps
  float* band = smem;                 // 4 planes bh x bw
  float* rs = band + 4 * bh * bw;     // 4 planes mh x bw: row sums
  float* mid = rs + 4 * mh * bw;      // 4 planes mh x mw: a_r a_g a_b b
  float* rs2 = band;                  // 4 planes th x mw: second row sums (reuses band)
  const size_t hw = (size_t)h * w;
  const int nmh = oh + 2 * m1, nmw = ow + 2 * m1;
  const int by0 = y0 - M, bx0 = x0 - M;
  __syncthreads();

  // row sums for first-level map rows cy = refl(y0 - m1 + r)
  for (int i = tid; i < nmh * bw; i += NT) {
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

  // first-level maps at (refl(y0 - m1 + r), refl(x0 - m1 + q))
  for (int i = tid; i < nmh * nmw; i += NT) {
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

  // second box, valid over the first-level tile: rows then columns
  for (int i = tid; i < oh * nmw; i += NT) {
    const int ty = i / nmw, q = i % nmw;
    for (int c = 0; c < 4; ++c) {
      const float* col = mid + c * mh * mw + ty * mw + q;
      float s = col[0];
      for (int t = 1; t < k; ++t) s = s + col[t * mw];
      rs2[c * th * mw + ty * mw + q] = s;
    }
  }
  __syncthreads();

  for (int i = tid; i < oh * ow; i += NT) {
    const int ty = i / ow, tx = i % ow;
    for (int c = 0; c < 4; ++c) {
      const float* row = rs2 + c * th * mw + ty * mw + tx;
      float s = row[0];
      for (int t = 1; t < k; ++t) s = s + row[t];
      emit(c, ty, tx, s * inv_k2);
    }
  }
}

// The sampled matching cost (ops/cost_volume.py::_pair_cost, term by term):
// alpha * min(|dB| + |dG| + |dR|, tau1) + (1 - alpha) * min(|dGrad|, tau2).
// `one_minus_alpha` is the host's double 1.0 - alpha rounded to float, as
// the plain version multiplies by; tau = +inf means no clamp.
struct CostParams {
  float alpha, one_minus_alpha, border, tau1, tau2;
};

// Cost of local pixel a = (b, g, r, grad) at full-resolution column X
// against the other view at X - d (left view; border where X < d) or X + d
// (right view; border where X >= W - d). `oimg` / `ogrd` are the other
// view's row. On the border every other-view operand is `border`.
__device__ __forceinline__ float sampled_cost(const float a[4],
                                              const float* __restrict__ oimg,
                                              const float* __restrict__ ogrd,
                                              int X, int d, bool is_left, int W,
                                              const CostParams& cp) {
  const bool valid = is_left ? (X >= d) : (X < W - d);
  float b0 = cp.border, b1 = cp.border, b2 = cp.border, bg = cp.border;
  if (valid) {
    const int Xo = is_left ? X - d : X + d;
    b0 = oimg[3 * Xo];
    b1 = oimg[3 * Xo + 1];
    b2 = oimg[3 * Xo + 2];
    bg = ogrd[Xo];
  }
  float clr = fabsf(a[0] - b0) + fabsf(a[1] - b1) + fabsf(a[2] - b2);
  float grd = fabsf(a[3] - bg);
  clr = fminf(clr, cp.tau1);
  grd = fminf(grd, cp.tau2);
  return cp.alpha * clr + cp.one_minus_alpha * grd;
}

}  // namespace fgf
