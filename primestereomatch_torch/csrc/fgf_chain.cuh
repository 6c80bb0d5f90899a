// The low-resolution FastGuidedFilter coefficient chain of one tile, shared
// by lowmaps.cu (K1), cvc_lowmaps.cu (K4) and cvc_wta.cu (K10), and the
// sampled matching cost K4 and K10 build their bands from.
//
// A block owns an output tile of up to th x tw low-res pixels at (y0, x0)
// and a band of shared memory around it: M = 2 * (k / 2) more pixels on
// each side, one float4 (p, ch0 * p, ch1 * p, ch2 * p) per entry. The
// caller fills it with `band_index` / `band_store`; `chain` then computes
// box(p) and box(ch_c * p), the covariance, (a_r, a_g, a_b, b) through the
// symmetric inverse, and a box average of each map again, and hands every
// finished value to `emit(c, ty, tx, value)`.
//
// What the design does about the card: the four box passes are bound by
// shared-memory loads and instruction throughput, not by device memory.
//   * The four planes of an entry are one float4, so a tap is one 128-bit
//     load. Band entry i holds the reflect-101 padded plane at (y0 - M +
//     i / bw, x0 - M + i % bw), so the taps of an in-image pixel lie at
//     constant offsets: no reflection and no multiply per tap. A
//     first-level map whose pixel lies outside the image is the map of the
//     reflected in-image pixel: the thread that computes that pixel's map
//     also stores it at its mirror positions (a tile that lies inside the
//     image has none and skips the test).
//   * The box size is a template argument K (3, 5, 9, 17 = subsample 8, 4,
//     2, 1 at gif_radius 8; K = 0 takes any k at run time), so the tap
//     loops unroll. In the two vertical passes a thread produces RV
//     consecutive outputs along the box axis from K + RV - 1 taps held in
//     registers: each output still adds its own K taps from the first in
//     order, but the loads per output fall from K to (K + RV - 1) / RV (5
//     where there were 17 at K = 17). The two horizontal passes either
//     take one output a thread, neighbouring threads on neighbouring
//     columns (`chain`, RH = 1: conflict-free 128-bit loads, coalesced
//     statistic reads and map writes), or RH outputs a thread from
//     K + RH - 1 taps in registers (`chain_blocked`, which K1 runs): its
//     lanes take neighbouring rows at odd row pitches, and the statistic
//     reads and map writes follow in passes of their own over shared
//     memory, lanes again on neighbouring columns.
//
// Numerics follow ops/guided_filter.py step for step: every box sums its k
// taps in order, rows first and then columns, and scales by 1 / (k * k);
// the solve keeps the plain version's term order. Built with -fmad=false,
// the maps agree with the plain version bit for bit, whatever the tiling:
// each value is a fixed-order sum of values that depend on their position
// only.

#pragma once

#include <cuda_runtime.h>

#include "fastdiv.cuh"

namespace fgf {

// Outputs a thread produces along the box axis in the vertical passes;
// kernels/lowmaps.py mirrors the default (RUN).
#ifndef PSM_FGF_RV
#define PSM_FGF_RV 4
#endif
constexpr int RV = PSM_FGF_RV;

__device__ __forceinline__ int refl(int i, int n) {
  // reflect-101 for indices within one period of the axis
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float4 add4(const float4 a, const float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__host__ __device__ inline size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Floats of shared memory the chain needs for tiles of th x tw and k x k
// boxes, one float4 per entry. With rh = 1 (one output a thread in the
// horizontal passes): the band, the row sums and the first-level maps, with
// RV - 1 more rows of maps that the last vertical run reads past its outputs
// and drops. With rh > 1 two regions, each reused as the chain goes on: the
// band's (band, then the first-level box sums, then the sums over mid's
// rows) and one more (row sums, then the maps, then the final box sums);
// the rows the horizontal passes write have an odd pitch.
__host__ __device__ inline size_t chain_floats(int th, int tw, int k, int rh = 1) {
  const int M = 2 * (k / 2);
  const size_t bh = th + 2 * M, bw = tw + 2 * M, mh = th + M, mw = tw + M;
  if (rh == 1) return 4 * (bh * bw + mh * bw + (mh + RV - 1) * mw);
  // rh more entries: a horizontal run past the last row sums reads them
  return 4 * (bh * bw + max3(mh * (bw | 1), (mh + RV - 1) * mw, th * (size_t)(tw | 1)) + rh);
}

// Band entry i -> the in-image low-res pixel whose values it holds. The
// entries the chain uses lie within one reflection of the image; the
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
  reinterpret_cast<float4*>(band)[i] = make_float4(p, c0 * p, c1 * p, c2 * p);
}

// out[j] = src[j * stride] + src[(j + 1) * stride] + ... : k taps, added
// in order from the first, for R consecutive outputs. With K at compile
// time the K + R - 1 taps are loaded once into registers.
template <int K, int R>
__device__ __forceinline__ void run_sums(const float4* src, int stride, int k,
                                         float4 (&out)[R]) {
  if constexpr (K > 0) {
    float4 t[K + R - 1];
#pragma unroll
    for (int i = 0; i < K + R - 1; ++i) t[i] = src[i * stride];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float4 s = t[j];
#pragma unroll
      for (int i = 1; i < K; ++i) s = add4(s, t[j + i]);
      out[j] = s;
    }
  } else {
    static_assert(K > 0 || R == 1, "the run-time box takes one output at a time");
    float4 s = src[0];
    for (int i = 1; i < k; ++i) s = add4(s, src[i * stride]);
    out[0] = s;
  }
}

// The block-wide barrier the chain takes by default; a kernel that runs
// several chains at once in groups of warps passes its group's barrier.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// Rows [r_lo, r_hi) of dst (pitch dp) = sums over k rows of src (pitch sp):
// dst row r sums src rows r .. r + k - 1, over ncols columns; R rows a
// thread, neighbouring lanes on neighbouring columns.
template <int NT, int K, int R>
__device__ __forceinline__ void column_sums(const float4* src, int sp, float4* dst, int dp,
                                            int r_lo, int r_hi, int ncols, int k, int tid) {
  const FastDiv by_n(ncols);
  const int items = ((r_hi - r_lo + R - 1) / R) * ncols;
  for (int it = tid; it < items; it += NT) {
    const int g = by_n.div(it), c = it - g * ncols;
    const int r0 = r_lo + g * R;
    float4 s[R];
    run_sums<K, R>(src + r0 * sp + c, sp, k, s);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (r0 + j < r_hi) dst[(r0 + j) * dp + c] = s[j];
  }
}

// The nine statistics the solve reads at pixel offset o: the box means and
// the inverse covariance rr rg rb gg gb bb.
__device__ __forceinline__ void load_stats(const float* __restrict__ st, size_t hw, size_t o,
                                           float (&m)[9]) {
#pragma unroll
  for (int j = 0; j < 9; ++j) m[j] = st[(3 + j) * hw + o];
}

// The first-level maps (a_r, a_g, a_b, b) of an in-image pixel from its box
// sums s of (p, ch_c * p) and its statistics, in the plain version's term
// order.
__device__ __forceinline__ float4 solve(const float4 s, const float (&m)[9], float inv_k2) {
  const float mr = m[0], mg = m[1], mb = m[2];
  const float irr = m[3], irg = m[4], irb = m[5];
  const float igg = m[6], igb = m[7], ibb = m[8];
  const float mp = s.x * inv_k2;
  const float cov0 = s.y * inv_k2 - mr * mp;
  const float cov1 = s.z * inv_k2 - mg * mp;
  const float cov2 = s.w * inv_k2 - mb * mp;
  const float a_r = irr * cov0 + irg * cov1 + irb * cov2;
  const float a_g = irg * cov0 + igg * cov1 + igb * cov2;
  const float a_b = irb * cov0 + igb * cov1 + ibb * cov2;
  const float bb = mp - a_r * mr - a_g * mg - a_b * mb;
  return make_float4(a_r, a_g, a_b, bb);
}

// Stores the map m of mid entry (r, q), whose pixel (cy, cx) lies in the
// image, at its own entry and, where `edge`, at the entries that reflect
// onto it (across the image's first and last row and column).
__device__ __forceinline__ void store_mid(float4* mid, int mw, int nmh, int nmw, int h,
                                          int w, int my0, int mx0, int r, int q, bool edge,
                                          const float4 m) {
  if (!edge) {
    mid[r * mw + q] = m;
    return;
  }
  const int cy = my0 + r, cx = mx0 + q;
  const int rows[3] = {r, -cy - my0, 2 * h - 2 - cy - my0};
  const int cols[3] = {q, -cx - mx0, 2 * w - 2 - cx - mx0};
  const bool rok[3] = {true, cy >= 1 && rows[1] >= 0, cy <= h - 2 && rows[2] < nmh};
  const bool cok[3] = {true, cx >= 1 && cols[1] >= 0, cx <= w - 2 && cols[2] < nmw};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      if (rok[a] && cok[b]) mid[rows[a] * mw + cols[b]] = m;
}

// The chain with K at compile time and RH outputs a thread in the two
// horizontal passes, from K + RH - 1 taps in registers, each output still
// the sum of its own K taps in order. Their lanes take neighbouring rows, so
// each horizontal pass writes its sums to shared memory at an odd row
// pitch (conflict-free 128-bit accesses), and a pass whose lanes take
// neighbouring columns follows it: the solve (coalesced statistic reads) and
// the emits (coalesced map writes). Shared memory as chain_floats(th, tw,
// K, RH) lays it out: the band's region holds the band, then the
// first-level box sums, then the sums over mid's rows; the other region
// the row sums, then the maps, then the final box sums.
template <int NT, int K, int RH, class Emit, class Sync>
__device__ __forceinline__ void chain_blocked(float* smem, const float* __restrict__ st,
                                              int h, int w, float inv_k2, int th, int tw,
                                              int y0, int x0, int oh, int ow, int tid,
                                              Emit emit, Sync sync) {
  constexpr int m1 = K / 2, M = 2 * m1;
  const int bh = th + 2 * M, bw = tw + 2 * M;
  const int mw = tw + 2 * m1;
  const int bwp = bw | 1, mwp = mw | 1, twp = tw | 1;
  float4* band = reinterpret_cast<float4*>(smem);
  float4* rs = band + bh * bw;  // sums over the band's rows, pitch bwp
  float4* bs = band;            // first-level box sums, pitch mwp
  float4* mid = rs;             // a_r a_g a_b b, pitch mw
  float4* rs2 = band;           // sums over mid's rows, pitch mwp
  float4* fs = rs;              // final box sums, pitch twp
  const size_t hw = (size_t)h * w;
  const int nmh = oh + 2 * m1, nmw = ow + 2 * m1;
  const int nbw = ow + 2 * M;
  const int my0 = y0 - m1, mx0 = x0 - m1;
  const int ra = max(0, -my0), rb = min(nmh, h - my0);
  const int qa = max(0, -mx0), qb = min(nmw, w - mx0);
  const int nr = rb - ra, nq = qb - qa;
  const bool edge = nr < nmh || nq < nmw;
  sync();

  // sums over K band rows, for the in-image mid rows
  column_sums<NT, K, RV>(band, bw, rs, bwp, ra, rb, nbw, K, tid);
  sync();

  // first-level box sums at the in-image mid entries: RH along a row a
  // thread, neighbouring lanes on neighbouring rows
  {
    const FastDiv by_nr(nr);
    const int items = ((nq + RH - 1) / RH) * nr;
    for (int it = tid; it < items; it += NT) {
      const int g = by_nr.div(it), r = ra + it - g * nr;
      const int q0 = qa + g * RH;
      float4 s[RH];
      run_sums<K, RH>(rs + r * bwp + q0, 1, K, s);
#pragma unroll
      for (int j = 0; j < RH; ++j)
        if (q0 + j < qb) bs[r * mwp + q0 + j] = s[j];
    }
  }
  sync();

  // the first-level maps, each stored at its own entry and at the entries
  // that reflect onto it
  {
    const FastDiv by_nq(nq);
    for (int it = tid; it < nr * nq; it += NT) {
      const int rr = by_nq.div(it);
      const int r = ra + rr, q = qa + it - rr * nq;
      float m[9];
      load_stats(st, hw, (size_t)(my0 + r) * w + mx0 + q, m);
      store_mid(mid, mw, nmh, nmw, h, w, my0, mx0, r, q, edge,
                solve(bs[r * mwp + q], m, inv_k2));
    }
  }
  sync();

  // second box over the maps: sums over K mid rows
  column_sums<NT, K, RV>(mid, mw, rs2, mwp, 0, oh, nmw, K, tid);
  sync();

  // final box sums: RH along a row a thread, lanes on neighbouring rows
  {
    const FastDiv by_oh(oh);
    const int items = ((ow + RH - 1) / RH) * oh;
    for (int it = tid; it < items; it += NT) {
      const int g = by_oh.div(it), ty = it - g * oh;
      const int tx0 = g * RH;
      float4 s[RH];
      run_sums<K, RH>(rs2 + ty * mwp + tx0, 1, K, s);
#pragma unroll
      for (int j = 0; j < RH; ++j)
        if (tx0 + j < ow) fs[ty * twp + tx0 + j] = s[j];
    }
  }
  sync();

  {
    const FastDiv by_ow(ow);
    for (int it = tid; it < oh * ow; it += NT) {
      const int ty = by_ow.div(it), tx = it - ty * ow;
      const float4 s = fs[ty * twp + tx];
      emit(0, ty, tx, s.x * inv_k2);
      emit(1, ty, tx, s.y * inv_k2);
      emit(2, ty, tx, s.z * inv_k2);
      emit(3, ty, tx, s.w * inv_k2);
    }
  }
}

// The chain over a filled band. `smem` is the block's chain_floats(th, tw,
// k, RH) floats (16-byte aligned), the band first; `st` the view's 12
// statistic planes (h x w each: channels, box means, inverse covariance rr
// rg rb gg gb bb); (oh, ow) the part of the tile that holds outputs. K is
// the box size at compile time, or 0 for the run-time `k`. RH: outputs a
// thread produces in the horizontal passes (1 with K = 0). Every one of
// the NT threads that share `sync` calls it (tid in [0, NT)); it
// synchronises before it reads the band and between its steps, not after
// the last `emit` (which reads where the band lay, and with RH > 1 where
// the row sums lay).
template <int NT, int K, class Emit, class Sync = BlockSync, int RH = 1>
__device__ __forceinline__ void chain(float* smem, const float* __restrict__ st,
                                      int h, int w, int k, float inv_k2, int th,
                                      int tw, int y0, int x0, int oh, int ow,
                                      int tid, Emit emit, Sync sync = Sync()) {
  if constexpr (K > 0 && RH > 1) {
    chain_blocked<NT, K, RH>(smem, st, h, w, inv_k2, th, tw, y0, x0, oh, ow, tid, emit,
                             sync);
    return;
  }
  constexpr int R = K > 0 ? RV : 1;
  const int kk = K > 0 ? K : k;
  const int m1 = kk / 2;
  const int M = 2 * m1;
  const int bh = th + 2 * M, bw = tw + 2 * M;    // input band
  const int mh = th + 2 * m1, mw = tw + 2 * m1;  // first-level maps
  float4* band = reinterpret_cast<float4*>(smem);  // bh x bw
  float4* rs = band + bh * bw;      // mh x bw: sums over the band's rows
  float4* mid = rs + mh * bw;       // (mh + RV - 1) x mw: a_r a_g a_b b
  float4* rs2 = band;               // th x mw: sums over mid's rows (where the band lay)
  const size_t hw = (size_t)h * w;
  const int nmh = oh + 2 * m1, nmw = ow + 2 * m1;
  const int nbw = ow + 2 * M;       // band columns in use
  const int my0 = y0 - m1, mx0 = x0 - m1;   // pixel of mid entry (0, 0)
  // the mid rows and columns whose pixel lies in the image
  const int ra = max(0, -my0), rb = min(nmh, h - my0);
  const int qa = max(0, -mx0), qb = min(nmw, w - mx0);
  const int nr = rb - ra, nq = qb - qa;
  const bool edge = nr < nmh || nq < nmw;   // some mid entries lie outside the image
  sync();

  // sums over k band rows, for the in-image mid rows: R rows a thread
  column_sums<NT, K, R>(band, bw, rs, bw, ra, rb, nbw, kk, tid);
  sync();

  // first-level maps at the in-image pixels (my0 + r, mx0 + q), each stored
  // at its own entry and at the entries that reflect onto it
  {
    const FastDiv by_nq(nq);
    for (int it = tid; it < nr * nq; it += NT) {
      const int rr = by_nq.div(it);
      const int r = ra + rr, q = qa + it - rr * nq;
      float4 s[1];
      run_sums<K, 1>(rs + r * bw + q, 1, kk, s);
      float m[9];
      load_stats(st, hw, (size_t)(my0 + r) * w + mx0 + q, m);
      store_mid(mid, mw, nmh, nmw, h, w, my0, mx0, r, q, edge, solve(s[0], m, inv_k2));
    }
  }
  sync();

  // second box over the maps: sums over k mid rows, R rows a thread
  column_sums<NT, K, R>(mid, mw, rs2, mw, 0, oh, nmw, kk, tid);
  sync();

  {
    const FastDiv by_ow(ow);
    for (int it = tid; it < oh * ow; it += NT) {
      const int ty = by_ow.div(it), tx = it - ty * ow;
      float4 s[1];
      run_sums<K, 1>(rs2 + ty * mw + tx, 1, kk, s);
      emit(0, ty, tx, s[0].x * inv_k2);
      emit(1, ty, tx, s[0].y * inv_k2);
      emit(2, ty, tx, s[0].z * inv_k2);
      emit(3, ty, tx, s[0].w * inv_k2);
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

// Cost of local pixel a = (b, g, r, grad) against the other view's
// (b0, b1, b2, bg).
__device__ __forceinline__ float pair_cost(const float a[4], float b0, float b1, float b2,
                                           float bg, const CostParams& cp) {
  float clr = fabsf(a[0] - b0) + fabsf(a[1] - b1) + fabsf(a[2] - b2);
  float grd = fabsf(a[3] - bg);
  clr = fminf(clr, cp.tau1);
  grd = fminf(grd, cp.tau2);
  return cp.alpha * clr + cp.one_minus_alpha * grd;
}

// Cost of local pixel a at full-resolution column X against the other view
// at X - d (left view; border where X < d) or X + d (right view; border
// where X >= W - d). `oimg` / `ogrd` are the other view's row. On the
// border every other-view operand is `border`.
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
  return pair_cost(a, b0, b1, b2, bg, cp);
}

}  // namespace fgf
