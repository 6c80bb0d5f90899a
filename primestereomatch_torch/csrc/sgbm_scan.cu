// K7: SGM directional dynamic programming, summed over directions.
//
// Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_sgbm_scan_kernel
// (launchers sgbm_scan_pallas, sgbm_aggregate_partials_pallas). Along a
// scan direction r, per pixel p and disparity d:
//   L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, minL(p-r) + P2)
//             - minL(p-r),
// with L = 0 and minL = 0 before the first pixel of a path. S(p, d) is the
// int32 sum of L over the directions.
//
// What bounds it: ~8 integer operations per (direction, pixel, d) against
// 6 bytes of device memory per (pixel, d) (the int16 cost read once, the
// int32 S written once): operations. The recurrence is sequential along a
// path. The TPU carries a whole image line of state in VMEM from one grid
// step to the next, and runs the diagonals as a shear of a row scan; on
// Hopper blocks run in no order, so each path is one warp that walks it:
//   * lanes over d, VPL = ceil(D/32) consecutive disparities per lane in
//     registers; d-1 and d+1 come from the lane's own registers or, at the
//     chunk edge, one shuffle from the neighbouring lane; minL is a warp
//     min reduction; d >= D holds BIG (never a minimum);
//   * the diagonals are independent paths that start with zero state on
//     the image border, which is what the TPU's shear computes (zero
//     shifted in at the edge);
//   * one launch per path family (rows, columns, diagonals, anti-diagonals)
//     walks each path forward and, for the opposite direction, back: the
//     same lane adds into the same S entries in both passes, and the paths
//     of one launch cover disjoint pixels, so S is summed without atomics
//     and in a fixed order per launch (exact in integers in any order).
//     The first launch writes S, the others add to it;
//   * the next pixel's cost and S are loaded one step ahead.
// Path lengths up to W or H keep a warp busy for thousands of dependent
// steps; a later version can split the d range over more warps.
//
// Layout: cost (H, W, D) int16 or int32, S (H, W, D) int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;

template <typename CT, int VPL>
__global__ void __launch_bounds__(WARPS * 32)
sgm_scan_kernel(const CT* __restrict__ cost, int* __restrict__ S, int H, int W, int D,
                int p1, int p2, int dy, int dx, int n_lines, int both, int first) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (line >= n_lines) return;   // whole warps leave together

  // the path: start pixel (y0, x0), step (dy, dx), n pixels
  int y0, x0, n;
  if (dy == 0) {                   // rows, W -> E
    y0 = line; x0 = 0; n = W;
  } else if (dx == 0) {            // columns, N -> S
    y0 = 0; x0 = line; n = H;
  } else if (line < W) {           // diagonals from the top row
    y0 = 0; x0 = line;
    n = min(H, dx > 0 ? W - x0 : x0 + 1);
  } else {                         // ... and from the left / right column
    y0 = line - W + 1; x0 = dx > 0 ? 0 : W - 1;
    n = min(H - y0, W);
  }
  const long long step = ((long long)dy * W + dx) * D;
  const long long start = ((long long)y0 * W + x0) * D;
  const int d0 = lane * VPL;

  for (int pass = 0; pass < (both ? 2 : 1); ++pass) {
    const bool write = first && pass == 0;
    // pass 0 walks the path forward, pass 1 backward
    long long pix = pass == 0 ? start : start + (long long)(n - 1) * step;
    const long long inc = pass == 0 ? step : -step;

    int L[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) L[j] = d0 + j < D ? 0 : BIG;
    int minL = 0;

    int c_cur[VPL], s_cur[VPL], c_nxt[VPL], s_nxt[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const bool in = d0 + j < D;
      c_cur[j] = in ? (int)cost[pix + d0 + j] : 0;
      s_cur[j] = (in && !write) ? S[pix + d0 + j] : 0;
    }
    for (int t = 0; t < n; ++t) {
      const long long nxt = pix + inc;
      if (t + 1 < n) {
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const bool in = d0 + j < D;
          c_nxt[j] = in ? (int)cost[nxt + d0 + j] : 0;
          s_nxt[j] = (in && !write) ? S[nxt + d0 + j] : 0;
        }
      }
      int below = __shfl_up_sync(FULL, L[VPL - 1], 1);   // L[d0 - 1]
      int above = __shfl_down_sync(FULL, L[0], 1);       // L[d0 + VPL]
      if (lane == 0) below = BIG;
      if (lane == 31) above = BIG;
      int Ln[VPL];
      int mn = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (d0 + j < D) {
          const int lo = j > 0 ? L[j - 1] : below;
          const int hi = j < VPL - 1 ? L[j + 1] : above;
          const int best = min(min(L[j], min(lo, hi) + p1), minL + p2);
          Ln[j] = c_cur[j] + best - minL;
          mn = min(mn, Ln[j]);
        } else {
          Ln[j] = BIG;
        }
      }
      minL = __reduce_min_sync(FULL, mn);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        L[j] = Ln[j];
        if (d0 + j < D) S[pix + d0 + j] = write ? Ln[j] : s_cur[j] + Ln[j];
        c_cur[j] = c_nxt[j];
        s_cur[j] = s_nxt[j];
      }
      pix = nxt;
    }
  }
}

template <typename CT>
cudaError_t launch(const CT* cost, int* S, int H, int W, int D, int p1, int p2, int dy,
                   int dx, int both, int first, cudaStream_t s) {
  const int n_lines = dy == 0 ? H : dx == 0 ? W : H + W - 1;
  const int grid = (n_lines + WARPS - 1) / WARPS;
  const int block = WARPS * 32;
#define PSM_SCAN(V)                                                           \
  sgm_scan_kernel<CT, V><<<grid, block, 0, s>>>(cost, S, H, W, D, p1, p2, dy, \
                                               dx, n_lines, both, first)
  if (D <= 32) PSM_SCAN(1);
  else if (D <= 64) PSM_SCAN(2);
  else if (D <= 128) PSM_SCAN(4);
  else if (D <= 256) PSM_SCAN(8);
  else if (D <= 512) PSM_SCAN(16);
  else if (D <= 1024) PSM_SCAN(32);
  else if (D <= 2048) PSM_SCAN(64);   // spills to local memory, still exact
  else return cudaErrorInvalidValue;
#undef PSM_SCAN
  return cudaGetLastError();
}

}  // namespace

// One launch: every path of the family (dy, dx) in {(0,1), (1,0), (1,1),
// (1,-1)}, forward and (both != 0) backward; first != 0 writes S instead
// of adding to it.
extern "C" int psm_sgm_scan(const void* cost, int cost_is_int16, int* S, int H, int W,
                            int D, int p1, int p2, int dy, int dx, int both, int first,
                            void* stream) {
  if (H <= 0 || W <= 0 || D <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(cost_is_int16
                   ? launch((const int16_t*)cost, S, H, W, D, p1, p2, dy, dx, both, first, s)
                   : launch((const int32_t*)cost, S, H, W, D, p1, p2, dy, dx, both, first, s));
}
