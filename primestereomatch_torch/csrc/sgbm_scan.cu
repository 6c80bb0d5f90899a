// K7: SGM directional dynamic programming, summed over directions.
//
// Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_sgbm_scan_kernel
// (launchers sgbm_scan_pallas, sgbm_aggregate_partials_pallas). Along a
// scan direction r, per pixel p and disparity d:
//   L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, minL(p-r) + P2)
//             - minL(p-r),
// with L = 0 and minL = 0 before the first pixel of a path. The output is
// the sum of L over a set of directions: the int32 S over all of them, or
// narrow group partials, one uint16 tensor per group of directions, which
// the selection kernel (select.cu) adds as it reads. 0 <= L <= cost_bound
// + P2 by induction (best - minL <= P2), so a group of g directions fits
// 16 bits where g * (cost_bound + P2) < 2^16; the wrapper decides.
//
// What bounds it: ~8 integer operations per (direction, pixel, d) against
// 6 bytes of device memory per (pixel, d) for the function (the int16 cost
// read once, 4 bytes of sums written once): operations. This kernel, like
// any that scans a direction at a time, moves more: every pass reads the
// cost and reads and writes its sums. With two uint16 groups of four
// directions that is 44 bytes per (pixel, d) (76 with the int32 S), and at
// a 2K frame the device memory is what it waits for; at Middlebury sizes
// there are too few paths to fill the card and a step's latency is. The
// recurrence is sequential along a path. The TPU carries a whole image
// line of state in VMEM from one grid step to the next, and runs the
// diagonals as a shear of a row scan; on Hopper blocks run in no order, so
// each path is one warp that walks it:
//   * lanes over d, VPL = ceil(D/32) consecutive disparities per lane in
//     registers; d-1 and d+1 come from the lane's own registers or, at the
//     chunk edge, one shuffle from the neighbouring lane; minL is a warp
//     min reduction; d >= D holds BIG (never a minimum);
//   * the diagonals are independent paths that start with zero state on
//     the image border, which is what the TPU's shear computes (zero
//     shifted in at the edge);
//   * a path family (rows, columns, diagonals, anti-diagonals) is walked
//     forward and, for the opposite direction, back by the same warp: the
//     same lane adds into the same entries in both passes, and the paths
//     of a family cover disjoint pixels, so the sums need no atomics and
//     are exact in any order. One launch walks two families whose sums go
//     to different tensors (a family of each group), which halves the
//     launches and doubles the warps in flight; with the single int32 S a
//     launch walks one family. The first family of a tensor writes it, the
//     others add;
//   * a warp keeps the next pixels of its path in a ring in shared memory:
//     NSTAGE stages of G pixels each, a pixel's D costs and D sums as they
//     lie in device memory, filled by cp.async (16-byte copies where D
//     allows, else 8 or 4; plain loads where not even 4 divide), the
//     copies of a stage shared among the lanes, one commit group per
//     stage, so (NSTAGE - 1) * G pixels are in flight while one is
//     computed. The lanes read their VPL values from the ring as one
//     vector and store their sums as one vector. At Middlebury sizes every
//     path of a launch is resident at once and the launch lasts as long as
//     its longest path: what is left per step is the chain of dependent
//     operations (ring read, two shuffles, the mins, the warp reduction)
//     and starting the copies, not the device memory's latency.
//
// Layout: cost (H, W, D) int16 or int32; sums (H, W, D) uint16 or int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NSTAGE = 4;
constexpr int MAX_WARPS = 4;
constexpr int SMEM_BUDGET = 200 * 1024;

// A set of parallel paths and the tensor their sums go to.
struct Family {
  void* out;      // (H, W, D) sums
  int dy, dx;     // the forward pass's step
  int both;       // walk back too: the opposite direction
  int first;      // the forward pass writes `out` instead of adding to it
  int n_lines;
};

template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Pack {
  T e[N];
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else if (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <typename CT, typename ST, int VPL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
sgm_scan_kernel(const CT* __restrict__ cost, Family fa, Family fb, int H, int W, int D,
                int p1, int p2, int G, int cpb, int vec_ok) {
  extern __shared__ uint4 ring_raw[];
  constexpr int COST_B = 32 * VPL * (int)sizeof(CT);
  constexpr int SLOT_B = COST_B + 32 * VPL * (int)sizeof(ST);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int line = blockIdx.x * (blockDim.x >> 5) + warp;
  Family f = fa;
  if (line >= fa.n_lines) {       // whole warps choose and leave together
    line -= fa.n_lines;
    f = fb;
    if (line >= fb.n_lines) return;
  }
  char* ring = (char*)ring_raw + (size_t)warp * NSTAGE * G * SLOT_B;
  ST* sums = (ST*)f.out;

  // the path: start pixel (y0, x0), step (dy, dx), n pixels
  int y0, x0, n;
  if (f.dy == 0) {                 // rows, W -> E
    y0 = line; x0 = 0; n = W;
  } else if (f.dx == 0) {          // columns, N -> S
    y0 = 0; x0 = line; n = H;
  } else if (line < W) {           // diagonals from the top row
    y0 = 0; x0 = line;
    n = min(H, f.dx > 0 ? W - x0 : x0 + 1);
  } else {                         // ... and from the left / right column
    y0 = line - W + 1; x0 = f.dx > 0 ? 0 : W - 1;
    n = min(H - y0, W);
  }
  const long long step = ((long long)f.dy * W + f.dx) * D;
  const long long start = ((long long)y0 * W + x0) * D;
  const int d0 = lane * VPL;
  const int n_st = (n + G - 1) / G;
  // a pixel is nc copies of cpb bytes for its costs, then ns for its sums
  const int nc = cpb ? D * (int)sizeof(CT) / cpb : 0;
  const int ns_all = cpb ? D * (int)sizeof(ST) / cpb : 0;

  for (int pass = 0; pass < (f.both ? 2 : 1); ++pass) {
    const bool write = f.first && pass == 0;
    // pass 0 walks the path forward, pass 1 backward
    const long long pix0 = pass == 0 ? start : start + (long long)(n - 1) * step;
    const long long inc = pass == 0 ? step : -step;
    // how the lanes share a stage's copies: lane (lg, lc) takes copy lc of
    // the pixels lg, lg + ppi, ...; with more than 32 copies a pixel the
    // lanes take them in turns
    const int per = nc + (write ? 0 : ns_all);
    int ppi = 1, lg = 0, lc = lane;
    if (cpb && per <= 32) {
      ppi = 32 / per;
      lg = lane / per;
      lc = lg < ppi ? lane - lg * per : per;
    }

    // stage s of the path into its stage of the ring, as the pixels lie in
    // device memory: D costs at a slot's start, D sums from COST_B on
    auto fetch_copies = [&](int s, auto bytes) {
      constexpr int CPB = decltype(bytes)::value;
      const int g_end = min(G, n - s * G);
      char* stage = ring + (size_t)(s % NSTAGE) * G * SLOT_B;
      const long long pix_s = pix0 + (long long)s * G * inc;
      for (int g = lg; g < g_end; g += ppi) {
        const long long pix = pix_s + g * inc;
        char* slot = stage + g * SLOT_B;
        for (int c = lc; c < per; c += 32) {
          if (c < nc)
            cp_async<CPB>(slot + c * CPB, (const char*)(cost + pix) + c * CPB);
          else
            cp_async<CPB>(slot + COST_B + (c - nc) * CPB,
                          (const char*)(sums + pix) + (c - nc) * CPB);
        }
      }
    };
    auto fetch = [&](int s) {
      if (cpb == 16) {
        fetch_copies(s, std::integral_constant<int, 16>{});
      } else if (cpb == 8) {
        fetch_copies(s, std::integral_constant<int, 8>{});
      } else if (cpb == 4) {
        fetch_copies(s, std::integral_constant<int, 4>{});
      } else {                     // nothing divides a pixel: plain loads
        const int g_end = min(G, n - s * G);
        char* slot = ring + (size_t)(s % NSTAGE) * G * SLOT_B;
        long long pix = pix0 + (long long)s * G * inc;
        for (int g = 0; g < g_end; ++g, pix += inc, slot += SLOT_B)
          for (int c = lane; c < D; c += 32) {
            ((CT*)slot)[c] = cost[pix + c];
            if (!write) ((ST*)(slot + COST_B))[c] = sums[pix + c];
          }
      }
    };

    int L[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) L[j] = d0 + j < D ? 0 : BIG;
    int minL = 0;

    __syncwarp();                  // the ring is free: the last pass has been read
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < n_st) fetch(s);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int s = 0; s < n_st; ++s) {
      __syncwarp();                // every lane has read stage s - 1: refill it
      if (s + NSTAGE - 1 < n_st) fetch(s + NSTAGE - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1) : "memory");
      __syncwarp();                // stage s has arrived, for every lane's copies

      const int g_end = min(G, n - s * G);
      const char* slot = ring + (size_t)(s % NSTAGE) * G * SLOT_B;
      long long pix = pix0 + (long long)s * G * inc;
      for (int g = 0; g < g_end; ++g, pix += inc, slot += SLOT_B) {
        const Pack<CT, VPL> c = *(const Pack<CT, VPL>*)(slot + d0 * sizeof(CT));
        Pack<ST, VPL> sv;
        if (!write) sv = *(const Pack<ST, VPL>*)(slot + COST_B + d0 * sizeof(ST));

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
            Ln[j] = (int)c.e[j] + best - minL;
            mn = min(mn, Ln[j]);
          } else {
            Ln[j] = BIG;
          }
        }
        minL = __reduce_min_sync(FULL, mn);
        ST* o = sums + pix + d0;
        if (vec_ok) {              // D % VPL == 0: a lane is all in or all out
          if (d0 < D) {
            Pack<ST, VPL> res;
#pragma unroll
            for (int j = 0; j < VPL; ++j)
              res.e[j] = (ST)(write ? Ln[j] : (int)sv.e[j] + Ln[j]);
            *(Pack<ST, VPL>*)o = res;
          }
        } else {
#pragma unroll
          for (int j = 0; j < VPL; ++j)
            if (d0 + j < D) o[j] = (ST)(write ? Ln[j] : (int)sv.e[j] + Ln[j]);
        }
#pragma unroll
        for (int j = 0; j < VPL; ++j) L[j] = Ln[j];
      }
    }
    __threadfence_block();         // the pass back reads what this pass wrote
  }
}

int copy_bytes(size_t row_bytes_c, size_t row_bytes_s, const void* a, const void* b,
               const void* c) {
  for (int cpb = 16; cpb >= 4; cpb /= 2)
    if (row_bytes_c % cpb == 0 && row_bytes_s % cpb == 0 && (uintptr_t)a % cpb == 0 &&
        (uintptr_t)b % cpb == 0 && (uintptr_t)c % cpb == 0)
      return cpb;
  return 0;
}

template <typename CT, typename ST, int VPL>
cudaError_t launch_vpl(const CT* cost, Family fa, Family fb, int H, int W, int D, int p1,
                       int p2, int ring_bytes, cudaStream_t s) {
  constexpr int SLOT_B = 32 * VPL * (int)(sizeof(CT) + sizeof(ST));
  int G = ring_bytes / (NSTAGE * SLOT_B);
  if (G < 1) G = 1;
  const int warp_bytes = NSTAGE * G * SLOT_B;
  int warps = SMEM_BUDGET / warp_bytes;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = warps * warp_bytes;
  const int cpb = copy_bytes(D * sizeof(CT), D * sizeof(ST), cost, fa.out, fb.out);
  constexpr int VEC_B = VPL * sizeof(ST) >= 16 ? 16 : VPL * (int)sizeof(ST);
  const int vec_ok = D % VPL == 0 && (uintptr_t)fa.out % VEC_B == 0 &&
                     (uintptr_t)fb.out % VEC_B == 0;
  auto kernel = sgm_scan_kernel<CT, ST, VPL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (fa.n_lines + fb.n_lines + warps - 1) / warps;
  kernel<<<grid, warps * 32, smem, s>>>(cost, fa, fb, H, W, D, p1, p2, G, cpb, vec_ok);
  return cudaGetLastError();
}

template <typename CT, typename ST>
cudaError_t launch(const CT* cost, Family fa, Family fb, int H, int W, int D, int p1, int p2,
                   int ring_bytes, cudaStream_t s) {
#define PSM_SCAN(V) return launch_vpl<CT, ST, V>(cost, fa, fb, H, W, D, p1, p2, ring_bytes, s)
  if (D <= 32) PSM_SCAN(1);
  if (D <= 64) PSM_SCAN(2);
  if (D <= 128) PSM_SCAN(4);
  if (D <= 256) PSM_SCAN(8);
  if (D <= 512) PSM_SCAN(16);
  if (D <= 1024) PSM_SCAN(32);
  if (D <= 2048) PSM_SCAN(64);   // spills to local memory, still exact
#undef PSM_SCAN
  return cudaErrorInvalidValue;
}

Family family(void* out, int dy, int dx, int both, int first, int H, int W) {
  Family f = {out, dy, dx, both, first, 0};
  if (out) f.n_lines = dy == 0 ? H : dx == 0 ? W : H + W - 1;
  return f;
}

}  // namespace

// One launch: every path of family a, (dy, dx) in {(0,1), (1,0), (1,1),
// (1,-1)}, forward and (both != 0) backward, summed into out_a (first != 0:
// the forward pass writes it); and, where out_b is not null, the same for
// family b into out_b, which must be another tensor. The sums are uint16
// (sums_are_u16, int16 cost only) or int32. ring_bytes: shared memory per
// warp for the ring of pixels ahead.
extern "C" int psm_sgm_scan(const void* cost, int cost_is_int16, int sums_are_u16,
                            void* out_a, int dy_a, int dx_a, int both_a, int first_a,
                            void* out_b, int dy_b, int dx_b, int both_b, int first_b, int H,
                            int W, int D, int p1, int p2, int ring_bytes, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0) return (int)cudaSuccess;
  if (!out_a || out_a == out_b || (sums_are_u16 && !cost_is_int16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Family fa = family(out_a, dy_a, dx_a, both_a, first_a, H, W);
  const Family fb = family(out_b, dy_b, dx_b, both_b, first_b, H, W);
  if (sums_are_u16)
    return (int)launch<int16_t, uint16_t>((const int16_t*)cost, fa, fb, H, W, D, p1, p2,
                                          ring_bytes, s);
  if (cost_is_int16)
    return (int)launch<int16_t, int32_t>((const int16_t*)cost, fa, fb, H, W, D, p1, p2,
                                         ring_bytes, s);
  return (int)launch<int32_t, int32_t>((const int32_t*)cost, fa, fb, H, W, D, p1, p2,
                                       ring_bytes, s);
}
