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
// read once, 4 bytes of sums written once): operations. Two designs, both
// named sgm_scan_kernel; the wrapper (kernels/sgbm_scan.py::route) picks
// one by the shape.
//
// The path families' kernel serves every shape: the int32 S, and the
// uint16 partials wherever the sweeps below do not. Like any kernel that
// scans a direction at a time it moves more than the function: every pass
// reads the cost and reads and writes its sums. With two uint16 groups of
// four directions that is 44 bytes per (pixel, d) (76 with the int32 S),
// and at a 2K frame the device memory is what it waits for; at Middlebury
// sizes there are too few paths to fill the card and a step's latency is.
// The recurrence is sequential along a path. The TPU carries a whole image
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
// The sweeps serve the uint16 partials of an int16 cost at 128 < D <= 256
// and W >= 1600 where the card holds every block of both sweeps at once;
// narrower, a row's hand-offs cost more than its columns' work and the
// path families are ahead. They move 8 bytes per (pixel, d): two sweeps
// over the image, each reading every cost once and writing its group's sum
// once, with the state of its four directions on chip.
//   * The top-down sweep carries W->E, NW->SE, N->S and NE->SW: each needs
//     only the row above or the pixel to the left. The bottom-up sweep is
//     the same walk in mirrored coordinates (y -> H-1-y, x -> W-1-x), which
//     makes them E->W, SE->NW, S->N and SW->NE. A sweep computes all four
//     and sums those its mode takes (MODE_SGBM: four, then E->W alone;
//     MODE_SGBM_3WAY: W->E and N->S, then E->W). Both sweeps run in one
//     launch (blockIdx.y).
//   * A sweep is one block per strip of SW columns and a warp per C of the
//     strip's columns (sweep_plan: strips from the SM count, C from SW and
//     the registers). Each warp walks every row of the image over its
//     columns, lanes over d as above (VPL = 8, packed as below); the N, NW
//     and NE states of its columns stay in the warp's registers from one row
//     to the next.
//   * A row is two passes over the warp's columns. First the vertical
//     directions, which need only the row above: inside the warp from its
//     registers, at its first column NW(r-1) of the column to the left and
//     at its last NE(r-1) of the column to the right. Then W->E, a chain
//     along the row that enters from the column to the left. W->E is what
//     runs across the whole image width in turn, so a warp does only that
//     once the chain reaches it: the step behind the chain is a quarter of
//     the work.
//   * Neighbouring warps of a block pass those columns' states through
//     shared memory, two rows of slots, with a count per warp of the rows
//     whose vertical pass and whose W->E pass it has handed on (release
//     stores, acquire polls). Neighbouring strips pass them through device
//     memory: slots of 64-bit words, each a packed word of two L (below)
//     and the 32-bit tag of its row (a sequence the wrapper advances every
//     launch, plus the row),
//     which the reader polls until every word carries the tag it wants:
//     value and flag in one single-copy-atomic word, so no fence and no
//     reset between launches. A ring of RING_ROWS rows of slots is enough:
//     a strip writes row r's right-edge slots only after it has read the
//     right strip's NE(r-1), which that strip wrote after it had read row
//     r-2 of this one; the left edge is the mirror case. So a strip waits
//     on both neighbours, and the launch is cooperative: every block is
//     resident, or the runtime refuses the launch. A wait that lasts 10 s
//     traps.
//   * A warp's costs come in a ring in shared memory, a stage a row of its
//     columns, NSTAGE - 1 rows ahead, filled by cp.async as above; both
//     passes of a row read them there.
//   * Every value of a step fits 16 bits, so a lane keeps its 8 disparities
//     as 4 32-bit words, d0 + 2k in the low half of word k and d0 + 2k + 1
//     in the high half, as the int16 costs and the uint16 sums lie in memory:
//     the states, the slots, the costs (read from the ring as they are) and
//     the sums. Word k's lower neighbours are one __byte_perm of words k - 1
//     and k (the lane's edges by the two shuffles), its upper ones word
//     k + 1's; min(P, min(lo, hi) + P1, minL + P2) is Hopper's u16x2 DPX
//     min3 and add-min, two disparities an instruction; C + best - minL is
//     one 32-bit add; the sums 32-bit adds; minL a u16x2 min over the words,
//     the lesser half, the warp's reduction. That is exact only where no
//     half carries into the next or borrows from it, i.e. where every value
//     and every intermediate lies in [0, 2^16). The wrapper sends the sweeps
//     only penalties and cost bounds that make it so
//     (kernels/sgbm_scan.py::halves_hold, held by its tests):
//       - P1, P2 >= 0 and costs in [0, cost_bound]: L in [0, cost_bound + P2]
//         (above), minL + P2 <= cost_bound + 2 P2 < 2^16;
//       - a P1 above P2 is taken as P2 (psm_sgm_sweep): every neighbour holds
//         at least minL, so min(lo, hi) + P1 >= minL + P2 with either, and the
//         term never wins. So minL + P2 - P1 >= 0, and the add-min adds P1 to
//         at most minL + P2 - P1: no carry;
//       - C + best - minL is L: each half's result is in range, so the 32-bit
//         add is the two 16-bit ones;
//       - at d >= D the state before a path and the lanes' edges hold BIG =
//         2^16 - 1 - P1, above every L (cost_bound + P2 + P1 < 2^16 - 1), and
//         the costs 2^16 - 1 - P2: a step adds best - minL, which lies in
//         [0, P2], to the cost, so such a half stays in [2^16 - 1 - P2,
//         2^16 - 1], at or above every L, and needs no fixing. A pad half sits above every real
//         one of its word, so what a sum carries out of it goes into another
//         pad half or out of the word;
//       - a group's sum is at most g (cost_bound + P2) < 2^16 (the partials'
//         rule).
//     Against one int32 a disparity, a step takes half the instructions and
//     registers, and a slot, an edge word or a sum half the words.
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

// ---- the sweeps: uint16 partials of an int16 cost, 128 < D <= 256 ----

constexpr int SWEEP_WARPS = 12;    // also bounds the registers: 170 a thread
constexpr int RING_ROWS = 4;       // rows of edge slots a strip keeps in device memory
// edge slots of a strip: W->E and NW of its last column, NE of its first
constexpr int K_WE = 0, K_NW = 1, K_NE = 2, KINDS = 3;
// a sweep's directions, sweep-local
constexpr int WE = 1, NW = 2, NN = 4, NE = 8, ALL = 15;
constexpr long long PATIENCE_NS = 10000000000LL;
// a poll that finds nothing yet sleeps this long (ns) before the next: a
// neighbour warp's count in shared memory, a neighbour strip's edge (no
// other value of either moved a 2K launch by 1%)
constexpr unsigned NAP_NS = 32, EDGE_NAP_NS = 64;
// the disparities the sweeps take (kernels/sgbm_scan.py's rule): VPL = 8,
// as WPL = 4 words of two
constexpr int SWEEP_VPL = 8, SWEEP_MIN_D = 129, SWEEP_MAX_D = 256;
constexpr int WPL = SWEEP_VPL / 2;
// a half's largest value (kernels/sgbm_scan.py's HALF - 1)
constexpr int HALF_MAX = 0xffff;
// the plan's fields (int64 each), shared with kernels/sgbm_scan.py
enum { P_NSTRIPS, P_SW, P_WARPS, P_COLS, P_SMEM, P_BLOCKS, P_EDGE_BYTES, P_SMS, P_LEN };

// the most columns a warp holds: their three states and sums in registers
constexpr int SWEEP_COLS = 3;
// shared memory before the slots: each warp's two counts, in 16-byte units
constexpr int COUNTS_B = (2 * SWEEP_WARPS * (int)sizeof(int) + 15) / 16 * 16;

struct Sweep {
  void* out;       // (H, W, D) uint16 sums of the sweep's directions
  int mirror;      // walk bottom-up and E->W
  int dirs;        // the directions summed (WE, NW, NN, NE)
};

struct Plan {
  int nstrips, sw, cols, cpb, vec_ok;
  unsigned long long* edges;   // [sweep][strip][KINDS][RING_ROWS][32 * WPL]
};

// The penalties as the step uses them: P1 (at most P2), P2, and P1 and BIG
// in both halves of a word.
struct Pen {
  int p1, p2;
  unsigned p1x2, big2;
};

// v in both halves of a word
__device__ __forceinline__ unsigned pair(int v) { return (unsigned)v * 0x10001u; }

__device__ __forceinline__ int load_progress(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v) : "r"((uint32_t)__cvta_generic_to_shared(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_progress(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n"
               ::"r"((uint32_t)__cvta_generic_to_shared(p)), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// Counts a wait's polls; traps once it has lasted PATIENCE_NS.
struct Patience {
  int polls = 0;
  long long t0 = 0;
  __device__ void tick() {
    if ((++polls & 1023) == 0) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (!t0) t0 = t;
      else if (t - t0 > PATIENCE_NS) __trap();
    }
  }
};

// The state before a path's first pixel: L = 0 (BIG for d >= D, from the
// lane's pad_from-th half on), minL 0.
__device__ __forceinline__ int zero(unsigned (&P)[WPL], int pad_from, unsigned big2) {
#pragma unroll
  for (int k = 0; k < WPL; ++k)
    P[k] = 2 * k >= pad_from ? big2 : 2 * k + 1 >= pad_from ? big2 & 0xffff0000u : 0u;
  return 0;
}

__device__ __forceinline__ int warp_min(const unsigned (&P)[WPL]) {
  unsigned m = P[0];
  int k = 1;
#pragma unroll
  for (; k + 1 < WPL; k += 2) m = __vimin3_u16x2(m, P[k], P[k + 1]);
  if (k < WPL) m = __vminu2(m, P[k]);
  return (int)__reduce_min_sync(FULL, min(m & 0xffffu, m >> 16));
}

// One step of a direction: predecessor P (its minL mp), costs c -> L; returns
// minL. Word k's lower neighbours (d - 1 of each half) are the high half of
// word k - 1 and the low half of word k; its upper ones are word k + 1's.
__device__ __forceinline__ int dp(const unsigned (&P)[WPL], int mp, const unsigned (&c)[WPL],
                                  unsigned (&L)[WPL], const Pen& pen, int lane) {
  unsigned below = __shfl_up_sync(FULL, P[WPL - 1], 1);   // its high half: P[d0 - 1]
  unsigned above = __shfl_down_sync(FULL, P[0], 1);       // its low half: P[d0 + VPL]
  if (lane == 0) below = pen.big2;
  if (lane == 31) above = pen.big2;
  // min(P, min(lo, hi) + p1, mp + p2) as min(min(lo, hi, mp + p2 - p1) + p1, P),
  // both halves at once; C + best - mp as one 32-bit add (no half carries)
  const unsigned capm = pair(mp + pen.p2 - pen.p1), mp2 = pair(mp);
  unsigned lo = __byte_perm(below, P[0], 0x5432);
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const unsigned hi = __byte_perm(P[k], k + 1 < WPL ? P[k + 1] : above, 0x5432);
    L[k] = c[k] + __viaddmin_u16x2(__vimin3_u16x2(lo, hi, capm), pen.p1x2, P[k]) - mp2;
    lo = hi;
  }
  return warp_min(L);
}

// A neighbour strip's edge L for the row whose tag is `tag`; returns its minL.
__device__ __forceinline__ int read_edge(const unsigned long long* slot, unsigned tag,
                                         unsigned (&P)[WPL], int w0) {
  Patience wait;
  for (;;) {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
      const unsigned long long w = load_word(slot + w0 + k);
      P[k] = (unsigned)w;
      ok &= (unsigned)(w >> 32) == tag;
    }
    if (__all_sync(FULL, ok)) break;
    __nanosleep(EDGE_NAP_NS);
    wait.tick();
  }
  return warp_min(P);
}

__device__ __forceinline__ void write_edge(unsigned long long* slot, unsigned tag,
                                           const unsigned (&L)[WPL], int w0) {
#pragma unroll
  for (int k = 0; k < WPL; ++k) store_word(slot + w0 + k, (unsigned long long)tag << 32 | L[k]);
}

// A neighbour warp's slot, once its count has reached `need`; returns its minL.
__device__ __forceinline__ int read_slot(const int* count, int need, const unsigned* s,
                                         unsigned (&P)[WPL]) {
  if (load_progress(count) < need) {
    Patience wait;
    do {
      __nanosleep(NAP_NS);
      wait.tick();
    } while (load_progress(count) < need);
  }
  const Pack<unsigned, WPL> v = *(const Pack<unsigned, WPL>*)s;
#pragma unroll
  for (int k = 0; k < WPL; ++k) P[k] = v.e[k];
  return warp_min(P);
}

__device__ __forceinline__ void write_slot(unsigned* s, const unsigned (&L)[WPL]) {
  Pack<unsigned, WPL> v;
#pragma unroll
  for (int k = 0; k < WPL; ++k) v.e[k] = L[k];
  *(Pack<unsigned, WPL>*)s = v;
}

__device__ __forceinline__ void copy(unsigned (&to)[WPL], const unsigned (&from)[WPL]) {
#pragma unroll
  for (int k = 0; k < WPL; ++k) to[k] = from[k];
}

// a lane's costs as they lie in the ring: int16 pairs, every one in [0, 2^15)
__device__ __forceinline__ void load_costs(const char* slot, unsigned (&c)[WPL]) {
  const Pack<unsigned, WPL> v = *(const Pack<unsigned, WPL>*)slot;
#pragma unroll
  for (int k = 0; k < WPL; ++k) c[k] = v.e[k];
}

template <int VPL>
__global__ void __launch_bounds__(SWEEP_WARPS * 32)
sgm_scan_kernel(const int16_t* __restrict__ cost, Sweep s0, Sweep s1, Plan pl, int H, int W,
                int D, int p1, int p2, unsigned seq) {
  static_assert(VPL == SWEEP_VPL, "the sweeps hold 8 disparities a lane");
  extern __shared__ uint4 smem_raw[];
  constexpr int DP = 32 * VPL, DW = 32 * WPL;
  constexpr int SLOT_B = DP * (int)sizeof(int16_t);
  constexpr int CMAX = SWEEP_COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const Sweep sw = blockIdx.y ? s1 : s0;
  uint16_t* const out = (uint16_t*)sw.out;
  const int strip = blockIdx.x, x0 = strip * pl.sw, cols = min(pl.sw, W - x0);
  const bool left = strip > 0, right = strip + 1 < pl.nstrips;
  const int C = pl.cols;                           // columns a warp
  const int c0 = warp * C, cw = min(C, cols - c0);  // the warp's first column, its count
  const int last = (cols - 1) / C;                 // the strip's last warp with columns
  const int d0 = lane * VPL, w0 = lane * WPL;
  const int pad_from = max(0, min(VPL, D - d0));
  const Pen pen = {p1, p2, pair(p1), pair(HALF_MAX - p1)};

  // shared memory: each warp's counts of rows handed on (vertical pass,
  // W->E pass), its slots for its neighbours ([kind][row % 2][DW]: W->E and
  // NW of its last column, NE of its first), its ring
  char* smem = (char*)smem_raw;
  int* vdone = (int*)smem;                         // [SWEEP_WARPS]
  int* edone = vdone + SWEEP_WARPS;                // [SWEEP_WARPS]
  unsigned* xs = (unsigned*)(smem + COUNTS_B);     // [nw][KINDS][2][DW]
  auto xslot = [&](int w, int kind, int r) {
    return xs + (((size_t)w * KINDS + kind) * 2 + (r & 1)) * DW + w0;
  };
  char* const ring = (char*)(xs + (size_t)nw * KINDS * 2 * DW) +
                     (size_t)warp * NSTAGE * C * SLOT_B;
  unsigned long long* const edges =
      pl.edges + (size_t)blockIdx.y * pl.nstrips * KINDS * RING_ROWS * DW;
  auto slot = [&](int s, int kind, int r) {
    return edges + (((size_t)s * KINDS + kind) * RING_ROWS + r % RING_ROWS) * DW;
  };

  if (threadIdx.x < 2 * SWEEP_WARPS) vdone[threadIdx.x] = 0;
  __syncthreads();
  if (warp > last) return;

  // the sweep's pixel (r, x0 + x) starts at cost index base + r * rstep + x * xstep
  const long long xstep = sw.mirror ? -(long long)D : (long long)D;
  const long long rstep = xstep * W;
  const long long base =
      (sw.mirror ? ((long long)H * W - 1 - x0) * D : (long long)x0 * D) + c0 * xstep;
  // a stage of the ring is a row of the warp's cw pixels, its copies shared
  // among the lanes: lane (lg, lc) takes piece lc of pixels lg, lg + ppi, ...
  const int nc = pl.cpb ? D * (int)sizeof(int16_t) / pl.cpb : 0;   // pieces a pixel
  const int ppi = nc && nc < 32 ? 32 / nc : 1;
  const int lg = nc && nc < 32 ? lane / nc : 0, lc = lane - lg * nc;
  auto fetch_copies = [&](int r, auto bytes) {
    constexpr int CPB = decltype(bytes)::value;
    char* stage = ring + (size_t)(r % NSTAGE) * C * SLOT_B;
    if (lg < ppi) {
      for (int g = lg; g < cw; g += ppi) {
        const char* src = (const char*)(cost + base + r * rstep + g * xstep);
        for (int c = lc; c < nc; c += 32)
          cp_async<CPB>(stage + g * SLOT_B + c * CPB, src + c * CPB);
      }
    }
  };
  auto fetch = [&](int r) {                  // row r of the warp's pixels into the ring
    if (pl.cpb == 16) {
      fetch_copies(r, std::integral_constant<int, 16>{});
    } else if (pl.cpb == 8) {
      fetch_copies(r, std::integral_constant<int, 8>{});
    } else if (pl.cpb == 4) {
      fetch_copies(r, std::integral_constant<int, 4>{});
    } else {                       // nothing divides a pixel: plain loads
      char* stage = ring + (size_t)(r % NSTAGE) * C * SLOT_B;
      for (int g = 0; g < cw; ++g) {
        const int16_t* src = cost + base + r * rstep + g * xstep;
        for (int c = lane; c < D; c += 32) ((int16_t*)(stage + g * SLOT_B))[c] = src[c];
      }
    }
  };
  // the ring's costs at d >= D hold 2^16 - 1 - P2 for good (the copies
  // write a pixel's D costs only): a step leaves such a half in
  // [2^16 - 1 - P2, 2^16 - 1], above every L and without a carry
  for (int s = 0; s < NSTAGE * C && pad_from < VPL; ++s)
    for (int j = pad_from; j < VPL; ++j)
      ((uint16_t*)(ring + (size_t)s * SLOT_B))[d0 + j] = (uint16_t)(HALF_MAX - p2);
  for (int r = 0; r < NSTAGE - 1; ++r) {
    if (r < H) fetch(r);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the row above's states of the warp's columns; Sne one longer, for the
  // state that enters from the right
  unsigned Sn[CMAX][WPL], Snw[CMAX][WPL], Sne[CMAX + 1][WPL];
  int mSn[CMAX], mSnw[CMAX], mSne[CMAX + 1];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    mSn[c] = zero(Sn[c], pad_from, pen.big2);
    mSnw[c] = zero(Snw[c], pad_from, pen.big2);
    mSne[c] = zero(Sne[c], pad_from, pen.big2);
  }

  for (int r = 0; r < H; ++r) {
    const unsigned tag = seq + (unsigned)r + 1u;
    __syncwarp();                            // every lane has read stage r - 1: refill it
    if (r + NSTAGE - 1 < H) fetch(r + NSTAGE - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1) : "memory");
    __syncwarp();                            // row r has arrived, for every lane's copies
    const char* stage = ring + (size_t)(r % NSTAGE) * C * SLOT_B + d0 * sizeof(int16_t);
    uint16_t* const orow = out + base + r * rstep + d0;

    // the vertical pass: NW(r-1) enters from the left, NE(r-1) from the right
    unsigned Pnw[WPL];
    int mpnw;
    {
      unsigned Pin[WPL];
      int mpin;
      if (r == 0) {
        mpnw = zero(Pnw, pad_from, pen.big2);
        mpin = zero(Pin, pad_from, pen.big2);
      } else {
        if (warp > 0)
          mpnw = read_slot(&vdone[warp - 1], r, xslot(warp - 1, K_NW, r - 1), Pnw);
        else if (left)
          mpnw = read_edge(slot(strip - 1, K_NW, r - 1), tag - 1, Pnw, w0);
        else
          mpnw = zero(Pnw, pad_from, pen.big2);
        if (warp < last)
          mpin = read_slot(&vdone[warp + 1], r, xslot(warp + 1, K_NE, r - 1), Pin);
        else if (right)
          mpin = read_edge(slot(strip + 1, K_NE, r - 1), tag - 1, Pin, w0);
        else
          mpin = zero(Pin, pad_from, pen.big2);
      }
#pragma unroll
      for (int c = 1; c <= CMAX; ++c)
        if (c == cw) {
          copy(Sne[c], Pin);
          mSne[c] = mpin;
        }
    }
    unsigned sum[CMAX][WPL];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < cw) {
        unsigned cv[WPL], Ln[WPL], Lnw[WPL], Lne[WPL];
        load_costs(stage + c * SLOT_B, cv);
        const int mn = dp(Sn[c], mSn[c], cv, Ln, pen, lane);
        const int mnw = dp(Pnw, mpnw, cv, Lnw, pen, lane);
        const int mne = dp(Sne[c + 1], mSne[c + 1], cv, Lne, pen, lane);
        copy(Pnw, Snw[c]);                   // the old NW at c: the next column's predecessor
        mpnw = mSnw[c];
        copy(Sn[c], Ln);
        mSn[c] = mn;
        copy(Snw[c], Lnw);
        mSnw[c] = mnw;
        copy(Sne[c], Lne);
        mSne[c] = mne;
#pragma unroll
        for (int k = 0; k < WPL; ++k)
          sum[c][k] = sw.dirs == ALL ? Ln[k] + Lnw[k] + Lne[k]
                                     : (sw.dirs & NN ? Ln[k] : 0u) + (sw.dirs & NW ? Lnw[k] : 0u) +
                                           (sw.dirs & NE ? Lne[k] : 0u);
      }
    }
    // hand on NE(r) of the first column and NW(r) of the last
    if (warp > 0)
      write_slot(xslot(warp, K_NE, r), Sne[0]);
    else if (left)
      write_edge(slot(strip, K_NE, r), tag, Sne[0], w0);
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c == cw - 1) {
        if (warp < last)
          write_slot(xslot(warp, K_NW, r), Snw[c]);
        else if (right)
          write_edge(slot(strip, K_NW, r), tag, Snw[c], w0);
      }
    __syncwarp();                            // every lane's slots are written
    if (lane == 0) store_progress(&vdone[warp], r + 1);

    // the W->E pass, once the chain reaches the warp's first column
    unsigned Pwe[WPL];
    int mwe;
    if (warp > 0)
      mwe = read_slot(&edone[warp - 1], r + 1, xslot(warp - 1, K_WE, r), Pwe);
    else if (left)
      mwe = read_edge(slot(strip - 1, K_WE, r), tag, Pwe, w0);
    else
      mwe = zero(Pwe, pad_from, pen.big2);
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < cw) {
        unsigned cv[WPL], Lwe[WPL];
        load_costs(stage + c * SLOT_B, cv);
        mwe = dp(Pwe, mwe, cv, Lwe, pen, lane);
        copy(Pwe, Lwe);
        uint16_t* const o = orow + c * xstep;
        if (sw.dirs & WE) {
#pragma unroll
          for (int k = 0; k < WPL; ++k) sum[c][k] += Lwe[k];
        }
        if (pl.vec_ok) {                     // D % VPL == 0: a lane is all in or all out
          if (pad_from == VPL) {
            Pack<unsigned, WPL> res;
#pragma unroll
            for (int k = 0; k < WPL; ++k) res.e[k] = sum[c][k];
            *(Pack<unsigned, WPL>*)o = res;
          }
        } else {
#pragma unroll
          for (int j = 0; j < VPL; ++j)
            if (j < pad_from) o[j] = (uint16_t)(sum[c][j / 2] >> (16 * (j & 1)));
        }
      }
    }
    // hand on W->E(r) of the last column
    if (warp < last)
      write_slot(xslot(warp, K_WE, r), Pwe);
    else if (right)
      write_edge(slot(strip, K_WE, r), tag, Pwe, w0);
    __syncwarp();
    if (lane == 0) store_progress(&edone[warp], r + 1);
  }
}

using SweepKernel = void (*)(const int16_t*, Sweep, Sweep, Plan, int, int, int, int, int,
                             unsigned);

int sweep_copy_bytes(size_t pixel_bytes, const void* cost) {
  for (int cpb = 16; cpb >= 4; cpb /= 2)
    if (pixel_bytes % cpb == 0 && (uintptr_t)cost % cpb == 0) return cpb;
  return 0;
}

// The launch's shape: a strip a block, as many as half the card's SMs (one
// block an SM for each of the two sweeps); a warp for about a quarter of a
// strip's columns, at most SWEEP_COLS; where that needs more than
// SWEEP_WARPS warps, strips of SWEEP_WARPS warps, and more of them.
cudaError_t sweep_plan(int W, long long* plan) {
  constexpr int DW = 32 * WPL;
  constexpr int SLOT_B = 32 * SWEEP_VPL * (int)sizeof(int16_t);
  int dev, sms, smem_block;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  SweepKernel kernel = sgm_scan_kernel<SWEEP_VPL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_block);
  if (err != cudaSuccess) return err;
  int ns = sms / 2;
  ns = ns < 1 ? 1 : ns > W ? W : ns;
  int sw = (W + ns - 1) / ns;
  int c = (sw + 3) / 4;
  c = c < 1 ? 1 : c > SWEEP_COLS ? SWEEP_COLS : c;
  if ((sw + c - 1) / c > SWEEP_WARPS) sw = SWEEP_WARPS * c;
  ns = (W + sw - 1) / sw;
  const int warps = (sw + c - 1) / c;
  const size_t smem = COUNTS_B + (size_t)warps * KINDS * 2 * DW * sizeof(unsigned) +
                      (size_t)warps * NSTAGE * c * SLOT_B;
  if (smem > (size_t)smem_block) return cudaErrorInvalidConfiguration;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, warps * 32, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1 || 2LL * ns > (long long)sms * occ) return cudaErrorInvalidConfiguration;
  plan[P_NSTRIPS] = ns;
  plan[P_SW] = sw;
  plan[P_WARPS] = warps;
  plan[P_COLS] = c;
  plan[P_SMEM] = (long long)smem;
  plan[P_BLOCKS] = occ;
  plan[P_EDGE_BYTES] = 2LL * ns * KINDS * RING_ROWS * DW * sizeof(unsigned long long);
  plan[P_SMS] = sms;
  return cudaSuccess;
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

// The shape of the sweeps' launch over an int16 cost W pixels wide with D
// disparities (SWEEP_MIN_D <= D <= SWEEP_MAX_D): the plan's P_LEN fields
// (strips, their width, warps a block, columns a warp, shared memory a
// block, blocks an SM the card holds, bytes of edge slots, SMs), on the
// current device. Refused (cudaErrorInvalidConfiguration) where the card
// cannot hold every block at once.
extern "C" int psm_sgm_sweep_plan(int W, int D, long long* plan) {
  if (W <= 0 || D < SWEEP_MIN_D || D > SWEEP_MAX_D) return (int)cudaErrorInvalidValue;
  return (int)sweep_plan(W, plan);
}

// One launch of both sweeps over an int16 cost: the top-down one into
// out_top, the bottom-up one into out_bottom, another tensor, each summing
// the directions of its bits (W->E 1, NW 2, N 4, NE 8, sweep-local); the
// sums uint16. `plan` comes from psm_sgm_sweep_plan with the same W and D;
// `scratch` holds its edge bytes, zeroed once when allocated; `seq` is
// above every tag the scratch has held: the slots of row r carry
// seq + r + 1. The caller holds every value of a step in 16 bits
// (kernels/sgbm_scan.py::halves_hold): P1, P2 >= 0, and a group's sum,
// cost_bound + 2 P2 and cost_bound + P2 + min(P1, P2) below 2^16 - 1.
extern "C" int psm_sgm_sweep(const void* cost, void* out_top, int dirs_top, void* out_bottom,
                             int dirs_bottom, int H, int W, int D, int p1, int p2,
                             const long long* plan, void* scratch, unsigned seq, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  if (!out_top || !out_bottom || out_top == out_bottom || D < SWEEP_MIN_D || D > SWEEP_MAX_D ||
      p1 < 0 || p2 < 0)
    return (int)cudaErrorInvalidValue;
  // a P1 above P2 never wins (the source note): the step takes P2 for it
  if (p1 > p2) p1 = p2;
  const Sweep s0 = {out_top, 0, dirs_top}, s1 = {out_bottom, 1, dirs_bottom};
  constexpr int VEC_B = 16;
  Plan pl;
  pl.nstrips = (int)plan[P_NSTRIPS];
  pl.sw = (int)plan[P_SW];
  pl.cols = (int)plan[P_COLS];
  pl.cpb = sweep_copy_bytes(D * sizeof(int16_t), cost);
  pl.vec_ok = D % SWEEP_VPL == 0 && (uintptr_t)out_top % VEC_B == 0 &&
              (uintptr_t)out_bottom % VEC_B == 0;
  pl.edges = (unsigned long long*)scratch;
  if (pl.cols < 1 || pl.cols > SWEEP_COLS || plan[P_WARPS] > SWEEP_WARPS ||
      (long long)pl.nstrips * pl.sw < W)
    return (int)cudaErrorInvalidValue;
  SweepKernel kernel = sgm_scan_kernel<SWEEP_VPL>;
  const int smem = (int)plan[P_SMEM];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int16_t* c = (const int16_t*)cost;
  void* args[] = {(void*)&c, (void*)&s0, (void*)&s1, &pl, &H, &W, &D, &p1, &p2, &seq};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(pl.nstrips, 2),
                                          dim3((int)plan[P_WARPS] * 32), args, smem,
                                          (cudaStream_t)stream);
}
