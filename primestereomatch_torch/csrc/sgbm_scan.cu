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
//     columns, lanes over d as above (VPL = 8); the N, NW and NE states of
//     its columns stay in the warp's registers from one row to the next.
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
//     memory: slots of 64-bit words, each an L and the 32-bit tag of its
//     row (a sequence the wrapper advances every launch, plus the row),
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
// the disparities the sweeps take (kernels/sgbm_scan.py's rule): VPL = 8
constexpr int SWEEP_VPL = 8, SWEEP_MIN_D = 129, SWEEP_MAX_D = 256;
// the plan's fields (int64 each), shared with kernels/sgbm_scan.py
enum { P_NSTRIPS, P_SW, P_WARPS, P_COLS, P_SMEM, P_BLOCKS, P_EDGE_BYTES, P_SMS, P_LEN };

// the most columns a warp holds: their three states and sums in registers
constexpr int SWEEP_COLS = 3;

struct Sweep {
  void* out;       // (H, W, D) uint16 sums of the sweep's directions
  int mirror;      // walk bottom-up and E->W
  int dirs;        // the directions summed (WE, NW, NN, NE)
};

struct Plan {
  int nstrips, sw, cols, cpb, vec_ok;
  unsigned long long* edges;   // [sweep][strip][KINDS][RING_ROWS][32 * SWEEP_VPL]
};

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

// The state before a path's first pixel: L = 0 (BIG for d >= D), minL 0.
template <int VPL>
__device__ __forceinline__ int zero(int (&P)[VPL], int pad_from) {
#pragma unroll
  for (int j = 0; j < VPL; ++j) P[j] = j < pad_from ? 0 : BIG;
  return 0;
}

template <int VPL>
__device__ __forceinline__ int warp_min(const int (&P)[VPL]) {
  int mn = P[0];
#pragma unroll
  for (int j = 1; j < VPL; ++j) mn = min(mn, P[j]);
  return __reduce_min_sync(FULL, mn);
}

// One step of a direction: predecessor P (its minL mp), costs c -> L; returns minL.
template <int VPL>
__device__ __forceinline__ int dp(const int (&P)[VPL], int mp, const int (&c)[VPL],
                                  int (&L)[VPL], int p1, int p2, int lane, int pad_from) {
  int below = __shfl_up_sync(FULL, P[VPL - 1], 1);   // P[d0 - 1]
  int above = __shfl_down_sync(FULL, P[0], 1);       // P[d0 + VPL]
  if (lane == 0) below = BIG;
  if (lane == 31) above = BIG;
  const int cap = mp + p2;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int lo = j > 0 ? P[j - 1] : below;
    const int hi = j < VPL - 1 ? P[j + 1] : above;
    // min(P, min(lo, hi) + p1, cap) as min(min(lo, hi, cap - p1) + p1, P),
    // two of Hopper's DPX instructions (4% of a 2K launch against four mins)
    L[j] = c[j] + __viaddmin_s32(__vimin3_s32(lo, hi, cap - p1), p1, P[j]) - mp;
  }
  if (pad_from < VPL) {            // the lane holds d >= D
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (j >= pad_from) L[j] = BIG;
  }
  return warp_min(L);
}

// A neighbour strip's edge L for the row whose tag is `tag`; returns its minL.
template <int VPL>
__device__ __forceinline__ int read_edge(const unsigned long long* slot, unsigned tag,
                                         int (&P)[VPL], int d0) {
  Patience wait;
  for (;;) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const unsigned long long w = load_word(slot + d0 + j);
      P[j] = (int)(unsigned)w;
      ok &= (unsigned)(w >> 32) == tag;
    }
    if (__all_sync(FULL, ok)) break;
    __nanosleep(EDGE_NAP_NS);
    wait.tick();
  }
  return warp_min(P);
}

template <int VPL>
__device__ __forceinline__ void write_edge(unsigned long long* slot, unsigned tag,
                                           const int (&L)[VPL], int d0) {
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    store_word(slot + d0 + j, (unsigned long long)tag << 32 | (unsigned)L[j]);
}

// A neighbour warp's slot, once its count has reached `need`; returns its minL.
template <int VPL>
__device__ __forceinline__ int read_slot(const int* count, int need, const int* s,
                                         int (&P)[VPL]) {
  if (load_progress(count) < need) {
    Patience wait;
    do {
      __nanosleep(NAP_NS);
      wait.tick();
    } while (load_progress(count) < need);
  }
  const Pack<int, VPL> v = *(const Pack<int, VPL>*)s;
#pragma unroll
  for (int j = 0; j < VPL; ++j) P[j] = v.e[j];
  return warp_min(P);
}

template <int VPL>
__device__ __forceinline__ void write_slot(int* s, const int (&L)[VPL]) {
  Pack<int, VPL> v;
#pragma unroll
  for (int j = 0; j < VPL; ++j) v.e[j] = L[j];
  *(Pack<int, VPL>*)s = v;
}

template <int VPL>
__device__ __forceinline__ void copy(int (&to)[VPL], const int (&from)[VPL]) {
#pragma unroll
  for (int j = 0; j < VPL; ++j) to[j] = from[j];
}

template <int VPL>
__device__ __forceinline__ void load_costs(const char* slot, int (&c)[VPL]) {
  const Pack<int16_t, VPL> v = *(const Pack<int16_t, VPL>*)slot;
#pragma unroll
  for (int j = 0; j < VPL; ++j) c[j] = (int)v.e[j];
}

template <int VPL>
__global__ void __launch_bounds__(SWEEP_WARPS * 32)
sgm_scan_kernel(const int16_t* __restrict__ cost, Sweep s0, Sweep s1, Plan pl, int H, int W,
                int D, int p1, int p2, unsigned seq) {
  extern __shared__ uint4 smem_raw[];
  constexpr int DP = 32 * VPL;
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
  const int d0 = lane * VPL;
  const int pad_from = max(0, min(VPL, D - d0));

  // shared memory: each warp's counts of rows handed on (vertical pass,
  // W->E pass), its slots for its neighbours ([kind][row % 2][DP]: W->E and
  // NW of its last column, NE of its first), its ring
  char* smem = (char*)smem_raw;
  int* vdone = (int*)smem;                         // [SWEEP_WARPS]
  int* edone = vdone + SWEEP_WARPS;                // [SWEEP_WARPS]
  int* xs = edone + SWEEP_WARPS;                   // [nw][KINDS][2][DP]
  auto xslot = [&](int w, int kind, int r) {
    return xs + (((size_t)w * KINDS + kind) * 2 + (r & 1)) * DP + d0;
  };
  char* const ring = (char*)(xs + (size_t)nw * KINDS * 2 * DP) +
                     (size_t)warp * NSTAGE * C * SLOT_B;
  unsigned long long* const edges =
      pl.edges + (size_t)blockIdx.y * pl.nstrips * KINDS * RING_ROWS * DP;
  auto slot = [&](int s, int kind, int r) {
    return edges + (((size_t)s * KINDS + kind) * RING_ROWS + r % RING_ROWS) * DP;
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
  for (int r = 0; r < NSTAGE - 1; ++r) {
    if (r < H) fetch(r);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the row above's states of the warp's columns; Sne one longer, for the
  // state that enters from the right
  int Sn[CMAX][VPL], Snw[CMAX][VPL], Sne[CMAX + 1][VPL];
  int mSn[CMAX], mSnw[CMAX], mSne[CMAX + 1];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    mSn[c] = zero(Sn[c], pad_from);
    mSnw[c] = zero(Snw[c], pad_from);
    mSne[c] = zero(Sne[c], pad_from);
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
    int Pnw[VPL], mpnw;
    {
      int Pin[VPL], mpin;
      if (r == 0) {
        mpnw = zero(Pnw, pad_from);
        mpin = zero(Pin, pad_from);
      } else {
        if (warp > 0)
          mpnw = read_slot(&vdone[warp - 1], r, xslot(warp - 1, K_NW, r - 1), Pnw);
        else if (left)
          mpnw = read_edge(slot(strip - 1, K_NW, r - 1), tag - 1, Pnw, d0);
        else
          mpnw = zero(Pnw, pad_from);
        if (warp < last)
          mpin = read_slot(&vdone[warp + 1], r, xslot(warp + 1, K_NE, r - 1), Pin);
        else if (right)
          mpin = read_edge(slot(strip + 1, K_NE, r - 1), tag - 1, Pin, d0);
        else
          mpin = zero(Pin, pad_from);
      }
#pragma unroll
      for (int c = 1; c <= CMAX; ++c)
        if (c == cw) {
          copy(Sne[c], Pin);
          mSne[c] = mpin;
        }
    }
    int sum[CMAX][VPL];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < cw) {
        int cv[VPL], Ln[VPL], Lnw[VPL], Lne[VPL];
        load_costs(stage + c * SLOT_B, cv);
        const int mn = dp(Sn[c], mSn[c], cv, Ln, p1, p2, lane, pad_from);
        const int mnw = dp(Pnw, mpnw, cv, Lnw, p1, p2, lane, pad_from);
        const int mne = dp(Sne[c + 1], mSne[c + 1], cv, Lne, p1, p2, lane, pad_from);
        copy(Pnw, Snw[c]);                   // the old NW at c: the next column's predecessor
        mpnw = mSnw[c];
        copy(Sn[c], Ln);
        mSn[c] = mn;
        copy(Snw[c], Lnw);
        mSnw[c] = mnw;
        copy(Sne[c], Lne);
        mSne[c] = mne;
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          sum[c][j] = sw.dirs == ALL ? Ln[j] + Lnw[j] + Lne[j]
                                     : (sw.dirs & NN ? Ln[j] : 0) + (sw.dirs & NW ? Lnw[j] : 0) +
                                           (sw.dirs & NE ? Lne[j] : 0);
      }
    }
    // hand on NE(r) of the first column and NW(r) of the last
    if (warp > 0)
      write_slot(xslot(warp, K_NE, r), Sne[0]);
    else if (left)
      write_edge(slot(strip, K_NE, r), tag, Sne[0], d0);
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c == cw - 1) {
        if (warp < last)
          write_slot(xslot(warp, K_NW, r), Snw[c]);
        else if (right)
          write_edge(slot(strip, K_NW, r), tag, Snw[c], d0);
      }
    __syncwarp();                            // every lane's slots are written
    if (lane == 0) store_progress(&vdone[warp], r + 1);

    // the W->E pass, once the chain reaches the warp's first column
    int Pwe[VPL], mwe;
    if (warp > 0)
      mwe = read_slot(&edone[warp - 1], r + 1, xslot(warp - 1, K_WE, r), Pwe);
    else if (left)
      mwe = read_edge(slot(strip - 1, K_WE, r), tag, Pwe, d0);
    else
      mwe = zero(Pwe, pad_from);
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < cw) {
        int cv[VPL], Lwe[VPL];
        load_costs(stage + c * SLOT_B, cv);
        mwe = dp(Pwe, mwe, cv, Lwe, p1, p2, lane, pad_from);
        copy(Pwe, Lwe);
        uint16_t* const o = orow + c * xstep;
        if (sw.dirs & WE) {
#pragma unroll
          for (int j = 0; j < VPL; ++j) sum[c][j] += Lwe[j];
        }
        if (pl.vec_ok) {                     // D % VPL == 0: a lane is all in or all out
          if (pad_from == VPL) {
            Pack<uint16_t, VPL> res;
#pragma unroll
            for (int j = 0; j < VPL; ++j) res.e[j] = (uint16_t)sum[c][j];
            *(Pack<uint16_t, VPL>*)o = res;
          }
        } else {
#pragma unroll
          for (int j = 0; j < VPL; ++j)
            if (j < pad_from) o[j] = (uint16_t)sum[c][j];
        }
      }
    }
    // hand on W->E(r) of the last column
    if (warp < last)
      write_slot(xslot(warp, K_WE, r), Pwe);
    else if (right)
      write_edge(slot(strip, K_WE, r), tag, Pwe, d0);
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
  constexpr int DP = 32 * SWEEP_VPL;
  constexpr int SLOT_B = DP * (int)sizeof(int16_t);
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
  const size_t smem = 2 * SWEEP_WARPS * sizeof(int) +
                      (size_t)warps * KINDS * 2 * DP * sizeof(int) +
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
  plan[P_EDGE_BYTES] = 2LL * ns * KINDS * RING_ROWS * DP * 8;
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
// seq + r + 1.
extern "C" int psm_sgm_sweep(const void* cost, void* out_top, int dirs_top, void* out_bottom,
                             int dirs_bottom, int H, int W, int D, int p1, int p2,
                             const long long* plan, void* scratch, unsigned seq, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  if (!out_top || !out_bottom || out_top == out_bottom || D < SWEEP_MIN_D || D > SWEEP_MAX_D)
    return (int)cudaErrorInvalidValue;
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
