// K6: Birchfield-Tomasi pixel cost and k x k window sum (SGBM cost), one
// launch.
//
// Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_bt_cost_kernel
// (launcher bt_block_cost_pallas). For disparity d, left pixel (y, x) is
// compared with right pixel (y, max(x - d, 0)): columns x - d < 0 read
// right column 0. Per channel, with f the feature, f_lo/f_hi its half-way
// values to the left/right neighbour (floor division, edges replicated)
// and f_min/f_max the min/max of the three:
//   BT = min(max(l - r_max, r_min - l, 0), max(r - l_max, l_min - r, 0)),
// summed over the channels, then summed over a k x k window of the
// pixel-cost plane of that d with replicated borders (clamped rows and
// columns of the cost plane, not of the features).
//
// What bounds it: ~10 integer operations per channel and (y, x, d) for the
// pixel cost, against 2 bytes written per (y, x, d): operations. What the
// design does about that:
//   * A block owns a strip of `sr` output rows, TX = NCOL - (k - 1) output
//     columns and DC disparities, and walks down its strip's k - 1 halo
//     rows and output rows one input row at a time. No scratch volume:
//     every output is written once.
//   * Per input row it stages in shared memory, once, the (f, f_min, f_max)
//     of every channel for its NCOL cost-plane columns (the left view) and
//     for the NCOL + DC - 1 right columns those (x, d) pairs read, each
//     entry already clamped at column 0: a right interpolant is computed
//     once for every (x, d) with the same x - d, a left one once for all
//     DC disparities. The next row is staged while the current one is
//     summed (two buffers, two barriers a row).
//   * Pixel costs: a thread owns one cost-plane column and DC / 4
//     disparities; its left values stay in registers and its right reads
//     are immediate offsets from one pointer. Each pixel cost is computed
//     once per input row (NCOL / TX and (sr + k - 1) / sr recompute at the
//     tile's halo).
//   * Window sum: a thread owns one disparity and a run of output columns;
//     the horizontal k-sum slides along the run (two shared-memory loads an
//     output), the vertical one is a running sum in registers down the
//     strip with a ring of the last k horizontal sums in shared memory
//     (private to the thread: no bank conflicts, no barrier). Outputs are
//     written along d, coalesced, in the (H, W, D) layout K7 reads.
// Integer sums are exact, and modular in int16 (the ring stores the output
// type), so the result equals the plain version's bit for bit for every
// input and any order of summation.
//
// The TPU kernel's int8 feature stacks and lane rolls do not carry over;
// features stay int32 here and any channel count, feature range and cost
// bound is taken; k up to NCOL.
//
// Layout: features (H, W, C) int32, out (H, W, D) int16 or int32.
// Grid (ceil(W / TX), ceil(D / DC), ceil(H / sr)); kernels/bt_cost.py::plan
// mirrors the shared-memory arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCOL = 64;   // cost-plane columns a block computes per row (TX + k - 1)
constexpr int NT = 256;
constexpr int NGA = NT / NCOL;   // disparity groups of the pixel-cost step

__device__ __forceinline__ int clampi(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// Ints of the shared-memory arrays before the ring: the pixel costs of one
// row (NCOL x (DC + 1), padded against bank conflicts) and two staging
// buffers of 3 x C x (NCOL + RS) values.
template <int DC>
__host__ __device__ inline size_t head_ints(int C) {
  return (size_t)NCOL * (DC + 1) + 2 * 3 * (size_t)C * (NCOL + NCOL + DC);
}

template <typename OT, int DC>
__global__ void __launch_bounds__(NT, 3)
bt_cost_kernel(const int* __restrict__ lf, const int* __restrict__ rf, OT* __restrict__ out,
               int H, int W, int C, int D, int k, int sr) {
  constexpr int ND = DC / NGA;     // disparities a thread of the pixel-cost step
  constexpr int NG = NT / DC;      // column runs of the window-sum step
  constexpr int NXM = NCOL / NG;   // the longest run
  constexpr int RS = NCOL + DC;    // staged right columns (NCOL + DC - 1 used)
  constexpr int PLANE = NCOL + RS; // a staged plane: left columns, then right ones
  extern __shared__ __align__(16) int smem[];
  int* pc = smem;                                   // [NCOL][DC + 1]
  int* stage = pc + NCOL * (DC + 1);                // [2][3][C][PLANE]
  OT* ring = (OT*)(smem + head_ints<DC>(C));        // [k][NX][NT]

  const int tid = threadIdx.x;
  const int lo = k / 2;
  const int TX = NCOL - (k - 1);
  const int NX = (TX + NG - 1) / NG;
  const int x0 = blockIdx.x * TX, d0 = blockIdx.y * DC, y0 = blockIdx.z * sr;
  const int nt = min(sr, H - y0) + k - 1;           // input rows of the strip
  // cost-plane column s of the block is image column clamp(x0 - lo + s);
  // staged right entry q is image column max(rbase + q, 0)
  const int xlo = clampi(x0 - lo, W), xhi = clampi(x0 - lo + NCOL - 1, W);
  const int rbase = xlo - (d0 + DC - 1);
  const int nr = xhi - xlo + DC;

  auto stage_row = [&](int t, int b) {
    const int yy = clampi(y0 - lo + t, H);
    int* sb = stage + b * 3 * C * PLANE;
    const int n = (NCOL + nr) * C;
    for (int i = tid; i < n; i += NT) {
      const int e = i / C, c = i - e * C;
      const int* row = (e < NCOL ? lf : rf) + (size_t)yy * W * C;
      const int x = e < NCOL ? clampi(x0 - lo + e, W) : max(rbase + e - NCOL, 0);
      const int v = row[x * C + c];
      const int a = (v + row[max(x - 1, 0) * C + c]) >> 1;   // floor division by 2
      const int z = (v + row[min(x + 1, W - 1) * C + c]) >> 1;
      sb[c * PLANE + e] = v;
      sb[(C + c) * PLANE + e] = min(min(a, z), v);
      sb[(2 * C + c) * PLANE + e] = max(max(a, z), v);
    }
  };

  // the pixel-cost step's column and disparities
  const int s = tid % NCOL, g = tid / NCOL;
  const int xs = clampi(x0 - lo + s, W);
  const int rq = NCOL + xs - (d0 + g * ND) - rbase;   // right entry of disparity j: rq - j
  // the window-sum step's disparity and run of output columns
  const int dl = tid % DC, i0 = (tid / DC) * NX;
  const int d = d0 + dl;
  int vacc[NXM];
#pragma unroll
  for (int j = 0; j < NXM; ++j) vacc[j] = 0;

  stage_row(0, 0);
  __syncthreads();
  int slot = 0;
  for (int t = 0; t < nt; ++t) {
    {
      const int* sb = stage + (t & 1) * 3 * C * PLANE;
      int acc[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] = 0;
      for (int c = 0; c < C; ++c) {
        const int* f = sb + c * PLANE;
        const int* fmn = f + C * PLANE;
        const int* fmx = fmn + C * PLANE;
        const int l = f[s], lmn = fmn[s], lmx = fmx[s];
        const int* rf_ = f + rq;
        const int* rmn_ = fmn + rq;
        const int* rmx_ = fmx + rq;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int r = rf_[-j], rmn = rmn_[-j], rmx = rmx_[-j];
          const int c1 = max(max(l - rmx, rmn - l), 0);
          const int c2 = max(max(r - lmx, lmn - r), 0);
          acc[j] += min(c1, c2);
        }
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) pc[s * (DC + 1) + g * ND + j] = acc[j];
    }
    __syncthreads();   // the row's pixel costs are whole; its staging buffer is free
    if (t + 1 < nt) stage_row(t + 1, (t + 1) & 1);

    if (i0 < TX) {
      const int* col = pc + dl;
      int h = 0;
      for (int i = 0; i < k; ++i) h += col[(i0 + i) * (DC + 1)];
      OT* rg = ring + (size_t)slot * NX * NT + tid;
      const int y = y0 + t - (k - 1);
      const bool emit = t >= k - 1 && d < D;
#pragma unroll
      for (int j = 0; j < NXM; ++j) {
        if (j >= NX || i0 + j >= TX) break;
        if (j) h += col[(i0 + j + k - 1) * (DC + 1)] - col[(i0 + j - 1) * (DC + 1)];
        const int old = rg[j * NT];
        rg[j * NT] = (OT)h;
        vacc[j] += h - (t >= k ? old : 0);
        const int x = x0 + i0 + j;
        if (emit && x < W) out[((size_t)y * W + x) * D + d] = (OT)vacc[j];
      }
    }
    if (++slot == k) slot = 0;
    __syncthreads();   // pc may be refilled; the next row's staging has landed
  }
}

template <typename OT, int DC>
size_t smem_bytes(int C, int k) {
  const int TX = NCOL - (k - 1);
  const int NX = (TX + NT / DC - 1) / (NT / DC);
  return sizeof(int) * head_ints<DC>(C) + sizeof(OT) * (size_t)k * NX * NT;
}

template <typename OT, int DC>
int run(const int* lf, const int* rf, OT* out, int H, int W, int C, int D, int k, int sr,
        cudaStream_t s) {
  const size_t smem = smem_bytes<OT, DC>(C, k);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit) return -1;
  err = cudaFuncSetAttribute(bt_cost_kernel<OT, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int TX = NCOL - (k - 1);
  const dim3 grid((W + TX - 1) / TX, (D + DC - 1) / DC, (H + sr - 1) / sr);
  bt_cost_kernel<OT, DC><<<grid, NT, smem, s>>>(lf, rf, out, H, W, C, D, k, sr);
  return (int)cudaGetLastError();
}

template <typename OT>
int run_dc(const int* lf, const int* rf, OT* out, int H, int W, int C, int D, int k, int sr,
           int dc, cudaStream_t s) {
  if (dc == 64) return run<OT, 64>(lf, rf, out, H, W, C, D, k, sr, s);
  if (dc == 32) return run<OT, 32>(lf, rf, out, H, W, C, D, k, sr, s);
  return -1;
}

}  // namespace

// One launch into `out` ((H, W, D), int16 when out_is_int16 else int32):
// strips of `sr` rows, `dc` (32 or 64) disparities a block
// (kernels/bt_cost.py::plan). Returns -1, launching nothing, for a k
// beyond NCOL, a dc it has no instance for, or a block beyond the card's
// shared memory.
extern "C" int psm_bt_cost(const int* lf, const int* rf, void* out, int out_is_int16, int H,
                           int W, int C, int D, int k, int sr, int dc, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0) return (int)cudaSuccess;
  if (k < 1 || k > NCOL || sr < 1 || C < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return out_is_int16 ? run_dc(lf, rf, (int16_t*)out, H, W, C, D, k, sr, dc, s)
                      : run_dc(lf, rf, (int32_t*)out, H, W, C, D, k, sr, dc, s);
}
