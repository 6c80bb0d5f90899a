// K9: the speckle filter's sweep, for Hopper.
//
// Replaces primestereomatch_tpu/kernels/speckle_pallas.py::_segmin_kernel
// (launcher segmin_sweep_pallas) and the hook step around it in the JAX
// package's ops/sgbm.py::filter_speckles. One sweep of min-label
// propagation is
//   1. the hook: each label takes the min over itself and the up, down,
//      left and right neighbours it is linked to;
//   2. the segmented min scan along each row, forward and backward, over
//      the runs of left links;
//   3. the same along each column over the up links.
// A forward and backward segmented min scan, min'ed, give every element
// the min over its run (the maximal stretch of the line joined by links),
// so each pass stores the run min.
//
// What bounds it: 9 bytes of device memory per pixel (label in, link mask
// in, label out) against ~20 integer operations: bytes. But a line is a
// chain of dependent steps, and at 2K (1242 x 2208) there are too few lines
// to hide a walk of thousands of them. The design:
//   * A line is staged in shared memory, read and written coalesced, one
//     int an element with its two links packed in bits 30 (linked to the
//     predecessor) and 29 (to the successor); labels are below 2**28.
//   * G warps own a line and each lane a contiguous segment of
//     ceil(n / 32G) elements (segment-major in shared memory at an odd
//     pitch, so the lanes' accesses hit distinct banks). A lane walks its
//     segment once for its forward and backward (run min, linked through)
//     summary; 5 shuffle steps scan a warp's 32 summaries and the warps'
//     totals are joined through shared memory (a segmented min is
//     associative, so any split gives the same integers); the lane then
//     walks its segment backward with its carry-in, storing the backward
//     scan, and forward over those values with its forward carry-in, which
//     leaves the run min. More warps a line: shorter walks, more warps to
//     hide the latency of the loads.
//   * The row launch takes `rows` rows a block and folds the hook into its
//     staging loop (the rows above and below are read through L1/L2, the
//     left and right neighbours come from the next lanes). The column
//     launch takes a strip of `cols` columns (a power of two); the strip's
//     rows are read and written as `cols`-wide runs. A thread stages U
//     elements at once, so their loads are in flight together.
//   * Convergence is tested on the device: every step (hook, walks) only
//     lowers labels, so a sweep changed a label iff one of its steps
//     lowered one; a warp that saw one stores `stamp` into `*flag`. The
//     host reads that one int after a few sweeps.
//
// Layout: labels (H, W) int32 in [0, 2**28), links (H, W) uint8 (bit 0 up,
// 1 down, 2 left, 3 right; kernels/speckle.py mirrors them), out (H, W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastdiv.cuh"

namespace {

constexpr int BIG = 1 << 28;             // identity of the min
constexpr unsigned FULL = 0xffffffffu;
constexpr int PRED = 1 << 30;            // linked to the predecessor on the line
constexpr int SUCC = 1 << 29;            // linked to the successor
constexpr int VALUE = SUCC - 1;
constexpr int UP = 1, DOWN = 2, LEFT = 4, RIGHT = 8;
constexpr int COL_PAD = 8;               // ints between two columns' lines
// elements a thread stages at once (a timing variant: tune_speckle.py)
#ifndef PSM_K9_U
#define PSM_K9_U 4
#endif
constexpr int U = PSM_K9_U;
constexpr int MAX_THREADS = 512;         // a block's, kernels/speckle.py mirrors it

// Where element i of a line lies: segment i / L at pitch LP (odd).
struct Segs {
  FastDiv by_L;
  int L, LP;
  __device__ Segs(int L_, int LP_) : by_L(L_), L(L_), LP(LP_) {}
  __device__ __forceinline__ int pos(int i) const {
    const int q = by_L.div(i);
    return q * LP + i - q * L;
  }
};

// The line of n packed entries at s, owned by the G warps of a block that
// share it (this thread: warp g, lane), becomes the run min of each element
// (plain values, links dropped). `tot`: 4 G ints of shared memory for the
// warps' totals. Every thread of the block calls it (n = 0 for a line that
// is not there). Returns whether an element of this lane's segment fell.
__device__ bool run_min_line(int* s, int n, const Segs& sg, int* tot, int g, int G,
                             int lane) {
  const int si = g * 32 + lane;
  int* seg = s + si * sg.LP;
  const int cnt = max(0, min(sg.L, n - si * sg.L));
  // (scan value at the segment's end, carry passes through): forward from
  // its last element, backward from its first
  int vf = BIG, af = 1, vb = BIG, open = 1;
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const int e = seg[i];
    const int v = e & VALUE;
    vf = (e & PRED) ? min(vf, v) : v;
    af &= (e & PRED) != 0;
    if (open) vb = min(vb, v);
    open &= (e & SUCC) != 0;
  }
  int ab = open;
  for (int k = 1; k < 32; k <<= 1) {
    const int v_f = __shfl_up_sync(FULL, vf, k), a_f = __shfl_up_sync(FULL, af, k);
    const int v_b = __shfl_down_sync(FULL, vb, k), a_b = __shfl_down_sync(FULL, ab, k);
    if (lane >= k) {
      if (af) vf = min(v_f, vf);
      af &= a_f;
    }
    if (lane + k < 32) {
      if (ab) vb = min(v_b, vb);
      ab &= a_b;
    }
  }
  // exclusive within the warp
  int cf = __shfl_up_sync(FULL, vf, 1), caf = __shfl_up_sync(FULL, af, 1);
  int cb = __shfl_down_sync(FULL, vb, 1), cab = __shfl_down_sync(FULL, ab, 1);
  if (lane == 0) cf = BIG, caf = 1;
  if (lane == 31) cb = BIG, cab = 1;
  if (G > 1) {
    // join the warps' totals: the carry into this warp from those before
    // (forward) and after it (backward)
    if (lane == 31) tot[4 * g] = vf, tot[4 * g + 1] = af;
    if (lane == 0) tot[4 * g + 2] = vb, tot[4 * g + 3] = ab;
    __syncthreads();
    int wf = BIG, wb = BIG;
    for (int j = 0; j < g; ++j) wf = tot[4 * j + 1] ? min(wf, tot[4 * j]) : tot[4 * j];
    for (int j = G - 1; j > g; --j)
      wb = tot[4 * j + 3] ? min(wb, tot[4 * j + 2]) : tot[4 * j + 2];
    if (caf) cf = min(cf, wf);
    if (cab) cb = min(cb, wb);
  }
  // each walk only lowers values: an element fell iff a walk lowered it
  bool fell = false;
  int acc = cb;
#pragma unroll 4
  for (int i = cnt - 1; i >= 0; --i) {
    const int e = seg[i];
    const int v = e & VALUE;
    acc = (e & SUCC) ? min(acc, v) : v;
    fell |= acc != v;
    seg[i] = acc | (e & PRED);
  }
  acc = cf;
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const int e = seg[i];
    const int v = e & VALUE;
    acc = (e & PRED) ? min(acc, v) : v;
    fell |= acc != v;
    seg[i] = acc;
  }
  return fell;
}

// Rows: blockDim (32, G, rows), the G warps (32 G segments) of a row at
// threadIdx.z. HOOK: the hook first, from the four link bits; the scan
// follows the links selected by `scan_bits` (LEFT for the sweep; any bit,
// 0xff, for a plain conn plane). The left and right labels and the right
// link come from the neighbouring lanes.
template <bool HOOK>
__global__ void __launch_bounds__(MAX_THREADS) speckle_rows_kernel(const int* __restrict__ in,
                                    const uint8_t* __restrict__ links, int* __restrict__ out,
                                    int H, int W, int scan_bits, int L, int LP,
                                    int* __restrict__ flag, int stamp) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int t = g * 32 + lane, nt = 32 * G;     // this thread among its row's
  const int y = blockIdx.x * blockDim.z + threadIdx.z;
  const int n = y < H ? W : 0;
  const Segs sg(L, LP);
  int* s = smem + threadIdx.z * 32 * G * LP;
  int* tot = smem + blockDim.z * 32 * G * LP + threadIdx.z * 4 * G;
  const int* r = in + (size_t)min(y, H - 1) * W;
  const uint8_t* lk = links + (size_t)min(y, H - 1) * W;
  bool fell = false;
  for (int x0 = 0; x0 < n; x0 += nt * U) {
    int v[U], l[U], up[U], dn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = x0 + nt * u + t;
      const bool in_row = x < n;
      v[u] = in_row ? r[x] : BIG;
      l[u] = in_row ? lk[x] : 0;
      if (HOOK) {
        up[u] = in_row && y > 0 ? r[x - W] : BIG;
        dn[u] = in_row && y + 1 < H ? r[x + W] : BIG;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = x0 + nt * u + t;
      // the neighbours at x - 1 and x + 1: lanes 0 and 31 read theirs
      int left = __shfl_up_sync(FULL, v[u], 1), right = __shfl_down_sync(FULL, v[u], 1);
      int l_next = __shfl_down_sync(FULL, l[u], 1);
      if (lane == 0 && x > 0 && x < n) left = r[x - 1];
      if (lane == 31 && x + 1 < n) {
        right = r[x + 1];
        l_next = lk[x + 1];
      }
      if (x >= n) continue;
      int m = v[u];
      if (HOOK) {
        if (l[u] & UP) m = min(m, up[u]);
        if (l[u] & DOWN) m = min(m, dn[u]);
        if ((l[u] & LEFT) && x > 0) m = min(m, left);
        if ((l[u] & RIGHT) && x + 1 < W) m = min(m, right);
        fell |= m != v[u];
      }
      const int pred = (l[u] & scan_bits) ? PRED : 0;
      const int succ = (x + 1 < W && (l_next & scan_bits)) ? SUCC : 0;
      s[sg.pos(x)] = m | pred | succ;
    }
  }
  __syncthreads();
  fell |= run_min_line(s, n, sg, tot, g, G, lane);
  __syncthreads();
  int* o = out + (size_t)y * W;
  for (int x0 = 0; x0 < n; x0 += nt * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = x0 + nt * u + t;
      if (x < n) o[x] = s[sg.pos(x)];
    }
  }
  if (flag) {
    const int any = __syncthreads_or(fell);
    if (any && threadIdx.x + threadIdx.y + threadIdx.z == 0) *flag = stamp;
  }
}

// Columns: blockDim (32, G, cols), a strip of `cols` columns (a power of
// two, 2**shift), the G warps of a column at threadIdx.z.
__global__ void __launch_bounds__(MAX_THREADS) speckle_cols_kernel(const int* __restrict__ in,
                                    const uint8_t* __restrict__ links, int* __restrict__ out,
                                    int H, int W, int scan_bits, int L, int LP,
                                    int* __restrict__ flag, int stamp) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y, cols = blockDim.z;
  const int tid = (threadIdx.z * G + g) * 32 + lane, nt = 32 * G * cols;
  const int shift = __ffs(cols) - 1;
  const int x0 = blockIdx.x * cols;
  const int nc = min(cols, W - x0);
  const Segs sg(L, LP);
  const int pitch = 32 * G * LP + COL_PAD;
  int* tot = smem + cols * pitch + threadIdx.z * 4 * G;
  const int n = H << shift;                    // (row, column) pairs of the strip
  for (int i0 = 0; i0 < n; i0 += nt * U) {
    int v[U], l[U], ln[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt + tid;
      const int y = i >> shift, c = i & (cols - 1);
      const size_t o = (size_t)y * W + x0 + c;
      const bool there = i < n && c < nc;
      v[u] = there ? in[o] : 0;
      l[u] = there ? links[o] : 0;
      ln[u] = there && y + 1 < H ? links[o + W] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt + tid;
      const int y = i >> shift, c = i & (cols - 1);
      if (i >= n || c >= nc) continue;
      const int pred = (l[u] & scan_bits) ? PRED : 0;
      const int succ = (ln[u] & scan_bits) ? SUCC : 0;
      smem[c * pitch + sg.pos(y)] = v[u] | pred | succ;
    }
  }
  __syncthreads();
  const int c = threadIdx.z;
  const bool fell = run_min_line(smem + c * pitch, c < nc ? H : 0, sg, tot, g, G, lane);
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += nt * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt + tid;
      const int y = i >> shift, cc = i & (cols - 1);
      if (i < n && cc < nc) out[(size_t)y * W + x0 + cc] = smem[cc * pitch + sg.pos(y)];
    }
  }
  if (flag) {
    const int any = __syncthreads_or(fell);
    if (any && tid == 0) *flag = stamp;
  }
}

// Shared-memory ints of a block of `lines` lines of n, G warps a line
// (kernels/speckle.py mirrors it), and the segment length.
int seg_len(int n, int G) { return (n + 32 * G - 1) / (32 * G); }

size_t block_ints(int n, int G, int lines, int pad) {
  return (size_t)lines * (32 * G * (seg_len(n, G) | 1) + pad + 4 * G);
}

template <class Kernel>
int launch(Kernel kernel, int nblocks, dim3 block, size_t smem, cudaStream_t s,
           const int* in, const uint8_t* links, int* out, int H, int W, int scan_bits,
           int L, int* flag, int stamp) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblocks, block, smem, s>>>(in, links, out, H, W, scan_bits, L, L | 1, flag, stamp);
  return (int)cudaGetLastError();
}

int rows_pass(bool hook, const int* in, const uint8_t* links, int* out, int H, int W,
              int scan_bits, int rows, int G, int* flag, int stamp, cudaStream_t s) {
  const size_t smem = sizeof(int) * block_ints(W, G, rows, 0);
  const dim3 block(32, G, rows);
  const int nb = (H + rows - 1) / rows, L = seg_len(W, G);
  return hook ? launch(speckle_rows_kernel<true>, nb, block, smem, s, in, links, out, H, W,
                       scan_bits, L, flag, stamp)
              : launch(speckle_rows_kernel<false>, nb, block, smem, s, in, links, out, H, W,
                       scan_bits, L, flag, stamp);
}

int cols_pass(const int* in, const uint8_t* links, int* out, int H, int W, int scan_bits,
              int cols, int G, int* flag, int stamp, cudaStream_t s) {
  const size_t smem = sizeof(int) * block_ints(H, G, cols, COL_PAD);
  return launch(speckle_cols_kernel, (W + cols - 1) / cols, dim3(32, G, cols), smem, s, in,
                links, out, H, W, scan_bits, seg_len(H, G), flag, stamp);
}

}  // namespace

// One sweep: the row launch (hook, then the row scan) into `tmp`, the
// column launch into `out`. `flag` (one int) receives `stamp` where a label
// changed. (rows, row_warps): rows a block of the row launch and warps a
// row; (cols, col_warps) the same of the column launch
// (kernels/speckle.py::launch_shape).
extern "C" int psm_speckle_sweep(const int* in, const uint8_t* links, int* tmp, int* out,
                                 int* flag, int stamp, int H, int W, int rows, int row_warps,
                                 int cols, int col_warps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  const int rc = rows_pass(true, in, links, tmp, H, W, LEFT, rows, row_warps, flag, stamp, s);
  if (rc) return rc;
  return cols_pass(tmp, links, out, H, W, UP, cols, col_warps, flag, stamp, s);
}

// The TPU kernel's function alone: the segmented min sweep of m along one
// axis over a conn plane (nonzero = linked to the predecessor).
extern "C" int psm_segmin_sweep(const int* m, const uint8_t* conn, int* out, int H, int W,
                                int axis, int rows, int row_warps, int cols, int col_warps,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  return axis == 0
             ? cols_pass(m, conn, out, H, W, 0xff, cols, col_warps, nullptr, 0, s)
             : rows_pass(false, m, conn, out, H, W, 0xff, rows, row_warps, nullptr, 0, s);
}
