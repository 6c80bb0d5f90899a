// K6: Birchfield-Tomasi pixel cost and k x k window sum (SGBM cost).
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
// pixel cost, against 2 bytes written per (y, x, d): operations. The
// window sum is separable, so each pixel cost is computed once per
// window row instead of k*k times:
//   * row pass: a block owns one image row, 64 columns and 32
//     disparities; it computes the pixel costs of its columns plus the
//     k-1 halo columns once into shared memory (clamped columns), then
//     each output is a k-term sum from shared memory, written to a scratch
//     volume in the output type;
//   * column pass: one thread per (x, d) walks a strip of 32 rows with a
//     running sum (add the row entering the window, subtract the row
//     leaving it; clamped rows), reading the scratch volume twice per
//     output. Integer sums are exact, and modular in int16, so the result
//     equals the plain version's for every input.
// The TPU kernel's int8 feature stacks and lane rolls do not carry over;
// features stay int32 here and any channel count, feature range and
// cost bound is taken.
//
// Layout: features (H, W, C) int32, scratch and out (H, W, D) int16 or
// int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DC = 32;     // disparities per block (threadIdx.x)
constexpr int TY = 8;      // threadIdx.y
constexpr int TX = 64;     // columns per block of the row pass
constexpr int SR = 32;     // rows per thread of the column pass

__device__ __forceinline__ void interp(const int* __restrict__ f, int W, int C, int x, int c,
                                       int& v, int& mn, int& mx) {
  v = f[x * C + c];
  const int prev = f[max(x - 1, 0) * C + c];
  const int next = f[min(x + 1, W - 1) * C + c];
  const int lo = (v + prev) >> 1;    // floor division by 2
  const int hi = (v + next) >> 1;
  mn = min(min(lo, hi), v);
  mx = max(max(lo, hi), v);
}

template <typename OT>
__global__ void __launch_bounds__(DC * TY)
bt_row_kernel(const int* __restrict__ lf, const int* __restrict__ rf, OT* __restrict__ hs,
              int H, int W, int C, int D, int k) {
  extern __shared__ int pc[];            // [(TX + k - 1) * DC]
  const int y = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int d0 = blockIdx.y * DC;
  const int lo = k / 2;
  const int tid = threadIdx.y * DC + threadIdx.x;
  const int n_cols = TX + k - 1;
  const int* lrow = lf + (size_t)y * W * C;
  const int* rrow = rf + (size_t)y * W * C;

  for (int i = tid; i < n_cols * DC; i += DC * TY) {
    const int col = i / DC, dd = i % DC;
    const int d = d0 + dd;
    int acc = 0;
    if (d < D) {
      const int xx = min(max(x0 - lo + col, 0), W - 1);
      const int xr = max(xx - d, 0);
      for (int c = 0; c < C; ++c) {
        int l, lmn, lmx, r, rmn, rmx;
        interp(lrow, W, C, xx, c, l, lmn, lmx);
        interp(rrow, W, C, xr, c, r, rmn, rmx);
        const int c1 = max(max(l - rmx, rmn - l), 0);
        const int c2 = max(max(r - lmx, lmn - r), 0);
        acc += min(c1, c2);
      }
    }
    pc[i] = acc;
  }
  __syncthreads();

  const int dd = threadIdx.x, d = d0 + dd;
  if (d >= D) return;
  for (int c = threadIdx.y; c < TX; c += TY) {
    const int x = x0 + c;
    if (x >= W) break;
    int h = 0;
    for (int i = 0; i < k; ++i) h += pc[(c + i) * DC + dd];
    hs[((size_t)y * W + x) * D + d] = (OT)h;
  }
}

template <typename OT>
__global__ void bt_col_kernel(const OT* __restrict__ hs, OT* __restrict__ out, int H, int W,
                              int D, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)W * D;
  if (i >= plane) return;
  const int y0 = blockIdx.y * SR;
  const int y1 = min(y0 + SR, H);
  const int lo = k / 2, hi = k - 1 - lo;
  int acc = 0;
  for (int dy = -lo; dy <= hi; ++dy) {
    acc += hs[min(max(y0 + dy, 0), H - 1) * plane + i];
  }
  out[y0 * plane + i] = (OT)acc;
#pragma unroll 4
  for (int y = y0 + 1; y < y1; ++y) {
    acc += (int)hs[min(y + hi, H - 1) * plane + i] - (int)hs[max(y - 1 - lo, 0) * plane + i];
    out[y * plane + i] = (OT)acc;
  }
}

template <typename OT>
cudaError_t run(const int* lf, const int* rf, OT* hs, OT* out, int H, int W, int C, int D,
                int k, cudaStream_t s) {
  const size_t smem = (size_t)(TX + k - 1) * DC * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      bt_row_kernel<OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_r((W + TX - 1) / TX, (D + DC - 1) / DC, H);
  bt_row_kernel<OT><<<grid_r, dim3(DC, TY), smem, s>>>(lf, rf, hs, H, W, C, D, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long plane = (long long)W * D;
  const dim3 grid_c((unsigned)((plane + 255) / 256), (H + SR - 1) / SR);
  bt_col_kernel<OT><<<grid_c, 256, 0, s>>>(hs, out, H, W, D, k);
  return cudaGetLastError();
}

}  // namespace

// Two launches: the row pass into `scratch`, the column pass into `out`
// (both (H, W, D), int16 when out_is_int16 else int32).
extern "C" int psm_bt_cost(const int* lf, const int* rf, void* scratch, void* out,
                           int out_is_int16, int H, int W, int C, int D, int k,
                           void* stream) {
  if (H <= 0 || W <= 0 || D <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_is_int16
                   ? run(lf, rf, (int16_t*)scratch, (int16_t*)out, H, W, C, D, k, s)
                   : run(lf, rf, (int32_t*)scratch, (int32_t*)out, H, W, C, D, k, s));
}
