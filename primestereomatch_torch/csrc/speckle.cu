// K9: segmented min sweep of the speckle filter's labels along one axis.
//
// Replaces primestereomatch_tpu/kernels/speckle_pallas.py::_segmin_kernel
// (launcher segmin_sweep_pallas). out = min(forward, backward) segmented
// min scan of the labels m along the axis. Forward, element i is connected
// to its predecessor i-1 when conn[i]; backward, i is connected to i+1
// when conn[i+1] (never at the last element). A segmented scan carries the
// minimum across a whole connected run.
//
// What bounds it: 9 bytes of device memory per pixel (label in, conn in,
// label out) against ~7 integer operations: bytes. The TPU kernel keeps a
// whole axis in VMEM and scans it by doubling (log2 n passes). Here each
// line is one sequential scan with its state in registers, which reads
// every element once:
//   axis 0 (columns): one thread per column walks down and then up; the 32
//     threads of a warp read 32 neighbouring columns of a row (coalesced);
//   axis 1 (rows): one warp per row walks it 32 columns at a time, the
//     segmented scan inside a chunk by 5 shuffle steps (Hillis-Steele on
//     the (value, connected) pair), the carry between chunks in registers.
//     The forward pass writes out, the backward pass takes the min with it;
//     each lane handles the same columns in both passes.
//
// Layout: m (H, W) int32, conn (H, W) uint8, out (H, W) int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;

__global__ void segmin_cols_kernel(const int* __restrict__ m,
                                   const uint8_t* __restrict__ conn,
                                   int* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  // unrolled: the loads do not depend on the running minimum, so several
  // are in flight at once (each thread's walk is otherwise latency-bound)
  int acc = BIG;
#pragma unroll 8
  for (int y = 0; y < H; ++y) {
    const size_t i = (size_t)y * W + x;
    const int v = m[i];
    acc = conn[i] ? min(acc, v) : v;
    out[i] = acc;
  }
  acc = BIG;
#pragma unroll 8
  for (int y = H - 1; y >= 0; --y) {
    const size_t i = (size_t)y * W + x;
    const int v = m[i];
    const bool f = (y + 1 < H) && conn[i + W];
    acc = f ? min(acc, v) : v;
    out[i] = min(out[i], acc);
  }
}

// one warp per row; blockDim.x = 32, blockDim.y = rows per block
__global__ void segmin_rows_kernel(const int* __restrict__ m,
                                   const uint8_t* __restrict__ conn,
                                   int* __restrict__ out, int H, int W) {
  const int y = blockIdx.x * blockDim.y + threadIdx.y;
  if (y >= H) return;   // whole warps leave together
  const int lane = threadIdx.x;
  const int* mr = m + (size_t)y * W;
  const uint8_t* cr = conn + (size_t)y * W;
  int* orow = out + (size_t)y * W;
  const int n_chunks = (W + 31) / 32;

  // forward: predecessor of x is x-1, flag conn[x]
  int carry = BIG;
  for (int c = 0; c < n_chunks; ++c) {
    const int x = c * 32 + lane;
    int v = x < W ? mr[x] : BIG;
    int f = x < W ? (int)cr[x] : 0;
    for (int k = 1; k < 32; k <<= 1) {
      const int v_o = __shfl_up_sync(FULL, v, k);
      const int f_o = __shfl_up_sync(FULL, f, k);
      if (lane >= k) {
        if (f) v = min(v_o, v);
        f &= f_o;
      }
    }
    if (f) v = min(carry, v);   // f: connected all the way to the chunk start
    if (x < W) orow[x] = v;
    carry = __shfl_sync(FULL, v, 31);
  }

  // backward: predecessor of x is x+1, flag conn[x+1]
  carry = BIG;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int x = c * 32 + lane;
    int v = x < W ? mr[x] : BIG;
    int f = (x + 1 < W) ? (int)cr[x + 1] : 0;
    for (int k = 1; k < 32; k <<= 1) {
      const int v_o = __shfl_down_sync(FULL, v, k);
      const int f_o = __shfl_down_sync(FULL, f, k);
      if (lane + k < 32) {
        if (f) v = min(v_o, v);
        f &= f_o;
      }
    }
    if (f) v = min(carry, v);
    if (x < W) orow[x] = min(orow[x], v);
    carry = __shfl_sync(FULL, v, 0);
  }
}

}  // namespace

extern "C" int psm_segmin_sweep(const int* m, const uint8_t* conn, int* out,
                                int H, int W, int axis, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  if (axis == 0) {
    const int nt = 32;     // one warp per block: the few columns spread over SMs
    segmin_cols_kernel<<<(W + nt - 1) / nt, nt, 0, s>>>(m, conn, out, H, W);
  } else {
    const dim3 block(32, 4);
    segmin_rows_kernel<<<(H + 3) / 4, block, 0, s>>>(m, conn, out, H, W);
  }
  return (int)cudaGetLastError();
}
