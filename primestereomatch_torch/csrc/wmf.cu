// K3: joint weighted median filter, exact mode.
//
// Replaces primestereomatch_tpu/kernels/wmf_pallas.py::_wmf_kernel
// (launcher _wmf_pallas_batched). For each pixel, over the (2r+1)^2 window
// clamped to the image, weight w = expf(-|c6(p) - c6(q)|^2 * inv_two_sig2)
// with 6-bit colours c6 = c >> 2; the output is the smallest bin whose
// cumulative weight reaches half the total.
//
// What bounds it: ~11 flops and one expf per (pixel, window offset), 361
// offsets at r = 9, against 5 bytes of device memory per pixel: the
// arithmetic is the bound, by far. The design is one thread per pixel
// with its own histogram of n_bins floats in shared memory (bin-major, so
// the 32 threads of a warp hit 32 different banks), accumulated in the
// window's row-major offset order, then a sequential cumulative scan over
// the bins. That is the plain version's summation order
// (ops/jointwmf.py), so both give the same medians; the TPU kernel's
// bounded K-way binary search over the bins is a later optimisation.
// Out-of-image neighbours are skipped, which is what the plain version's
// zero weight does (the TPU kernel's _BORDER_C padding trick is not
// needed). The block size is cut so that n_bins*4 bytes per thread fit in
// shared memory: 128 threads (128 KB) at n_bins = 256.
//
// Layout: disp (B, H, W) uint8, guide (B, H, W, 3) uint8, out (B, H, W)
// uint8. Grid (ceil(H*W/threads), B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMEM_BUDGET = 200 * 1024;

__global__ void joint_wmf_kernel(const uint8_t* __restrict__ disp,
                                 const uint8_t* __restrict__ guide,
                                 uint8_t* __restrict__ out, int H, int W,
                                 int r, int n_bins, float inv_two_sig2) {
  extern __shared__ float hist[];   // hist[bin * blockDim.x + tid]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int pix = blockIdx.x * nt + tid;
  const int b = blockIdx.y;
  if (pix >= H * W) return;
  float* hp = hist + tid;
  for (int k = 0; k < n_bins; ++k) hp[k * nt] = 0.0f;

  const int y = pix / W, x = pix % W;
  const uint8_t* db = disp + (size_t)b * H * W;
  const uint8_t* gb = guide + (size_t)b * H * W * 3;
  const float c0 = (float)(gb[(size_t)pix * 3 + 0] >> 2);
  const float c1 = (float)(gb[(size_t)pix * 3 + 1] >> 2);
  const float c2 = (float)(gb[(size_t)pix * 3 + 2] >> 2);

  for (int yy = y - r; yy <= y + r; ++yy) {
    if (yy < 0 || yy >= H) continue;
    for (int xx = x - r; xx <= x + r; ++xx) {
      if (xx < 0 || xx >= W) continue;
      const size_t q = (size_t)yy * W + xx;
      const int dq = db[q];
      if (dq >= n_bins) continue;
      const float e0 = c0 - (float)(gb[q * 3 + 0] >> 2);
      const float e1 = c1 - (float)(gb[q * 3 + 1] >> 2);
      const float e2 = c2 - (float)(gb[q * 3 + 2] >> 2);
      const float dist2 = e0 * e0 + e1 * e1 + e2 * e2;
      hp[dq * nt] += expf(-dist2 * inv_two_sig2);
    }
  }

  float total = 0.0f;
  for (int k = 0; k < n_bins; ++k) total += hp[k * nt];
  const float half = total * 0.5f;
  float cum = 0.0f;
  int ans = n_bins - 1;
  for (int k = 0; k < n_bins; ++k) {
    cum += hp[k * nt];
    if (cum >= half) {
      ans = k;
      break;
    }
  }
  out[(size_t)b * H * W + pix] = (uint8_t)ans;
}

}  // namespace

extern "C" int psm_joint_wmf(const uint8_t* disp, const uint8_t* guide,
                             uint8_t* out, int B, int H, int W, int r,
                             int n_bins, float inv_two_sig2, void* stream) {
  int nt = SMEM_BUDGET / (n_bins * (int)sizeof(float));
  nt = nt >= 128 ? 128 : (nt / 32) * 32;
  if (nt < 32) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_bins * sizeof(float) * nt;
  cudaError_t err = cudaFuncSetAttribute(
      joint_wmf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H * W + nt - 1) / nt, B);
  joint_wmf_kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(
      disp, guide, out, H, W, r, n_bins, inv_two_sig2);
  return (int)cudaGetLastError();
}
