// K8: SGBM disparity selection (cv::StereoSGBM semantics).
//
// Replaces primestereomatch_tpu/kernels/select_pallas.py::_select_kernel_1p
// and ::_select_kernel (launcher select_disparity_partials_pallas; both
// compute one function). Per pixel of the aggregated cost S: first-min
// argmin d_best and s_best; uniqueness (a d with |d - d_best| > 1 and
// S[d]*(100-u) < s_best*100 rejects the pixel); OpenCV's truncating
// integer sub-pixel step; the minX band; then per row the scatter-based
// pseudo right disparity and the floor/ceil dual LR check.
//
// The aggregated cost comes as the int32 S or as the scan kernel's group
// partials, one or two uint16 tensors that are added in registers as they
// are read (S is then never formed): the kernel is a template over the
// three inputs and the same otherwise.
//
// What bounds it: reading S once (4 bytes per pixel and d) against ~5
// integer operations per value: bytes. One block per image row, one warp
// per pixel at a time: the lanes read neighbouring d of one pixel
// (coalesced), reduce (value, d) pairs by shuffles, and lane 0 writes the
// pixel's disparity and its scatter candidate to shared memory.
//   * The TPU kernel's f32 quotient with a +-1 fix-up exists because the
//     TPU vector unit has no integer divide; C's `/` truncates as the
//     reference's formula wants.
//   * The scatter disp2[x - d_best - minD] = the candidate with the lowest
//     s_best, ties to the smaller d, is an atomicMin in shared memory on
//     the 64-bit key (s_best as order-preserving unsigned << 32) | d_best:
//     exact and independent of the order of the atomics. Every
//     min_disparity is taken, negative included (the TPU kernel raises
//     there).
//   * The LR check reads disp2 at x - floor(d) and x - ceil(d) from shared
//     memory.
//
// Layout: S or each partial (H, W, D), out (H, W) int16. Grid H, 256
// threads, 12 bytes of shared memory per column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int THREADS = 256;

__device__ __forceinline__ int wrap_mul(int a, int b) {
  // int32 multiply with two's-complement wrap, as the reference's int32 math
  return (int)((unsigned)a * (unsigned)b);
}

// The aggregated cost of one pixel: NP = 0 the int32 S, NP = 1 or 2 that
// many uint16 partials, summed as they are read.
template <int NP>
struct Costs {
  const void* a;
  const void* b;
  __device__ __forceinline__ int operator[](int d) const {
    if (NP == 0) return ((const int*)a)[d];
    if (NP == 1) return ((const uint16_t*)a)[d];
    return (int)((const uint16_t*)a)[d] + (int)((const uint16_t*)b)[d];
  }
};

template <int NP>
__global__ void select_kernel(const void* __restrict__ Sa, const void* __restrict__ Sb,
                              int16_t* __restrict__ out, int H, int W, int D, int uniq,
                              int d12, int minD) {
  extern __shared__ unsigned char smem[];
  unsigned long long* key2 = (unsigned long long*)smem;   // [W]
  int* disp = (int*)(key2 + W);                             // [W]
  const int y = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = THREADS / 32;
  const int minX1 = max(minD + D, 0);
  const int maxX1 = W + min(minD, 0);
  const int inv = (minD - 1) * 16;

  for (int x = tid; x < W; x += THREADS) key2[x] = NO_KEY;
  __syncthreads();

  for (int x = warp; x < W; x += n_warps) {
    const size_t at = ((size_t)y * W + x) * D * (NP == 0 ? sizeof(int) : sizeof(uint16_t));
    const Costs<NP> s = {(const char*)Sa + at, NP == 2 ? (const char*)Sb + at : nullptr};
    // first minimum: lane-local ascending d, then (value, d) shuffles
    int bv = 0x7fffffff, bd = 0x7fffffff;
    for (int d = lane; d < D; d += 32) {
      const int v = s[d];
      if (v < bv) { bv = v; bd = d; }
    }
    for (int k = 16; k > 0; k >>= 1) {
      const int ov = __shfl_xor_sync(FULL, bv, k);
      const int od = __shfl_xor_sync(FULL, bd, k);
      if (ov < bv || (ov == bv && od < bd)) { bv = ov; bd = od; }
    }
    // the min over |d - d_best| > 1, from BIG (the reference's sentinel)
    int alt = BIG;
    for (int d = lane; d < D; d += 32) {
      if (abs(d - bd) > 1) alt = min(alt, s[d]);
    }
    for (int k = 16; k > 0; k >>= 1) alt = min(alt, __shfl_xor_sync(FULL, alt, k));
    if (lane == 0) {
      const bool not_unique =
          alt < BIG && wrap_mul(alt, 100 - uniq) < wrap_mul(bv, 100);
      int frac = 0;
      if (bd > 0 && bd < D - 1) {
        const int sm = s[bd - 1], sp = s[bd + 1];
        const int denom2 = max(sm + sp - 2 * bv, 1);
        const int num = (sm - sp) * 16 + denom2;
        frac = num / (2 * denom2);       // C division truncates
      }
      const bool valid0 = x >= minX1 && x < maxX1 && !not_unique;
      disp[x] = valid0 ? (bd + minD) * 16 + frac : inv;
      const int xr = x - bd - minD;
      if (valid0 && xr >= 0 && xr < W) {
        const unsigned long long key =
            ((unsigned long long)((unsigned)bv ^ 0x80000000u) << 32) | (unsigned)bd;
        atomicMin(&key2[xr], key);
      }
    }
  }
  __syncthreads();

  int16_t* orow = out + (size_t)y * W;
  for (int x = tid; x < W; x += THREADS) {
    int v = disp[x];
    if (d12 >= 0 && v != inv) {
      const int d_f = v >> 4;               // floor (arithmetic shift)
      const int d_c = (v + 15) >> 4;        // ceil
      const int xf = x - d_f, xc = x - d_c;
      bool bad = xf >= 0 && xf < W && xc >= 0 && xc < W;
      if (bad) {
        const unsigned long long kf = key2[xf], kc = key2[xc];
        const int vf = kf == NO_KEY ? minD - 1 : (int)(kf & 0xffffffffu) + minD;
        const int vc = kc == NO_KEY ? minD - 1 : (int)(kc & 0xffffffffu) + minD;
        bad = vf >= minD && abs(vf - d_f) > d12 && vc >= minD && abs(vc - d_c) > d12;
      }
      if (bad) v = inv;
    }
    orow[x] = (int16_t)v;
  }
}

template <int NP>
cudaError_t launch(const void* Sa, const void* Sb, int16_t* out, int H, int W, int D, int uniq,
                   int d12, int minD, cudaStream_t s) {
  const size_t smem = (size_t)W * (sizeof(unsigned long long) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  select_kernel<NP><<<H, THREADS, smem, s>>>(Sa, Sb, out, H, W, D, uniq, d12, minD);
  return cudaGetLastError();
}

}  // namespace

// n_partials = 0: Sa is the int32 S; 1 or 2: Sa (and Sb) are uint16 group
// partials whose sum is S.
extern "C" int psm_select_disparity(const void* Sa, const void* Sb, int n_partials,
                                    int16_t* out, int H, int W, int D, int uniq, int d12,
                                    int minD, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_partials == 0) return (int)launch<0>(Sa, Sb, out, H, W, D, uniq, d12, minD, s);
  if (n_partials == 1) return (int)launch<1>(Sa, Sb, out, H, W, D, uniq, d12, minD, s);
  if (n_partials == 2) return (int)launch<2>(Sa, Sb, out, H, W, D, uniq, d12, minD, s);
  return (int)cudaErrorInvalidValue;
}
