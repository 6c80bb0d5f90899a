// K4: the sampled matching cost built inside the low-maps kernel, for Hopper.
//
// Replaces primestereomatch_tpu/kernels/cvc_lowmaps_pallas.py::
// _cvc_lowmaps_kernel. Per disparity d of one view it evaluates the cost
// at the FGF's sample grid (full-resolution rows yi, columns xi; the other
// view read at xi - d for a left view, xi + d for a right one, the border
// cost where that falls outside the image) and runs K1's coefficient chain
// on it, so the (D, h, w) cost volume never exists in device memory.
//
// The TPU kernel cuts the other view into polyphase planes, rotates lanes
// by the whole-pixel shift and rebuilds the reflect-101 column margins in
// place, because reflection does not commute with the disparity shift.
// Here each entry of the block's shared-memory band is simply the cost at
// the reflected in-image low-res pixel, which is reflect-101 of the cost
// plane exactly; the sample tables serve every geometry.
//
// What bounds it: it writes 4 maps per cost value and reads only the
// images, their gradients and the 12 statistic planes, so the map writes
// are the function's bound (bytes); what the kernel spends its time on is
// instruction throughput and shared-memory loads in the chain (fgf_chain.cuh
// says what it does about those). All D slices of a tile sample the same
// pixels of the local view, so a block takes a chunk of disparities of its
// tile: it stages the band's local-view samples (b, g, r, gradient as one
// float4) and their full-resolution (row, column) in shared memory once,
// and then, for each d of the chunk, fills the cost band from them and
// from the other view's row (shifted reads, served by L1/L2), runs the
// chain and writes the four maps. The wrapper picks the chunk so that the
// launch still fills the card at small images (kernels/cvc_lowmaps.py::
// plan_chunks).
//
// Numerics: the cost follows ops/cost_volume.py::_pair_cost term by term
// and the chain is fgf_chain.cuh; built with -fmad=false the maps equal the
// plain version's (sampled cost volume, then K1's plain version) bit for bit.
//
// Layout: views (2B, H, W, 3) f32 and their Sobel-x gradients (2B, H, W),
// the B left views first and then the B right ones: view v < B is matched
// against view v + B at x - d, view v >= B against view v - B at x + d.
// stats (2B, 12, h, w), yi (h,) and xi (w,) int32, out (2B, 4, D, h, w).
// Grid (ceil(w/TW), ceil(h/TH), 2B * nchunks), nchunks = ceil(D / chunk).
// H and W are below 2**16 (a sample's row and column share one word).

#include <cuda_runtime.h>

#include "fgf_chain.cuh"

// 0 gathers the samples per disparity at every box size (a timing variant)
#ifndef PSM_K4_STAGE
#define PSM_K4_STAGE 1
#endif
// threads a block (a timing variant too)
#ifndef PSM_K4_NT
#define PSM_K4_NT 512
#endif
// outputs a thread in the chain's horizontal passes at a compile-time box
// (fgf_chain.cuh::chain_blocked; a timing variant: 1 ships)
#ifndef PSM_K4_RH
#define PSM_K4_RH 1
#endif

namespace {

constexpr int TH = 32;
constexpr int TW = 32;
constexpr int NTHREADS = PSM_K4_NT;

struct StoreMaps {
  float* out;   // the view's (4, D, h, w) maps at this slice and tile origin
  size_t cstride;
  int w;
  __device__ void operator()(int c, int ty, int tx, float v) const {
    out[c * cstride + (size_t)ty * w + tx] = v;
  }
};

// Floats of dynamic shared memory: the chain's and, where the samples are
// staged, the local view (one float4 a band entry) and the entry's packed
// (row, column).
inline size_t smem_floats(int k, bool stage, int rh) {
  const int M = 2 * (k / 2);
  return fgf::chain_floats(TH, TW, k, rh) +
         (stage ? 5 * (size_t)(TH + 2 * M) * (TW + 2 * M) : 0);
}

// STAGE = false gathers the samples anew for every d: for boxes whose
// chain leaves no room for the staged samples (k = 17).
template <int K, bool STAGE>
__global__ void __launch_bounds__(NTHREADS)
cvc_lowmaps_kernel(const float* __restrict__ views, const float* __restrict__ grds,
                   const float* __restrict__ stats, const int* __restrict__ yi,
                   const int* __restrict__ xi, float* __restrict__ out, int B,
                   int D, int H, int W, int h, int w, int k, float inv_k2,
                   int chunk, int nchunks, fgf::CostParams cp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RH = K > 0 ? PSM_K4_RH : 1;
  const int kk = K > 0 ? K : k;       // the box size, at compile time where K is
  const int M = 2 * (kk / 2);
  const int nb = (TH + 2 * M) * (TW + 2 * M);
  float4* lv = reinterpret_cast<float4*>(smem + fgf::chain_floats(TH, TW, kk, RH));
  unsigned* pos = reinterpret_cast<unsigned*>(lv + nb);   // row << 16 | column, full resolution

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int v = blockIdx.z / nchunks, c = blockIdx.z - v * nchunks;
  const int d_end = min(D, (c + 1) * chunk);
  const bool is_left = v < B;
  const int ov = is_left ? v + B : v - B;
  const size_t hw = (size_t)h * w, HW = (size_t)H * W;
  const float* img = views + (size_t)v * HW * 3;
  const float* grd = grds + (size_t)v * HW;
  const float* oimg = views + (size_t)ov * HW * 3;
  const float* ogrd = grds + (size_t)ov * HW;
  const float* st = stats + (size_t)v * 12 * hw;
  const int tid = threadIdx.x;

  // the local view at the reflected in-image sample of a band entry
  auto sample = [&](int i, float4* l, int* Y, int* X) {
    int iy, ix;
    fgf::band_index(i, TW, kk, y0, x0, h, w, &iy, &ix);
    *Y = yi[iy];
    *X = xi[ix];
    const size_t o = (size_t)*Y * W + *X;
    *l = make_float4(img[o * 3], img[o * 3 + 1], img[o * 3 + 2], grd[o]);
  };
  if (STAGE) {
    for (int i = tid; i < nb; i += NTHREADS) {
      float4 l;
      int Y, X;
      sample(i, &l, &Y, &X);
      lv[i] = l;
      pos[i] = (unsigned)Y << 16 | (unsigned)X;
    }
    __syncthreads();
  }

  const int oh = min(TH, h - y0), ow = min(TW, w - x0);
  for (int d = c * chunk; d < d_end; ++d) {
    // band of the cost and ch_c * cost
    for (int i = tid; i < nb; i += NTHREADS) {
      float4 l;
      int Y, X;
      if (STAGE) {
        l = lv[i];
        Y = pos[i] >> 16;
        X = pos[i] & 0xffff;
      } else {
        sample(i, &l, &Y, &X);
      }
      const float a[4] = {l.x, l.y, l.z, l.w};
      const size_t row = (size_t)Y * W;
      const float p = fgf::sampled_cost(a, oimg + row * 3, ogrd + row, X, d,
                                        is_left, W, cp);
      fgf::band_store(smem, TH, TW, kk, i, p, a[0], a[1], a[2]);
    }
    const StoreMaps store{
        out + ((size_t)v * 4 * D + d) * hw + (size_t)y0 * w + x0,
        (size_t)D * hw, w};
    fgf::chain<NTHREADS, K, StoreMaps, fgf::BlockSync, RH>(
        smem, st, h, w, kk, inv_k2, TH, TW, y0, x0, oh, ow, tid, store);
    __syncthreads();   // the last step has read where the band lies
  }
}

constexpr size_t MAX_SMEM = 227 * 1024;   // a block's shared memory on Hopper

template <int K, bool STAGE>
int launch(const float* views, const float* grds, const float* stats, const int* yi,
           const int* xi, float* out, int B, int D, int H, int W, int h, int w, int k,
           float inv_k2, int chunk, fgf::CostParams cp, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(k, STAGE, K > 0 ? PSM_K4_RH : 1);
  cudaError_t err = cudaFuncSetAttribute(
      cvc_lowmaps_kernel<K, STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (D + chunk - 1) / chunk;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, 2 * B * nchunks);
  cvc_lowmaps_kernel<K, STAGE><<<grid, NTHREADS, smem, stream>>>(
      views, grds, stats, yi, xi, out, B, D, H, W, h, w, k, inv_k2, chunk, nchunks, cp);
  return (int)cudaGetLastError();
}

}  // namespace

// `chunk` disparities a block (kernels/cvc_lowmaps.py::plan_chunks). The
// boxes of subsample 8, 4, 2 and 1 at gif_radius 8 are instantiated; any
// other odd k takes the run-time instance.
extern "C" int psm_cvc_lowmaps(const float* views, const float* grds,
                               const float* stats, const int* yi, const int* xi,
                               float* out, int B, int D, int H, int W, int h,
                               int w, int k, float inv_k2, int chunk, float alpha,
                               float one_minus_alpha, float border, float tau1,
                               float tau2, void* stream) {
  const fgf::CostParams cp{alpha, one_minus_alpha, border, tau1, tau2};
  cudaStream_t s = (cudaStream_t)stream;
  const bool stage = PSM_K4_STAGE && sizeof(float) * smem_floats(k, true, 1) <= MAX_SMEM;
#define PSM_CVC_LOWMAPS_LAUNCH(K, STAGE)                                                \
  return launch<K, STAGE>(views, grds, stats, yi, xi, out, B, D, H, W, h, w, k, inv_k2, \
                          chunk, cp, s)
  switch (k) {
    case 3: PSM_CVC_LOWMAPS_LAUNCH(3, PSM_K4_STAGE);
    case 5: PSM_CVC_LOWMAPS_LAUNCH(5, PSM_K4_STAGE);
    case 9: PSM_CVC_LOWMAPS_LAUNCH(9, PSM_K4_STAGE);
    case 17: PSM_CVC_LOWMAPS_LAUNCH(17, false);
    default:
      if (stage) PSM_CVC_LOWMAPS_LAUNCH(0, true);
      PSM_CVC_LOWMAPS_LAUNCH(0, false);
  }
#undef PSM_CVC_LOWMAPS_LAUNCH
}
