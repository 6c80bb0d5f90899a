// K1: low-resolution FastGuidedFilter coefficient chain, for Hopper.
//
// Replaces primestereomatch_tpu/kernels/lowmaps_pallas.py::_lowmaps_kernel
// (body _maps_chain, _box_valid). Per cost slice p (one disparity of one
// view) it computes box(p) and box(I_c * p) for the three guide channels,
// the covariance, (a_r, a_g, a_b, b) through the symmetric inverse, and a
// box average of each map again. k x k boxes, reflect-101 borders.
//
// What bounds it: at the slice's shapes (Teddy D=64 at 93x112, 2K D=256 at
// 310x552, k=5) it moves 4 output maps per input cost value and does about
// 100 flops per value, so device memory traffic is the bound. The design
// reads each cost value once per tile (plus a halo of 2*(k/2) on each
// side), keeps the whole chain in shared memory, and writes each map once.
// The 12 guide-statistic planes are shared by all D slices and stay in L2.
//
// The chain itself (fgf_chain.cuh) is shared with K4 and K10 and follows
// ops/guided_filter.py step for step; built with -fmad=false, the maps
// agree with the plain version bit for bit.
//
// At the 17 x 17 box (subsample=1) the chain's shared-memory loads and the
// latency of its device-memory reads hold the kernel: K1 runs the chain
// with RH = 4 outputs a thread in its horizontal passes too (chain_blocked:
// about half the loads of one output a thread) and reuses the band's space,
// so a 32 x 32 tile takes 115,520 bytes and two blocks share an SM. The
// smaller boxes run the same passes in blocks of 128 threads (Teddy's
// 1536 blocks then spread over more of the card). The block shape of each
// box size is a -D knob (tune_gif_tail.py times the variants);
// kernels/lowmaps.py mirrors the defaults (`block_shape`).
//
// Layout: p (B, D, h, w) f32, stats (B, 12, h, w) f32 = [ch 0..2, box
// means 0..2, inverse covariance rr rg rb gg gb bb], out (B, 4, D, h, w).
// Grid (ceil(w/TW), ceil(h/TH), B*D), one block per output tile and slice.
// (Built with -DPSM_K1_DCH=n, a block walks n slices of one view in turn.)

#include <cuda_runtime.h>

#include "fgf_chain.cuh"

// k = 17: threads a block, outputs a thread in the horizontal passes (1 =
// one output a thread, the unblocked chain), blocks an SM the registers are
// bounded for; the _S knobs are those of k = 3, 5 and 9 (the run-time k
// takes _S's threads and one output a thread)
#ifndef PSM_K1_NT
#define PSM_K1_NT 256
#endif
#ifndef PSM_K1_RH
#define PSM_K1_RH 4
#endif
#ifndef PSM_K1_MINB
#define PSM_K1_MINB 2
#endif
#ifndef PSM_K1_NT_S
#define PSM_K1_NT_S 128
#endif
#ifndef PSM_K1_RH_S
#define PSM_K1_RH_S 4
#endif
#ifndef PSM_K1_MINB_S
#define PSM_K1_MINB_S 2
#endif
// disparities a block walks in turn (1: a block a slice; a timing variant)
#ifndef PSM_K1_DCH
#define PSM_K1_DCH 1
#endif

namespace {

constexpr int TH = 32;
constexpr int TW = 32;

struct StoreMaps {
  float* out;   // the view's (4, D, h, w) maps at this slice and tile origin
  size_t cstride;
  int w;
  __device__ void operator()(int c, int ty, int tx, float v) const {
    out[c * cstride + (size_t)ty * w + tx] = v;
  }
};

template <int K, int NT, int RH, int MINB>
__global__ void __launch_bounds__(NT, MINB)
lowmaps_kernel(const float* __restrict__ p, const float* __restrict__ stats,
               float* __restrict__ out, int D, int h, int w, int k,
               float inv_k2) {
  extern __shared__ __align__(16) float smem[];
  const int kk = K > 0 ? K : k;       // the box size, at compile time where K is
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int nch = (D + PSM_K1_DCH - 1) / PSM_K1_DCH;
  const int b = blockIdx.z / nch, c = blockIdx.z - b * nch;
  const size_t hw = (size_t)h * w;
  const float* st = stats + (size_t)b * 12 * hw;
  const int tid = threadIdx.x;
  const int M = 2 * (kk / 2);

  for (int d = c * PSM_K1_DCH; d < min(D, (c + 1) * PSM_K1_DCH); ++d) {
    if (d > c * PSM_K1_DCH) __syncthreads();   // the last d's emits have read
    const float* ps = p + ((size_t)b * D + d) * hw;
    // band of p and ch_c * p
    for (int i = tid; i < (TH + 2 * M) * (TW + 2 * M); i += NT) {
      int iy, ix;
      fgf::band_index(i, TW, kk, y0, x0, h, w, &iy, &ix);
      const size_t o = (size_t)iy * w + ix;
      fgf::band_store(smem, TH, TW, kk, i, ps[o], st[o], st[hw + o], st[2 * hw + o]);
    }
    const StoreMaps store{out + ((size_t)b * 4 * D + d) * hw + (size_t)y0 * w + x0,
                          (size_t)D * hw, w};
    fgf::chain<NT, K, StoreMaps, fgf::BlockSync, RH>(
        smem, st, h, w, kk, inv_k2, TH, TW, y0, x0, min(TH, h - y0), min(TW, w - x0), tid,
        store);
  }
}

template <int K, int NT, int RH, int MINB>
int launch(const float* p, const float* stats, float* out, int B, int D, int h,
           int w, int k, float inv_k2, cudaStream_t stream) {
  constexpr int rh = K > 0 ? RH : 1;
  const size_t smem = sizeof(float) * fgf::chain_floats(TH, TW, k, rh);
  cudaError_t err = cudaFuncSetAttribute(
      lowmaps_kernel<K, NT, rh, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B * ((D + PSM_K1_DCH - 1) / PSM_K1_DCH));
  lowmaps_kernel<K, NT, rh, MINB><<<grid, NT, smem, stream>>>(p, stats, out, D, h, w, k,
                                                               inv_k2);
  return (int)cudaGetLastError();
}

}  // namespace

// The boxes of subsample 8, 4, 2 and 1 at gif_radius 8 are instantiated;
// any other odd k takes the run-time instance.
extern "C" int psm_lowmaps(const float* p, const float* stats, float* out,
                           int B, int D, int h, int w, int k, float inv_k2,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PSM_LOWMAPS_SMALL(K) \
  launch<K, PSM_K1_NT_S, PSM_K1_RH_S, PSM_K1_MINB_S>(p, stats, out, B, D, h, w, k, inv_k2, s)
  switch (k) {
    case 3: return PSM_LOWMAPS_SMALL(3);
    case 5: return PSM_LOWMAPS_SMALL(5);
    case 9: return PSM_LOWMAPS_SMALL(9);
    case 17:
      return launch<17, PSM_K1_NT, PSM_K1_RH, PSM_K1_MINB>(p, stats, out, B, D, h, w, k,
                                                         inv_k2, s);
    default: return PSM_LOWMAPS_SMALL(0);
  }
#undef PSM_LOWMAPS_SMALL
}
