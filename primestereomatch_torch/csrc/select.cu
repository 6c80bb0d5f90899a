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
// What bounds it: reading S once (4 bytes per pixel and d: the int32 S or
// two uint16 partials) against ~12 integer operations per value (2 to add
// the partials, 3 for the argmin, 7 for the far set and S[d_best +- 1]):
// bytes at 2K; where the costs sit in L2 (Teddy), the instructions a
// pixel. So the design reads each value once, keeps bytes in flight and
// spends few instructions a pixel outside the per-value work:
//   * A group of G lanes takes one pixel (G = LANES on the vector route,
//     32 on the scalar one); a warp holds 32 / G pixels at once,
//     a block one image row. A pixel's D values are contiguous, so on the
//     vector route each lane loads 16-byte vectors (8 uint16 of each
//     partial, or 4 int32), neighbouring lanes on neighbouring vectors, and
//     keeps VPL summed values in registers; a lane's values ascend in d.
//     The vector route needs D % 8 == 0 (uint16) or D % 4 == 0 (int32) and
//     16-byte aligned tensors; other D take the scalar route, lanes on
//     neighbouring values.
//   * One pass over the costs: the lane-local first minimum (strict <, d
//     ascending), folded over the group by (value, d) shuffles; then, from
//     the same registers, the far-set minimum (|d - d_best| > 1, from BIG,
//     the reference's sentinel) and S[d_best -+ 1] (the lanes that hold
//     them give them to the group by a sum of shuffles; reading them back
//     after the fold was a dependent L1/L2 round trip a round). Where D
//     exceeds what the group holds at once (G * VPL values), the pixel is
//     walked in chunks and the far pass reads the chunks again (L1/L2): off
//     the main path.
//   * The pixel's tail runs batched: lane r % G of a group keeps round r's
//     (s_best, d_best, far minimum, S[d_best -+ 1]), and after G rounds the
//     warp finishes 32 pixels at once, one a lane (the tail is ~70
//     instructions a warp whatever lanes are active, so finishing 32 in
//     place of 32 / G pixels a round cuts the instructions a pixel, which
//     bound the kernel where the costs sit in L2). The tail: the integer
//     divide (C's `/` truncates as the reference's formula wants; the TPU
//     kernel's f32 quotient with a fix-up exists because its vector unit
//     has none), the disparity and the scatter candidate into shared
//     memory.
//   * The scatter disp2[x - d_best - minD] = the candidate with the lowest
//     s_best, ties to the smaller d, is an atomicMin in shared memory on
//     the 64-bit key (s_best as order-preserving unsigned << 32) | d_best:
//     exact and independent of the order of the atomics. As in the
//     reference, whose costs there start at BIG, a candidate with s_best
//     >= BIG is not scattered. Every min_disparity is taken, negative
//     included (the TPU kernel raises there).
//   * The LR check reads disp2 at x - floor(d) and x - ceil(d) from shared
//     memory.
//
// Layout: S or each partial (H, W, D), out (H, W) int16. Grid H, `threads`
// a block (a run-time argument, at most MAX_THREADS), 12 bytes of shared
// memory per column. kernels/select.py::launch_shape mirrors the route,
// the lanes, the values a lane holds and MAX_THREADS; change both
// together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr int NO_D = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int MAX_THREADS = 512;
constexpr int LANES = 8;           // lanes a pixel on the vector route
constexpr int SCALAR_LANES = 32;

__device__ __forceinline__ int wrap_mul(int a, int b) {
  // int32 multiply with two's-complement wrap, as the reference's int32 math
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// One value of the aggregated cost: NP = 0 the int32 S, NP = 1 or 2 that
// many uint16 partials, summed.
template <int NP>
__device__ __forceinline__ int cost_at(const void* a, const void* b, int d) {
  if (NP == 0) return ((const int*)a)[d];
  if (NP == 1) return ((const uint16_t*)a)[d];
  return (int)((const uint16_t*)a)[d] + (int)((const uint16_t*)b)[d];
}

// The low and high uint16 of a word of each partial, summed.
template <int NP>
__device__ __forceinline__ void add_words(unsigned wa, unsigned wb, int& lo, int& hi) {
  lo = (int)(wa & 0xffffu) + (NP == 2 ? (int)(wb & 0xffffu) : 0);
  hi = (int)(wa >> 16) + (NP == 2 ? (int)(wb >> 16) : 0);
}

// The values a lane holds of chunk c: vector v of lane j starts at element
// c * G * VPL + (v * G + j) * VEC. Vectors at or beyond D (and every vector
// of an inactive group) are not read.
template <int NP, int VEC, int G, int VPL>
__device__ __forceinline__ void load_chunk(const void* a, const void* b, int c, int j, int D,
                                           bool active, int (&s)[VPL]) {
  constexpr int NV = VPL / VEC;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e0 = c * G * VPL + (v * G + j) * VEC;
    const bool ok = active && e0 < D;
    if (VEC == 1) {
      s[v] = ok ? cost_at<NP>(a, b, e0) : 0;
    } else if (NP == 0) {
      const int4 q = ok ? __ldg((const int4*)a + e0 / 4) : make_int4(0, 0, 0, 0);
      s[4 * v] = q.x; s[4 * v + 1] = q.y; s[4 * v + 2] = q.z; s[4 * v + 3] = q.w;
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      const uint4 qa = ok ? __ldg((const uint4*)a + e0 / 8) : z;
      const uint4 qb = ok && NP == 2 ? __ldg((const uint4*)b + e0 / 8) : z;
      add_words<NP>(qa.x, qb.x, s[8 * v], s[8 * v + 1]);
      add_words<NP>(qa.y, qb.y, s[8 * v + 2], s[8 * v + 3]);
      add_words<NP>(qa.z, qb.z, s[8 * v + 4], s[8 * v + 5]);
      add_words<NP>(qa.w, qb.w, s[8 * v + 6], s[8 * v + 7]);
    }
  }
}

// NP: 0 int32 S, 1-2 uint16 partials; VEC: values a load (1: the scalar
// route); G lanes a pixel; VPL values a lane holds at once.
template <int NP, int VEC, int G, int VPL>
__global__ void __launch_bounds__(MAX_THREADS)
select_kernel(const void* __restrict__ Sa, const void* __restrict__ Sb,
              int16_t* __restrict__ out, int H, int W, int D, int uniq, int d12, int minD) {
  constexpr int NV = VPL / VEC;
  constexpr int CH = G * VPL;             // values a group holds at once
  constexpr int PPW = 32 / G;             // pixels a warp
  extern __shared__ unsigned char smem[];
  unsigned long long* key2 = (unsigned long long*)smem;   // [W]
  int* disp = (int*)(key2 + W);                             // [W]
  const int y = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j = lane % G, g = lane / G;
  const int minX1 = max(minD + D, 0);
  const int maxX1 = W + min(minD, 0);
  const int inv = (minD - 1) * 16;
  const int n_chunks = (D + CH - 1) / CH;
  const size_t elt = NP == 0 ? sizeof(int) : sizeof(uint16_t);

  for (int x = tid; x < W; x += nt) key2[x] = NO_KEY;
  __syncthreads();

  // the pixel's tail (uniqueness, the sub-pixel step with its divide, the
  // scatter) for the pixel a lane keeps
  auto finish = [&](int x, int bv, int bd, int alt, int sm, int sp) {
    const bool not_unique = alt < BIG && wrap_mul(alt, 100 - uniq) < wrap_mul(bv, 100);
    int frac = 0;
    if (bd > 0 && bd < D - 1) {
      const int denom2 = max(wrap_sub(wrap_add(sm, sp), wrap_mul(2, bv)), 1);
      const int num = wrap_add(wrap_mul(wrap_sub(sm, sp), 16), denom2);
      frac = num / wrap_mul(2, denom2);       // C division truncates
    }
    const bool valid0 = x >= minX1 && x < maxX1 && !not_unique;
    disp[x] = valid0 ? (bd + minD) * 16 + frac : inv;
    const int xr = x - bd - minD;
    // the reference's right-view costs start at BIG: a candidate at or
    // above it never takes
    if (valid0 && bv < BIG && xr >= 0 && xr < W) {
      const unsigned long long key =
          ((unsigned long long)((unsigned)bv ^ 0x80000000u) << 32) | (unsigned)bd;
      atomicMin(&key2[xr], key);
    }
  };

  // every lane of a warp runs every round (the shuffles take the whole
  // warp); a group past the row's end reads nothing. Lane r % G of a group
  // keeps round r's pixel, so after G rounds each lane holds one and the
  // warp runs the tail for 32 pixels at once
  const int step = (nt >> 5) * PPW;
  int my_x = -1, my_bv = 0, my_bd = 0, my_alt = 0, my_sm = 0, my_sp = 0;
  for (int x0 = warp * PPW, r = 0; x0 < W; x0 += step, ++r) {
    const int x = x0 + g;
    const bool active = x < W;
    const size_t at = ((size_t)y * W + x) * D * elt;
    const void* a = (const char*)Sa + at;
    const void* b = NP == 2 ? (const void*)((const char*)Sb + at) : nullptr;
    int s[VPL];
    // first minimum: lane-local ascending d, then (value, d) shuffles
    int bv = 0x7fffffff, bd = NO_D;
    for (int c = 0; c < n_chunks; ++c) {
      load_chunk<NP, VEC, G, VPL>(a, b, c, j, D, active, s);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int e0 = c * CH + (v * G + j) * VEC;
        if (e0 < D) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if (s[v * VEC + k] < bv) { bv = s[v * VEC + k]; bd = e0 + k; }
          }
        }
      }
    }
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1) {
      const int ov = __shfl_xor_sync(FULL, bv, m);
      const int od = __shfl_xor_sync(FULL, bd, m);
      if (ov < bv || (ov == bv && od < bd)) { bv = ov; bd = od; }
    }
    // no value below INT_MAX: every value is INT_MAX, the first min is d = 0
    if (bd == NO_D) bd = 0;
    // the min over |d - d_best| > 1, from BIG (the reference's sentinel),
    // and S[d_best -+ 1], from the registers (the chunks read again where
    // there are several)
    int alt = BIG, sm = 0, sp = 0;
    for (int c = n_chunks - 1; c >= 0; --c) {
      if (c != n_chunks - 1) load_chunk<NP, VEC, G, VPL>(a, b, c, j, D, active, s);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int e0 = c * CH + (v * G + j) * VEC;
        if (e0 < D) {
          const int lo = bd - 1 - e0;   // element k is far where k < lo or k > lo + 2
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const unsigned u = (unsigned)(k - lo);
            if (u > 2u) alt = min(alt, s[v * VEC + k]);
            sm = u == 0u ? s[v * VEC + k] : sm;
            sp = u == 2u ? s[v * VEC + k] : sp;
          }
        }
      }
    }
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1) {
      alt = min(alt, __shfl_xor_sync(FULL, alt, m));
      // one lane holds each of S[d_best -+ 1] (0 elsewhere): a sum
      sm = wrap_add(sm, __shfl_xor_sync(FULL, sm, m));
      sp = wrap_add(sp, __shfl_xor_sync(FULL, sp, m));
    }
    if (active && j == (r & (G - 1))) {
      my_x = x; my_bv = bv; my_bd = bd; my_alt = alt; my_sm = sm; my_sp = sp;
    }
    if ((r & (G - 1)) == G - 1 || x0 + step >= W) {   // warp-uniform
      if (my_x >= 0) finish(my_x, my_bv, my_bd, my_alt, my_sm, my_sp);
      my_x = -1;
    }
  }
  __syncthreads();

  int16_t* orow = out + (size_t)y * W;
  for (int x = tid; x < W; x += nt) {
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

template <int NP, int VEC, int G, int VPL>
cudaError_t launch(const void* Sa, const void* Sb, int16_t* out, int H, int W, int D, int uniq,
                   int d12, int minD, int threads, cudaStream_t s) {
  const size_t smem = (size_t)W * (sizeof(unsigned long long) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel<NP, VEC, G, VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  select_kernel<NP, VEC, G, VPL><<<H, threads, smem, s>>>(Sa, Sb, out, H, W, D, uniq, d12, minD);
  return cudaGetLastError();
}

// The instance of the route (vector or scalar) and of the values a lane
// holds (vector: 8, 16 or 32; scalar: 8), for NP inputs.
template <int NP>
cudaError_t dispatch(const void* Sa, const void* Sb, int16_t* out, int H, int W, int D, int uniq,
                     int d12, int minD, int vector, int vpl, int threads, cudaStream_t s) {
  constexpr int VEC = NP == 0 ? 4 : 8;
  if (vector) {
    if (vpl == 8) return launch<NP, VEC, LANES, 8>(Sa, Sb, out, H, W, D, uniq, d12, minD, threads, s);
    if (vpl == 16) return launch<NP, VEC, LANES, 16>(Sa, Sb, out, H, W, D, uniq, d12, minD, threads, s);
    if (vpl == 32) return launch<NP, VEC, LANES, 32>(Sa, Sb, out, H, W, D, uniq, d12, minD, threads, s);
  } else if (vpl == 8) {
    return launch<NP, 1, SCALAR_LANES, 8>(Sa, Sb, out, H, W, D, uniq, d12, minD, threads, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// n_partials = 0: Sa is the int32 S; 1 or 2: Sa (and Sb) are uint16 group
// partials whose sum is S. vector, values_per_lane and threads are the
// launch shape of kernels/select.py::launch_shape.
extern "C" int psm_select_disparity(const void* Sa, const void* Sb, int n_partials,
                                    int16_t* out, int H, int W, int D, int uniq, int d12,
                                    int minD, int vector, int values_per_lane, int threads,
                                    void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  if (D <= 0 || threads <= 0 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int v = vector, vpl = values_per_lane;
  if (n_partials == 0) return (int)dispatch<0>(Sa, Sb, out, H, W, D, uniq, d12, minD, v, vpl, threads, s);
  if (n_partials == 1) return (int)dispatch<1>(Sa, Sb, out, H, W, D, uniq, d12, minD, v, vpl, threads, s);
  if (n_partials == 2) return (int)dispatch<2>(Sa, Sb, out, H, W, D, uniq, d12, minD, v, vpl, threads, s);
  return (int)cudaErrorInvalidValue;
}
