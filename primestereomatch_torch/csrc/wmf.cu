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
// arithmetic is the bound, by far. What the card needs for it is many warps
// per SM and a short inner loop, so the design keeps little state per
// thread and reads its neighbours from shared memory:
//
//   * A block is a TW x TH rectangle of output pixels, one thread each. It
//     stages the haloed (TH + 2r) x (TW + 2r) region once as one 32-bit
//     word per pixel: the three 6-bit colours in bytes 0-2 and the
//     disparity from bit 22 up. A pixel that adds nothing (outside the
//     image, or d >= n_bins) carries NO_D there, which lies in no bin
//     window, so the inner loop needs no bounds tests.
//   * The squared colour distance is an integer in [0, 3 * 63^2]: a
//     per-byte absolute difference and one dp4a. The weight comes from a
//     table of expf(-(float)dist2 * inv_two_sig2) that a small kernel of
//     this file fills with the device's own expf before the filter runs
//     (48 KB, read through L1: measured faster than a copy of its head in
//     shared memory, whose banks the bins need). The bits are those of
//     the plain version
//     (ops/jointwmf.py): there e*e for integer e <= 63 and the sum of
//     three such products are exact in float32, so its dist2 is the same
//     integer as a float, and the table holds the same expf of the same
//     product. A subnormal weight (dist2 above ~7100 at sigma 25.5) is
//     stored as 0: the plain version adds its weights with scatter_add_,
//     a float atomic add, which on the card flushes subnormal operands to
//     zero. It decides a median only where a window holds nothing else
//     (a centre pixel with d >= n_bins and every binned neighbour that far
//     in colour); the pipeline's disparities are all below n_bins.
//   * No thread holds n_bins floats. Each bin's weight h_k is the sum of
//     its weights in row-major window-offset order and does not depend on
//     the other bins, so a thread sums NB bins at a time (NB floats of
//     shared memory, bin-major: conflict-free). A bin that no pixel of
//     the block's haloed tile holds is an exact zero in every histogram of
//     the block, and cum + 0.0f is cum, so only the tile's own levels need
//     windows. The block reduces the least and greatest disparity [dmin,
//     dmax] of its haloed tile. Where dmax - dmin < NB one window starting
//     at dmin holds them all. Otherwise the block flags the levels its
//     words carry, ranks them (an exclusive prefix count over the 256
//     flags, one warp), rewrites each word's disparity to its rank, and sums
//     windows of NB ranks: a block at an edge between two far levels makes
//     one pass where the range [dmin, dmax] would take up to five. The
//     median's rank maps back through the list of levels. In what follows,
//     "bin" is the block's bin: the disparity less dmin, or the rank.
//     Sweep A takes the windows in order: one pass over the offsets
//     adds those whose d falls in the window, then the running cumulative
//     sum cum_k = fl(cum_{k-1} + h_k) goes on through the window's bins
//     and its value at the window's end is kept in a register. After the
//     last window cum is the plain version's total, bit for bit. Sweep B
//     sums again the one window in which cum crosses half the total
//     (unless it is the last one, whose sums are still there) and walks
//     it from the kept cum of the window before. With one window there is
//     no sweep B.
//     Adding the same weights to a bin in the same order gives the same
//     bits, and the skipped bins add exact zeros, so the medians equal the
//     plain version's at every pixel. The flags, ranks and levels are two
//     256-byte arrays of static shared memory: 3 blocks still fit an SM in
//     both modes.
//
// The participation-weight mode (the TPU kernel's has_valid, used by the
// row-sharded pipeline's zero halos; entry psm_joint_wmf_valid): every
// window weight is multiplied by a float32 plane valid[q] of nonnegative
// weights, w = wtab[dist2] * valid[q], and the output is 0 where the total
// is 0. The plain version's scatter_add_ flushes the subnormal products,
// whatever the factors, so the product is flushed, from a second table of
// the unflushed expf. A neighbour with valid == 0 (-0 too) is staged as
// NO_D: its product would add +0.0, which changes no bin's bits.
// What costs here is residency, not the multiply: the block also stages
// the plane's haloed tile, and the window ends' cums are kept in registers
// (not shared memory) so that 3 blocks still fit an SM, as in the
// valid-less mode. The driven planes are 0 or 1 everywhere (the mesh's
// zero halo rows): times 1.0f a weight is itself, and flushing it gives
// the flushed table's entry. So the staging loop also tests every plane
// value of the haloed tile for exactly 0 or 1, the barrier after it ANDs
// the test over the block, and such a block runs the valid-less inner
// loop on the flushed table; any other value (0.99999994f, a subnormal,
// NaN) sends its block to the multiply-and-flush loop. The choice is the
// block's, on the card: the wrapper never reads the plane.
//
// Layout: disp (B, H, W) uint8, guide (B, H, W, 3) uint8, valid (B, H, W)
// float32 (valid mode), out (B, H, W) uint8, wtab float scratch: N_DIST2
// flushed entries, then (valid mode) N_DIST2 unflushed ones.
// Grid (ceil(W/TW), ceil(H/TH), B).

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

// The tile's height, the bin window and the look-ahead are -D knobs for
// tune_wmf.py, which times other values on the card; kernels/wmf.py holds
// the same defaults for its pass counter.
#ifndef PSM_WMF_TH
#define PSM_WMF_TH 8
#endif
#ifndef PSM_WMF_NB
#define PSM_WMF_NB 64
#endif
#ifndef PSM_WMF_U
#define PSM_WMF_U 4
#endif

namespace {

constexpr int TW = 32, TH = PSM_WMF_TH;    // a warp is one row of the tile
constexpr int NT = TW * TH;
constexpr int NB = PSM_WMF_NB;             // bins a thread sums at a time
constexpr int MAXWIN = (256 + NB - 1) / NB;
constexpr int N_DIST2 = 3 * 63 * 63 + 1;   // every squared distance of 6-bit colours
constexpr int U = PSM_WMF_U;               // offsets looked up before their sums
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr unsigned NO_D = 1023;            // in no bin window
constexpr unsigned CMASK = 0x003f3f3fu;
constexpr unsigned FULL = 0xffffffffu;

// The table with subnormal entries stored as 0 (the weights of the
// valid-less mode and of a unit plane); VALID: then the unflushed entries,
// whose products the multiply-and-flush loop flushes.
template <bool VALID>
__global__ void wmf_weights_kernel(float* __restrict__ wtab, float inv_two_sig2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N_DIST2) {
    const float w = expf(-(float)i * inv_two_sig2);
    wtab[i] = w >= FLT_MIN ? w : 0.0f;
    if constexpr (VALID) wtab[N_DIST2 + i] = w;
  }
}

// Sum the bins [lo, lo + NB) of one pixel over its window, in row-major
// offset order. hp: the thread's bins (stride NT); t0: the window's first
// word in the tile. U offsets are read and weighted before their sums are
// added, so the table reads of a group are in flight together. MUL: each
// weight times the participation weight at v0's offset, flushed.
template <bool MUL>
__device__ __forceinline__ void sum_window(float* __restrict__ hp,
                                           const uint32_t* __restrict__ t0,
                                           const float* __restrict__ v0, int tw, int k2,
                                           uint32_t cw, unsigned lo,
                                           const float* __restrict__ wtab) {
#pragma unroll 8
  for (int k = 0; k < NB; ++k) hp[k * NT] = 0.0f;
  for (int oy = 0; oy < k2; ++oy) {
    const uint32_t* tr = t0 + oy * tw;
    const float* vr = v0 + oy * tw;
    for (int ox = 0; ox < k2; ox += U) {
      unsigned k[U];
      float w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t q = ox + u < k2 ? tr[ox + u] : NO_D << 22;
        k[u] = (q >> 22) - lo;
        w[u] = 0.0f;
        if (k[u] < (unsigned)NB) {
          const unsigned e = __vabsdiffu4(cw, q & CMASK);
          w[u] = __ldg(wtab + __dp4a(e, e, 0u));
          if constexpr (MUL) {
            w[u] = w[u] * vr[ox + u];
            if (fabsf(w[u]) < FLT_MIN) w[u] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k[u] < (unsigned)NB) hp[k[u] * NT] += w[u];
    }
  }
}

// The cum at the end of each bin window but the last, as named scalars
// kept in registers: an array here, even indexed only from unrolled loops,
// was compiled to indexed loads from local memory (LDL in cuobjdump -sass).
// Fields past MAXWIN - 1 stay constant zeros.
static_assert(MAXWIN <= 8, "Ends holds at most 7 window ends");
struct Ends {
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, e3 = 0.0f, e4 = 0.0f, e5 = 0.0f, e6 = 0.0f;
  __device__ __forceinline__ void set(int w, float c) {
    e0 = MAXWIN > 1 && w == 0 ? c : e0;
    e1 = MAXWIN > 2 && w == 1 ? c : e1;
    e2 = MAXWIN > 3 && w == 2 ? c : e2;
    e3 = MAXWIN > 4 && w == 3 ? c : e3;
    e4 = MAXWIN > 5 && w == 4 ? c : e4;
    e5 = MAXWIN > 6 && w == 5 ? c : e5;
    e6 = MAXWIN > 7 && w == 6 ? c : e6;
  }
  __device__ __forceinline__ float get(int w) const {
    return w == 0 ? e0 : w == 1 ? e1 : w == 2 ? e2 : w == 3 ? e3 : w == 4 ? e4 : w == 5 ? e5 : e6;
  }
};

// One pixel's median bin over the bin windows [dmin + w * NB, + NB),
// w < nwin; -1 where its total weight is 0.
template <bool MUL>
__device__ __forceinline__ int median(float* __restrict__ hp, const uint32_t* __restrict__ t0,
                                      const float* __restrict__ v0, int tw, int k2,
                                      uint32_t cw, int dmin, int nwin,
                                      const float* __restrict__ wtab) {
  // sweep A: every window in order; cum runs on through the bins
  Ends ends;
  float cum = 0.0f;
  for (int w = 0; w < nwin; ++w) {
    sum_window<MUL>(hp, t0, v0, tw, k2, cw, (unsigned)(dmin + w * NB), wtab);
#pragma unroll 8
    for (int k = 0; k < NB; ++k) cum += hp[k * NT];
    ends.set(w, cum);
  }
  const float half = cum * 0.5f;
  if (!(half > 0.0f)) return -1;   // cum_0 = 0 >= half already
  // the window of the crossing: the first whose end reaches half, else the last
  int wb = nwin - 1;
#pragma unroll
  for (int j = MAXWIN - 2; j >= 0; --j)
    if (j < nwin - 1 && ends.get(j) >= half) wb = j;
  // sweep B: the window of the crossing again, unless its sums are still there
  if (wb != nwin - 1)
    sum_window<MUL>(hp, t0, v0, tw, k2, cw, (unsigned)(dmin + wb * NB), wtab);
  cum = wb ? ends.get(wb - 1) : 0.0f;
  int k = 0;
  for (; k < NB - 1; ++k) {
    cum += hp[k * NT];
    if (cum >= half) break;
  }
  return dmin + wb * NB + k;
}

// The explicit 1 block an SM is not the default: with the thread count
// alone ptxas held both entries to 32 registers, which made the valid-less
// entry ~8% slower (tune_wmf.py valid on an H100); with it they take 42 /
// 37 and 3 blocks still fit an SM.
template <bool VALID>
__global__ void __launch_bounds__(NT, 1)
joint_wmf_kernel(const uint8_t* __restrict__ disp, const uint8_t* __restrict__ guide,
                 const float* __restrict__ valid, uint8_t* __restrict__ out,
                 const float* __restrict__ wtab, int H, int W, int r, int n_bins) {
  extern __shared__ float smem[];
  float* hist = smem;                                   // [NB][NT]
  uint32_t* tile = (uint32_t*)(hist + NB * NT);         // [TH + 2r][TW + 2r]
  float* vtile = (float*)(tile + (TH + 2 * r) * (TW + 2 * r));   // VALID: the same shape
  __shared__ int s_dmin, s_dmax, s_levels;
  __shared__ uint8_t s_rank[256];   // 1 where a level takes part; then its rank
  __shared__ uint8_t s_level[256];  // the level of each rank

  const int tid = threadIdx.x;
  const int tx = tid % TW, ty = tid / TW;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tw = TW + 2 * r, th = TH + 2 * r;
  const size_t img = (size_t)blockIdx.z * H * W;
  const uint8_t* db = disp + img;
  const uint8_t* gb = guide + img * 3;

  if (tid == 0) {
    s_dmin = 1 << 30;
    s_dmax = -1;
  }
  for (int d = tid; d < 256; d += NT) s_rank[d] = 0;
  __syncthreads();

  int mn = 1 << 30, mx = -1;
  bool unit = true;        // VALID: every plane value this thread staged is 0 or 1
  for (int i = tid; i < tw * th; i += NT) {
    const int yy = y0 - r + i / tw, xx = x0 - r + i % tw;
    uint32_t word = NO_D << 22;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const size_t q = (size_t)yy * W + xx;
      unsigned d = db[q];
      bool takes_part = true;
      if constexpr (VALID) {
        const float v = valid[img + q];
        vtile[i] = v;
        takes_part = v != 0.0f;
        unit = unit && (v == 0.0f || v == 1.0f);
      }
      if (d < (unsigned)n_bins && takes_part) {
        mn = min(mn, (int)d);
        mx = max(mx, (int)d);
      } else {
        d = NO_D;
      }
      const uint8_t* g = gb + q * 3;
      word = (uint32_t)(g[0] >> 2) | ((uint32_t)(g[1] >> 2) << 8) |
             ((uint32_t)(g[2] >> 2) << 16) | (d << 22);
    }
    tile[i] = word;
  }
  mn = __reduce_min_sync(FULL, mn);
  mx = __reduce_max_sync(FULL, mx);
  if ((tid & 31) == 0) {
    atomicMin(&s_dmin, mn);
    atomicMax(&s_dmax, mx);
  }
  // the barrier also ANDs the plane test over the block
  const bool unit_plane = __syncthreads_and(unit);

  const int dmax = s_dmax;
  int dmin = s_dmin, nwin = (dmax - dmin) / NB + 1;
  const bool ranked = nwin > 1;     // the same in every thread of the block
  if (ranked) {
    for (int i = tid; i < tw * th; i += NT) {
      const unsigned d = tile[i] >> 22;
      if (d != NO_D) s_rank[d] = 1;
    }
    __syncthreads();
    if (tid < 32) {                 // warp 0 ranks the flags, 32 levels a step
      const unsigned below = (1u << tid) - 1u;
      int n = 0;
      for (int d0 = dmin & ~31; d0 <= dmax; d0 += 32) {
        const int d = d0 + tid;
        const bool on = s_rank[d] != 0;
        const unsigned m = __ballot_sync(FULL, on);
        if (on) {
          const int k = n + __popc(m & below);
          s_rank[d] = (uint8_t)k;
          s_level[k] = (uint8_t)d;
        }
        n += __popc(m);
      }
      if (tid == 0) s_levels = n;
    }
    __syncthreads();
    for (int i = tid; i < tw * th; i += NT) {
      const uint32_t word = tile[i];
      const unsigned d = word >> 22;
      if (d != NO_D) tile[i] = (word & ~(NO_D << 22)) | ((uint32_t)s_rank[d] << 22);
    }
    dmin = 0;
    nwin = (s_levels - 1) / NB + 1;
    __syncthreads();
  }

  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  uint8_t* o = out + img + (size_t)y * W + x;
  if (dmax < 0) {          // nothing in the tile has a bin: every total is 0
    *o = 0;
    return;
  }
  const int k2 = 2 * r + 1;
  const uint32_t* t0 = tile + ty * tw + tx;
  const float* v0 = vtile + ty * tw + tx;
  const uint32_t cw = t0[r * tw + r] & CMASK;
  float* hp = hist + tid;
  const int b = VALID && !unit_plane
                    ? median<true>(hp, t0, v0, tw, k2, cw, dmin, nwin, wtab + N_DIST2)
                    : median<false>(hp, t0, v0, tw, k2, cw, dmin, nwin, wtab);
  *o = b < 0 ? 0 : ranked ? s_level[b] : (uint8_t)b;
}

// Bytes of dynamic shared memory a block needs at window radius r: the bins,
// the words and (VALID) the plane's tile.
long long smem_bytes(int r, bool valid) {
  const long long halo = (long long)(TH + 2 * r) * (TW + 2 * r);
  return 4 * ((long long)NB * NT + halo * (valid ? 2 : 1));
}

// Let the filter take smem bytes of dynamic shared memory, the SM's
// carveout all shared memory (so that 3 blocks fit at r = 9).
template <bool VALID>
cudaError_t allow_smem(int smem) {
  cudaError_t err = cudaFuncSetAttribute(joint_wmf_kernel<VALID>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(joint_wmf_kernel<VALID>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool VALID>
int launch(const uint8_t* disp, const uint8_t* guide, const float* valid, uint8_t* out,
           float* wtab, int B, int H, int W, int r, int n_bins, float inv_two_sig2,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (r < 0 || n_bins < 1 || n_bins > 256) return (int)cudaErrorInvalidValue;
  if (smem_bytes(r, VALID) + 640 > SMEM_LIMIT) return -1;   // 640: the static part
  const int smem = (int)smem_bytes(r, VALID);
  cudaStream_t s = (cudaStream_t)stream;
  wmf_weights_kernel<VALID><<<(N_DIST2 + 255) / 256, 256, 0, s>>>(wtab, inv_two_sig2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem<VALID>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  joint_wmf_kernel<VALID><<<grid, NT, smem, s>>>(disp, guide, valid, out, wtab, H, W, r,
                                                 n_bins);
  return (int)cudaGetLastError();
}

template <bool VALID>
int blocks_per_sm(int r) {
  if (r < 0 || smem_bytes(r, VALID) + 640 > SMEM_LIMIT) return -1;
  const int smem = (int)smem_bytes(r, VALID);
  int n = 0;
  if (allow_smem<VALID>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, joint_wmf_kernel<VALID>, NT, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// Returns -1 where the haloed tile of radius r does not fit a block's shared
// memory, else the cudaError_t of the launch. wtab: N_DIST2 floats.
extern "C" int psm_joint_wmf(const uint8_t* disp, const uint8_t* guide, uint8_t* out,
                             float* wtab, int B, int H, int W, int r, int n_bins,
                             float inv_two_sig2, void* stream) {
  return launch<false>(disp, guide, nullptr, out, wtab, B, H, W, r, n_bins, inv_two_sig2,
                       stream);
}

// The participation-weight mode: valid (B, H, W) float32 multiplies every
// window weight; 0 where a pixel's total weight is 0. wtab: 2 * N_DIST2
// floats. Returns as above.
extern "C" int psm_joint_wmf_valid(const uint8_t* disp, const uint8_t* guide,
                                   const float* valid, uint8_t* out, float* wtab, int B,
                                   int H, int W, int r, int n_bins, float inv_two_sig2,
                                   void* stream) {
  return launch<true>(disp, guide, valid, out, wtab, B, H, W, r, n_bins, inv_two_sig2,
                      stream);
}

// Blocks of the filter (valid != 0: of the participation-weight mode) that
// one SM holds at window radius r, as the runtime's occupancy calculator
// gives them under the launch's shared-memory attributes; -1 on an error.
extern "C" int psm_joint_wmf_blocks_per_sm(int valid, int r) {
  return valid ? blocks_per_sm<true>(r) : blocks_per_sm<false>(r);
}
