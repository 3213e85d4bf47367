// FAST-16 corner score + strict 3x3 non-maximum suppression (K4).
//
// Replaces the Pallas kernel gmmloc_tpu/features/pallas_kernels.py
// fast_score_nms_pallas (_fast_nms_kernel): for every pixel of a (H,W)
// float32 image -- on the main path the stacked pyramid atlas of both
// stereo images, 4420 x 752, in one launch per frame:
//   - the 16 ring differences d_k = I(ring_k) - I(p) (radius-3 circle);
//   - for bright (d) and dark (-d), the max over the 16 circular 9-arcs
//     of the arc minimum, kept where it is > FAST_TH_LOW (7);
//   - zero in the 3 px border of the whole image;
//   - the score survives only where it is >= the 8-neighbour max + 1e-6.
// Every step is a float32 subtract, min, max, compare or the one add, so
// the result equals the plain version (features/fast.py nms3x3(fast_score))
// bit for bit, edges included: border pixels are 0 in both, and no
// in-border score reads across an edge. The kernel knows nothing of the
// atlas's levels: a level seam is an edge of the picture like any other.
//
// What bounds it on the card (H100 SXM, per SM and clock: float32 add
// 128, float32 min/max/compare 64: NVIDIA's CUDA C++ programming manual,
// arithmetic instruction throughput, compute capability 9.0): the dense
// form of the score is 158 min/max of its 206 operations per pixel, at
// half the add rate; evaluated on every pixel of the atlas the min/max
// alone are ~0.036 ms, above the 0.008 ms the 26.6 MB take at 3.35 TB/s.
// So the operations have to become fewer, and the design makes them so,
// exactly:
//
//  1. An exact reject before the arc pass. Every circular 9-arc of the
//     16-ring holds 9 consecutive indices, so it holds index k or k+8 of
//     each antipodal pair (k, k+8), k = 0..7. Its minimum is therefore
//     <= max(d_k, d_{k+8}) for every k, and the bright term (the largest
//     arc minimum) is <= U = min_k max(d_k, d_{k+8}). Where U <= 7 the
//     bright term fails its threshold and is 0. By the same argument on
//     -d the dark term is <= -L, L = max_k min(d_k, d_{k+8}), and is 0
//     where L >= -7. That is 15 min/max per polarity in place of 79. The
//     pairs (0,8) and (4,12) come first: when they already reject every
//     lane of a warp (flat picture, the atlas's padding: 48% of the warps
//     of a rendered atlas), the warp skips the other six pairs.
//  2. No divergence on the survivors. Each warp ballots its bright and
//     its dark survivors and appends them to its own two lists in shared
//     memory (sized for every pixel the warp tests, so they cannot
//     overflow; no atomics), then walks each list densely, 32 survivors
//     a round. Every survivor writes its own slot of the score tile, so
//     the order of the lists does not matter, and a pixel is in one
//     warp's lists only, so reject and arc passes need no block barrier
//     between them.
//  3. Dark from the same differences: max over arcs of min(-d) equals
//     -(min over arcs of max(d)) exactly, so the dark list runs the
//     mirrored pass on d and negates once. The pass itself takes prefix
//     and suffix extrema of the ring's two halves: 57 min/max, not 79.
//  4. A 60 x 32 tile: its scores are needed on a 1 px ring around it for
//     the NMS, 62 x 34 / (60 x 32) = 1.10 of the pixels (1.33 for a 32 x 8
//     tile). The scored region is walked 64 columns wide, so a thread
//     keeps its column, a warp stays in one row, and no phase has a bank
//     conflict or an integer division. The tile and its 4 px halo (4
//     floats = 16 bytes, and 60 floats = 240 bytes, so rows stay 16-byte
//     aligned when W % 4 == 0) are filled with 128-bit cp.async; other
//     widths, or an image off 16 bytes, take a scalar fill. Ring offsets
//     are immediates, and the reject reads the ring pixels themselves: it
//     subtracts the centre once from each bound, not from each of the 16.
//     The NMS reads the score tile from shared memory, one column and
//     four rows per thread, and a warp writes 128 contiguous bytes a row.
//  5. Occupancy: 256 threads, 28.8 KB of shared memory (image tile 10.9
//     KB, score tile 8.7 KB, lists 9.2 KB) and 46 registers
//     (__launch_bounds__(256, 4)): 5 blocks per SM. Builds held to 40
//     registers (6 blocks) ran no faster. A 480 x 752 picture is 195
//     blocks, under two per SM: a 16-row tile (twice the blocks) ran it
//     in 0.0079 ms against 0.0089, and is not kept, since the main path
//     launches the kernel on the 4420 x 752 atlas only.
//
// What holds it now (phase stamps, GMMLOC_FAST_PROFILE): the reject is
// half of a block's life on the atlas, the fill a quarter (latency that
// other blocks cover), the NMS a sixth, the arc passes a tenth; the
// min/max pipe's share of that is ~60%, the rest is latency.

#include <cuda_runtime.h>
#include <stdint.h>

// With GMMLOC_FAST_PROFILE, thread 0 of each of the first kProfBlocks
// blocks stamps the SM's cycle counter at the phase boundaries and the
// global nanosecond timer at its start and end (tools/feature_kernel_sweep.py
// reads them through gmmloc_fast_nms_stamps); the shipped build has none.
#ifdef GMMLOC_FAST_PROFILE
constexpr int kProfBlocks = 4096;
__device__ long long g_stamps[8 * kProfBlocks];
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}
#define GMMLOC_STAMP(i, value)                                                   \
  {                                                                              \
    const int bid_ = blockIdx.y * gridDim.x + blockIdx.x;                        \
    if (threadIdx.x == 0 && bid_ < kProfBlocks) g_stamps[8 * bid_ + (i)] = (value); \
  }
#else
#define GMMLOC_STAMP(i, value)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 4;     // ring radius 3 + 1 for the NMS ring
constexpr float kThLow = 7.0f;

// Shapes of the 60 x 32 tile. The scored region (tile + 1 px ring) is
// walked 64 columns wide (two of them idle), so that a thread keeps its
// column, a warp stays inside one scored row, and rows and columns come
// from shifts.
constexpr int kTW = 60;
constexpr int kTH = 32;                     // a multiple of 4: the NMS takes 4 rows a thread
constexpr int kMapW = kTW + 4;
constexpr int kMapShift = 6;
constexpr int kRowsPerTrip = kThreads / kMapW;
constexpr int kScW = kTW + 2;               // scored columns
constexpr int kStride = kTW + 2 * kHalo;    // floats of an image tile row
constexpr int kVecRow = kStride / 4;
constexpr int kScH = kTH + 2;               // scored rows
constexpr int kTrips = (kScH + kRowsPerTrip - 1) / kRowsPerTrip;
constexpr int kSeg = 32 * kTrips;           // list entries of a warp and polarity
constexpr int kImgH = kTH + 2 * kHalo;
static_assert(kMapW == 1 << kMapShift && kStride % 4 == 0 && kTH % 4 == 0, "tile shape");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// FAST-16 ring, (index, row, col), the order of features/fast.py RING
#define GMMLOC_RING(X)                                                       \
  X(0, -3, 0) X(1, -3, 1) X(2, -2, 2) X(3, -1, 3) X(4, 0, 3) X(5, 1, 3)      \
  X(6, 2, 2) X(7, 3, 1) X(8, 3, 0) X(9, 3, -1) X(10, 2, -2) X(11, 1, -3)     \
  X(12, 0, -3) X(13, -1, -3) X(14, -2, -2) X(15, -3, -1)

// the 16 ring differences of the pixel at `ctr` of the shared image tile
__device__ __forceinline__ void ring_diffs(const float* ctr, float d[16]) {
  const float p = ctr[0];
#define GMMLOC_LOAD(k, dy, dx) d[k] = ctr[(dy) * kStride + (dx)] - p;
  GMMLOC_RING(GMMLOC_LOAD)
#undef GMMLOC_LOAD
}

// kBright: max over s of min(v[s .. s+8]) (circular), the bright term;
// else min over s of max(v[s .. s+8]), whose negation is the dark term.
// The arc from s = t (t = 0..7) is the suffix v[t..7] of the first half
// and the prefix v[8..8+t] of the second; the arc from s = 8 + t is the
// suffix v[8+t..15] and the prefix v[0..t]. Prefix and suffix extrema of
// both halves cost 26 operations, the 16 arcs 16, the outer extremum 15:
// 57, against 79 for doubling windows. min and max are exact, so the
// order does not show in the result.
template <bool kBright>
__device__ __forceinline__ float arc_best9(const float v[16]) {
  auto in = [](float a, float b) { return kBright ? fminf(a, b) : fmaxf(a, b); };
  auto outer = [](float a, float b) { return kBright ? fmaxf(a, b) : fminf(a, b); };
  float pa[8], sa[8], pb[8], sb[8];
  pa[0] = v[0];
  pb[0] = v[8];
  sa[7] = v[7];
  sb[7] = v[15];
#pragma unroll
  for (int t = 1; t < 8; ++t) {
    pa[t] = in(pa[t - 1], v[t]);
    pb[t] = in(pb[t - 1], v[8 + t]);
  }
#pragma unroll
  for (int t = 6; t >= 1; --t) {
    sa[t] = in(sa[t + 1], v[t]);
    sb[t] = in(sb[t + 1], v[8 + t]);
  }
  sa[0] = pa[7];
  sb[0] = pb[7];
  float best = in(sa[0], pb[0]);
  best = outer(best, in(sb[0], pa[0]));
#pragma unroll
  for (int t = 1; t < 8; ++t) {
    best = outer(best, in(sa[t], pb[t]));
    best = outer(best, in(sb[t], pa[t]));
  }
  return best;
}

// one antipodal pair of ring pixels into the running min of the pairs'
// maxima (hi) and max of the pairs' minima (lo)
#define GMMLOC_PAIR(dy, dx)                                        \
  {                                                                \
    const float a = ctr[(dy) * kStride + (dx)];                    \
    const float b = ctr[-(dy) * kStride - (dx)];                   \
    hi = fminf(hi, fmaxf(a, b));                                   \
    lo = fmaxf(lo, fminf(a, b));                                   \
  }

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
fast_nms_kernel(const float* __restrict__ img, int h, int w, float* __restrict__ out) {
  __shared__ __align__(16) float simg[kImgH * kStride];
  __shared__ float sscore[kScH * kMapW];
  __shared__ uint16_t slist[2 * kWarps * kSeg];   // per warp: bright, dark
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  GMMLOC_STAMP(6, global_ns())
  GMMLOC_STAMP(0, clock64())

  // image tile + 4 px halo; pixels outside the image are 0: they only feed
  // border pixels, whose score is 0 whatever they read
  if (kVec) {
    for (int e = tid; e < kImgH * kVecRow; e += kThreads) {
      const int r = e / kVecRow, v = e - r * kVecRow;
      const int gy = y0 - kHalo + r, gx = x0 - kHalo + 4 * v;
      float* dst = &simg[r * kStride + 4 * v];
      // W % 4 == 0 and gx % 4 == 0: the four pixels lie inside together
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        cp_async16(dst, img + (size_t)gy * w + gx);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_wait_all();
  } else {
    for (int e = tid; e < kImgH * kStride; e += kThreads) {
      const int r = e / kStride, c = e - r * kStride;
      const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
      simg[e] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[(size_t)gy * w + gx] : 0.f;
    }
  }
  __syncthreads();
  GMMLOC_STAMP(1, clock64())

  // The reject test on the tile + 1 px ring, a warp's survivors into the
  // warp's own two lists. A thread keeps its scored column c and walks
  // rows; scored (r, c) is pixel (y0 - 1 + r, x0 - 1 + c).
  // Rounding is monotone, so max_k and min_k commute with the subtraction
  // of the centre: U = fl(min_k max(I_k, I_{k+8}) - p), and L likewise,
  // bit for bit what the 16 differences would give.
  const int c = tid & (kMapW - 1);
  const bool col_live = c < kScW && x0 - 1 + c >= 3 && x0 - 1 + c < w - 3;
  const float* col = &simg[(kHalo - 1) * kStride + min(c, kScW - 1) + kHalo - 1];
  uint16_t* my_bright = &slist[(2 * warp) * kSeg];
  uint16_t* my_dark = my_bright + kSeg;
  const unsigned below = (1u << lane) - 1u;
  int n_bright = 0, n_dark = 0;   // the same in every lane of the warp
#pragma unroll 1
  for (int r = tid >> kMapShift; r < kScH; r += kRowsPerTrip) {   // r: one per warp
    const int e = (r << kMapShift) | c;
    sscore[e] = 0.f;
    const bool live = col_live && y0 - 1 + r >= 3 && y0 - 1 + r < h - 3;
    const float* ctr = col + r * kStride;
    const float p = ctr[0];
    float hi, lo;
    {
      const float a = ctr[-3 * kStride], b = ctr[3 * kStride];   // pair (0, 8)
      hi = fmaxf(a, b);
      lo = fminf(a, b);
    }
    GMMLOC_PAIR(0, 3)                                                  // pair (4, 12)
    if (!__any_sync(0xffffffffu, live && (hi - p > kThLow || lo - p < -kThLow))) continue;
    GMMLOC_PAIR(-3, 1) GMMLOC_PAIR(-2, 2) GMMLOC_PAIR(-1, 3)           // (1,9) (2,10) (3,11)
    GMMLOC_PAIR(1, 3) GMMLOC_PAIR(2, 2) GMMLOC_PAIR(3, 1)              // (5,13) (6,14) (7,15)
    const bool bright = live && hi - p > kThLow, dark = live && lo - p < -kThLow;
    const unsigned mb = __ballot_sync(0xffffffffu, bright);
    const unsigned md = __ballot_sync(0xffffffffu, dark);
    if (bright) my_bright[n_bright + __popc(mb & below)] = static_cast<uint16_t>(e);
    if (dark) my_dark[n_dark + __popc(md & below)] = static_cast<uint16_t>(e);
    n_bright += __popc(mb);
    n_dark += __popc(md);
  }
  __syncwarp();
  GMMLOC_STAMP(2, clock64())

  // the arc passes, each warp densely over its own lists; a pixel is in
  // one warp's lists only, so its score slot needs no wider barrier
  for (int i = lane; i < n_bright; i += 32) {
    const int e = my_bright[i];
    const int r = e >> kMapShift, cc = e & (kMapW - 1);
    float d[16];
    ring_diffs(&simg[(r + kHalo - 1) * kStride + cc + kHalo - 1], d);
    const float m = arc_best9<true>(d);
    sscore[e] = m > kThLow ? m : 0.f;
  }
  __syncwarp();
  GMMLOC_STAMP(3, clock64())
  for (int i = lane; i < n_dark; i += 32) {
    const int e = my_dark[i];
    const int r = e >> kMapShift, cc = e & (kMapW - 1);
    float d[16];
    ring_diffs(&simg[(r + kHalo - 1) * kStride + cc + kHalo - 1], d);
    const float m = -arc_best9<false>(d);
    if (m > kThLow) sscore[e] = fmaxf(sscore[e], m);
  }
  __syncthreads();
  GMMLOC_STAMP(4, clock64())

  // NMS: one column and four rows per thread, so that a warp reads and
  // writes 32 neighbouring columns; the row maxima are shared between the
  // four (max is exact in any order)
  for (int q = tid; q < kMapW * (kTH / 4); q += kThreads) {
    const int cc = q & (kMapW - 1), r = 4 * (q >> kMapShift);
    const int ox = x0 + cc, oy = y0 + r;
    if (cc >= kTW || ox >= w || oy >= h) continue;
    const float* s0 = &sscore[r * kMapW + cc];   // row above, column left
    float mid[6], sides[6], all[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float* row = s0 + k * kMapW;
      mid[k] = row[1];
      sides[k] = fmaxf(row[0], row[2]);
      all[k] = fmaxf(sides[k], mid[k]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (oy + j >= h) break;
      const float s = mid[j + 1];
      const float m = fmaxf(fmaxf(all[j], all[j + 2]), sides[j + 1]);
      out[(size_t)(oy + j) * w + ox] = (s >= m + 1e-6f) ? s : 0.f;
    }
  }
  GMMLOC_STAMP(5, clock64())
  GMMLOC_STAMP(7, global_ns())
}

}  // namespace

#ifdef GMMLOC_FAST_PROFILE
// the stamps of the last launch's first n blocks into host memory
extern "C" int gmmloc_fast_nms_stamps(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, sizeof(long long) * 8 * n));
}
#endif

extern "C" int gmmloc_fast_nms(const void* img, int h, int w, void* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const float* src = static_cast<const float*>(img);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH);
  if (vec)
    fast_nms_kernel<true><<<grid, kThreads, 0, s>>>(src, h, w, dst);
  else
    fast_nms_kernel<false><<<grid, kThreads, 0, s>>>(src, h, w, dst);
  return static_cast<int>(cudaGetLastError());
}
