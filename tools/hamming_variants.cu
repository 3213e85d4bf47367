// Other ways to compute a tile of the Hamming-distance matrix (K3), kept
// for tools/feature_kernel_sweep.py, which builds each beside the
// package's kernel (gmmloc_tpu_torch/csrc/hamming.cu) and times them in
// one run. Same C interface, fill and stores as the package's kernel;
// GMMLOC_HAMMING_VARIANT picks the arithmetic at compile time:
//
//   0  8 popc per distance on the ALU, as the first port did;
//   1  1-bit tensor cores (mma.sync.m16n8k256.b1.and.popc): the form the
//      package ships;
//   2  int8 tensor cores: descriptors expanded to 0/1 bytes in shared
//      memory, 8 x mma.sync.m16n8k32.s8 over K = 256, the same rank-1
//      correction hamming(a, b) = popc(a) + popc(b) - 2 popc(a & b);
//   3  carry-save on the ALU: the 8 XOR words go through 7 adders of two
//      LOP3 each, leaving 4 words (ones, twos, fours, eights) and 4 popc
//      per distance in place of 8.
//
// On an NVIDIA H100 80GB HBM3 at 700 W, 4096 x 1280, device ms over a
// ring of outputs larger than the L2: variant 1 0.0096, 3 0.0146, 0
// 0.0155, 2 0.0160; the first port's kernel 0.0142. No variant but 1 is
// used by the package.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GMMLOC_HAMMING_VARIANT
#define GMMLOC_HAMMING_VARIANT 1
#endif

namespace {

constexpr int kCols = 64;     // columns of a block's tile
constexpr int kRows = GMMLOC_HAMMING_VARIANT == 2 ? 64 : 128;   // rows of it
constexpr int kWords = 8;     // uint32 words of a descriptor
constexpr int kStride = 12;   // words of a shared row

// shared row of the tile's column l: within each group of 16 columns,
// column 4q + 2t + i sits at row 8t + 2q + i (the tensor-core variants)
__device__ __forceinline__ int permuted(int l) {
  return (l & ~15) | ((l & 2) << 2) | ((l >> 1) & 6) | (l & 1);
}

// `rows` descriptors from row0 of src (count rows in all) into shared
// memory as words, zero beyond the end; two 128-bit loads per descriptor
template <bool kPermute>
__device__ __forceinline__ void fill(uint32_t* dst, const uint4* __restrict__ src, int row0,
                                     int count, int rows) {
  for (int e = threadIdx.x; e < 2 * rows; e += blockDim.x) {
    const int r = e >> 1, half = e & 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < count) v = src[(size_t)(row0 + r) * 2 + half];
    const int at = kPermute ? permuted(r) : r;
    *reinterpret_cast<uint4*>(&dst[at * kStride + 4 * half]) = v;
  }
}

// 4 distances of row r, columns c .. c+3
template <bool kVec>
__device__ __forceinline__ void store4(int32_t* __restrict__ out, int n, int m, int r, int c,
                                       int d0, int d1, int d2, int d3) {
  if (r >= n || c >= m) return;
  int32_t* o = out + (size_t)r * m + c;
  if (kVec) {   // M % 4 == 0 and c % 4 == 0: the four lie inside together
    *reinterpret_cast<int4*>(o) = make_int4(d0, d1, d2, d3);
  } else {
    o[0] = d0;
    if (c + 1 < m) o[1] = d1;
    if (c + 2 < m) o[2] = d2;
    if (c + 3 < m) o[3] = d3;
  }
}

#if GMMLOC_HAMMING_VARIANT == 1 || GMMLOC_HAMMING_VARIANT == 2

#if GMMLOC_HAMMING_VARIANT == 2
// bytes of a shared row of 0/1 bytes: 68 words, banks 4g + t (two such
// tiles of 128 rows would pass 48 KB)
constexpr int kByteStride = 256 + 16;
#endif

// c += popc(a & b) over K = 256 for a 16 x 8 tile
__device__ __forceinline__ void mma_b1(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b over K = 32 signed bytes for a 16 x 8 tile
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#if GMMLOC_HAMMING_VARIANT == 2
// the 32 bits of a word as 32 bytes of 0/1: a nibble times 0x00204081
// puts bit i at bit 8i (the four shifted copies do not overlap)
__device__ __forceinline__ void expand_word(uint8_t* dst, uint32_t word) {
  uint32_t q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = (((word >> (4 * k)) & 0xFu) * 0x00204081u) & 0x01010101u;
  *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
  *reinterpret_cast<uint4*>(dst + 16) = make_uint4(q[4], q[5], q[6], q[7]);
}

template <bool kPermute>
__device__ __forceinline__ void fill_bytes(uint8_t* dst, const uint32_t* __restrict__ src,
                                           int row0, int count, int rows) {
  for (int e = threadIdx.x; e < kWords * rows; e += blockDim.x) {
    const int r = e >> 3, wd = e & 7;
    const uint32_t word = (row0 + r < count) ? src[(size_t)(row0 + r) * kWords + wd] : 0u;
    const int at = kPermute ? permuted(r) : r;
    expand_word(dst + at * kByteStride + 32 * wd, word);
  }
}
#endif

// One warp per 16 rows x 64 columns: 8 mma tiles, two per 16 columns.
// Fragments (PTX ISA, mma.m16n8k256 / m16n8k32), g = lane / 4, t = lane % 4:
// A holds rows g and g+8, B holds tile column g, both at K chunk t and
// t + 4 (b1: 32-bit chunks of the 8 words; s8: 4-byte chunks of 32 bytes);
// C holds rows g and g+8 at tile columns 2t, 2t+1.
template <bool kVec>
__global__ void __launch_bounds__(kRows * 2)
hamming_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, int n, int m,
               int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sa[kRows * kStride];
  __shared__ __align__(16) uint32_t sb[kCols * kStride];
  __shared__ int pa[kRows];
  __shared__ __align__(16) int pb[kCols];
#if GMMLOC_HAMMING_VARIANT == 2
  __shared__ __align__(16) uint8_t sa8[kRows * kByteStride];
  __shared__ __align__(16) uint8_t sb8[kCols * kByteStride];
#endif
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;

  fill<false>(sa, a, row0, n, kRows);
  fill<true>(sb, b, col0, m, kCols);
#if GMMLOC_HAMMING_VARIANT == 2
  fill_bytes<false>(sa8, reinterpret_cast<const uint32_t*>(a), row0, n, kRows);
  fill_bytes<true>(sb8, reinterpret_cast<const uint32_t*>(b), col0, m, kCols);
#endif
  __syncthreads();
  // popcounts of the tile's descriptors, one descriptor per thread
  for (int e = tid; e < kRows + kCols; e += kRows * 2) {
    const bool is_b = e >= kRows;
    const int r = is_b ? e - kRows : e;
    const uint32_t* d = is_b ? &sb[permuted(r) * kStride] : &sa[r * kStride];
    int s = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) s += __popc(d[k]);
    if (is_b) pb[r] = s; else pa[r] = s;
  }
  __syncthreads();

  const int wr = warp * 16;
  const int pa0 = pa[wr + g], pa1 = pa[wr + g + 8];
  const int r0 = row0 + wr + g;
#if GMMLOC_HAMMING_VARIANT == 1
  const uint32_t af[4] = {sa[(wr + g) * kStride + t], sa[(wr + g + 8) * kStride + t],
                          sa[(wr + g) * kStride + 4 + t], sa[(wr + g + 8) * kStride + 4 + t]};
#endif
#pragma unroll
  for (int grp = 0; grp < kCols / 16; ++grp) {
    int c[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h][0] = c[h][1] = c[h][2] = c[h][3] = 0;
      // shared row 16 grp + 8 h + g holds tile column 16 grp + 4 (g/2) + 2 h + g%2
#if GMMLOC_HAMMING_VARIANT == 1
      const uint32_t* brow = &sb[(16 * grp + 8 * h + g) * kStride];
      mma_b1(c[h], af, brow[t], brow[4 + t]);
#else
      const uint8_t* arow0 = &sa8[(wr + g) * kByteStride + 4 * t];
      const uint8_t* arow1 = arow0 + 8 * kByteStride;
      const uint8_t* brow = &sb8[(16 * grp + 8 * h + g) * kByteStride + 4 * t];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(arow0 + 32 * k),
                                *reinterpret_cast<const uint32_t*>(arow1 + 32 * k),
                                *reinterpret_cast<const uint32_t*>(arow0 + 32 * k + 16),
                                *reinterpret_cast<const uint32_t*>(arow1 + 32 * k + 16)};
        mma_s8(c[h], af, *reinterpret_cast<const uint32_t*>(brow + 32 * k),
               *reinterpret_cast<const uint32_t*>(brow + 32 * k + 16));
      }
#endif
    }
    // this thread: rows g and g+8, tile columns 16 grp + 4 t + {0,1} from
    // the first mma and + {2,3} from the second
    const int cl = 16 * grp + 4 * t;
    const int4 q = *reinterpret_cast<const int4*>(&pb[cl]);
    store4<kVec>(out, n, m, r0, col0 + cl, pa0 + q.x - 2 * c[0][0], pa0 + q.y - 2 * c[0][1],
                 pa0 + q.z - 2 * c[1][0], pa0 + q.w - 2 * c[1][1]);
    store4<kVec>(out, n, m, r0 + 8, col0 + cl, pa1 + q.x - 2 * c[0][2], pa1 + q.y - 2 * c[0][3],
                 pa1 + q.z - 2 * c[1][2], pa1 + q.w - 2 * c[1][3]);
  }
}

#else   // the ALU variants

#if GMMLOC_HAMMING_VARIANT == 3
// full adder over 32 lanes of bits: hi = majority, lo = parity
#define GMMLOC_CSA(hi, lo, x, y, z)          \
  {                                          \
    const uint32_t u_ = (x) ^ (y);           \
    hi = ((x) & (y)) | (u_ & (z));           \
    lo = u_ ^ (z);                           \
  }

__device__ __forceinline__ int distance(const uint32_t* a, const uint32_t* b) {
  uint32_t x[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) x[k] = a[k] ^ b[k];
  uint32_t s0, s1, s2, c0, c1, c2, t0, f0;
  GMMLOC_CSA(c0, s0, x[0], x[1], x[2])
  GMMLOC_CSA(c1, s1, x[3], x[4], x[5])
  GMMLOC_CSA(c2, s2, s0, s1, x[6])
  const uint32_t ones = s2 ^ x[7], c3 = s2 & x[7];
  GMMLOC_CSA(f0, t0, c0, c1, c2)
  const uint32_t twos = t0 ^ c3, f1 = t0 & c3;
  const uint32_t fours = f0 ^ f1, eights = f0 & f1;
  return __popc(ones) + 2 * __popc(twos) + 4 * __popc(fours) + 8 * __popc(eights);
}
#else
__device__ __forceinline__ int distance(const uint32_t* a, const uint32_t* b) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) s += __popc(a[k] ^ b[k]);
  return s;
}
#endif

// 256 threads as 16 x 16: a thread keeps its 4 columns' descriptors in
// registers and walks rows ty, ty + 16, ...
template <bool kVec>
__global__ void __launch_bounds__(256)
hamming_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, int n, int m,
               int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sa[kRows * kStride];
  __shared__ __align__(16) uint32_t sb[kCols * kStride];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;
  fill<false>(sa, a, row0, n, kRows);
  fill<false>(sb, b, col0, m, kCols);
  __syncthreads();
  uint32_t bw[4][kWords];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 lo = *reinterpret_cast<const uint4*>(&sb[(4 * tx + j) * kStride]);
    const uint4 hi = *reinterpret_cast<const uint4*>(&sb[(4 * tx + j) * kStride + 4]);
    bw[j][0] = lo.x; bw[j][1] = lo.y; bw[j][2] = lo.z; bw[j][3] = lo.w;
    bw[j][4] = hi.x; bw[j][5] = hi.y; bw[j][6] = hi.z; bw[j][7] = hi.w;
  }
#pragma unroll 2
  for (int i = 0; i < kRows / 16; ++i) {
    const int r = ty + 16 * i;
    const uint4 lo = *reinterpret_cast<const uint4*>(&sa[r * kStride]);
    const uint4 hi = *reinterpret_cast<const uint4*>(&sa[r * kStride + 4]);
    const uint32_t aw[kWords] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store4<kVec>(out, n, m, row0 + r, col0 + 4 * tx, distance(aw, bw[0]), distance(aw, bw[1]),
                 distance(aw, bw[2]), distance(aw, bw[3]));
  }
}

#endif

}  // namespace

// a, b: 16-byte aligned descriptors; out: (n, m) int32
extern "C" int gmmloc_hamming(const void* a, const void* b, int n, int m,
                              void* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const uint4* pa = static_cast<const uint4*>(a);
  const uint4* pb = static_cast<const uint4*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if GMMLOC_HAMMING_VARIANT == 1 || GMMLOC_HAMMING_VARIANT == 2
  const int threads = kRows * 2;   // a warp per 16 rows
#else
  const int threads = 256;
#endif
  dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  if (m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    hamming_kernel<true><<<grid, threads, 0, s>>>(pa, pb, n, m, po);
  else
    hamming_kernel<false><<<grid, threads, 0, s>>>(pa, pb, n, m, po);
  return static_cast<int>(cudaGetLastError());
}
