// Hamming-distance matrix of 256-bit ORB descriptors (K3).
//
// Replaces the Pallas kernel gmmloc_tpu/features/pallas_kernels.py
// hamming_matrix_pallas (_hamming_kernel): (N,32) u8 x (M,32) u8 ->
// (N,M) int32, XOR plus popcount over 8 little-endian uint32 words. It is
// the distance matrix under every matcher of the port: the F x F motion
// match, the P x F local-map match, stereo, the triangulation and fusion
// searches. The result is exact.
//
// What bounds it on the card (H100 SXM): the function is bound by its
// output, 4 bytes per distance (21 MB at 4096 x 1280, 0.0063 ms at 3.35
// TB/s; the descriptors are 172 KB). But on the ALU a distance costs 8
// population counts, and the SM issues 16 of those per clock against 64
// integer or logic operations (NVIDIA's CUDA C++ programming manual,
// arithmetic instruction throughput, compute capability 9.0): 41.9 M
// popc over 132 SMs is ~0.010 ms, above the bytes. So a kernel that
// counts bits pair by pair sits on the popc pipe, not on memory, and the
// counting moves to the tensor cores: one
// mma.sync.m16n8k256.b1.and.popc takes a whole descriptor per row as its
// K and gives popc(a & b) for a 16 x 8 tile, and
// hamming(a, b) = popc(a) + popc(b) - 2 popc(a & b), with the row and
// column popcounts computed once per block (8 popc per descriptor, not
// per pair). The .xor.popc form does not exist for sm_90.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (tools/feature_kernel_sweep.py,
// 4096 x 1280, device ms over a ring of outputs larger than the L2) this
// form ran in 0.0096; the other ways to compute a tile that were tried
// behind the same stores (tools/hamming_variants.cu) all ran slower than
// the first port's kernel (0.0142): a carry-save tree on the ALU with 4
// popc per distance 0.0146, 8 popc per distance 0.0155, int8 tensor-core
// mma over descriptors expanded to 0/1 bytes in shared memory 0.0160 (its
// byte tiles cost more shared-memory traffic than the mma saves). The
// kernel writes its 21 MB at 2.2 TB/s (2.6 TB/s into one cached buffer),
// launch and tail included.
//
// The stores: every thread owns 4 consecutive columns and writes one
// 128-bit st.global per row (rows of the (N,M) int32 output are 16-byte
// aligned when M % 4 == 0); other M, or an output off 16 bytes, take
// scalar stores. Operands are read as 128-bit words into shared memory
// (rows padded to 12 words: 16-byte aligned, and the 8 rows a fragment
// load touches fall on distinct banks). The mma leaves each thread 2
// adjacent columns of a tile, so the columns of B are stored in shared
// memory in an order that gives a thread columns 4q, 4q+1 from one mma
// and 4q+2, 4q+3 from the next.
//
// Tiles: 64 columns by 128 rows (8 warps, one 16 x 64 strip each). The
// 1280 x 1280 and 1200 x 1200 matches are one wave of 200 and 190 such
// blocks: their time is launch, fill and tail, and 64-row tiles (twice
// the blocks) ran no faster there or at 4096 x 1280. Occupancy: 9.7 KB of
// shared memory, 256 threads and 38 registers per block: 6 blocks per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;     // columns of a block's tile
constexpr int kRows = 128;    // rows of it
constexpr int kWords = 8;     // uint32 words of a descriptor
constexpr int kStride = 12;   // words of a shared row

// shared row of the tile's column l: within each group of 16 columns,
// column 4q + 2t + i sits at row 8t + 2q + i
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

// c += popc(a & b) over K = 256 for a 16 x 8 tile
__device__ __forceinline__ void mma_b1(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp per 16 rows x 64 columns: 8 mma tiles, two per 16 columns.
// Fragments (PTX ISA, mma.m16n8k256), g = lane / 4, t = lane % 4: A holds
// rows g and g+8, B holds tile column g, both at the descriptor's words t
// and t + 4; C holds rows g and g+8 at tile columns 2t, 2t+1.
template <bool kVec>
__global__ void __launch_bounds__(kRows * 2)
hamming_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, int n, int m,
               int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sa[kRows * kStride];
  __shared__ __align__(16) uint32_t sb[kCols * kStride];
  __shared__ int pa[kRows];
  __shared__ __align__(16) int pb[kCols];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;

  fill<false>(sa, a, row0, n, kRows);
  fill<true>(sb, b, col0, m, kCols);
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
  const uint32_t af[4] = {sa[(wr + g) * kStride + t], sa[(wr + g + 8) * kStride + t],
                          sa[(wr + g) * kStride + 4 + t], sa[(wr + g + 8) * kStride + 4 + t]};
#pragma unroll
  for (int grp = 0; grp < kCols / 16; ++grp) {
    int c[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h][0] = c[h][1] = c[h][2] = c[h][3] = 0;
      // shared row 16 grp + 8 h + g holds tile column 16 grp + 4 (g/2) + 2 h + g%2
      const uint32_t* brow = &sb[(16 * grp + 8 * h + g) * kStride];
      mma_b1(c[h], af, brow[t], brow[4 + t]);
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

}  // namespace

// a, b: 16-byte aligned descriptors; out: (n, m) int32
extern "C" int gmmloc_hamming(const void* a, const void* b, int n, int m,
                              void* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const uint4* pa = static_cast<const uint4*>(a);
  const uint4* pb = static_cast<const uint4*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = kRows * 2;   // a warp per 16 rows
  dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  if (m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    hamming_kernel<true><<<grid, threads, 0, s>>>(pa, pb, n, m, po);
  else
    hamming_kernel<false><<<grid, threads, 0, s>>>(pa, pb, n, m, po);
  return static_cast<int>(cudaGetLastError());
}
