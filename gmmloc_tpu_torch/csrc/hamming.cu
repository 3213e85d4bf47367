// Hamming-distance matrix of 256-bit ORB descriptors.
//
// Replaces the Pallas kernel gmmloc_tpu/features/pallas_kernels.py
// hamming_matrix_pallas (_hamming_kernel): (N,32) u8 x (M,32) u8 ->
// (N,M) int32, XOR plus popcount over 8 little-endian uint32 words. It is
// the distance matrix under every matcher of the port: the F x F motion
// match, the P x F local-map match, the triangulation and fusion searches.
//
// What bounds it on the card: the output. Each distance costs 8 XORs and
// 8 popcounts (__popc is one instruction) against 4 bytes written, and
// the inputs are small (4096 x 32 B = 128 KB); at 4096 x 1280 the 21 MB
// of int32 output is most of the memory traffic. The design stages a
// 64-row tile of each descriptor set in shared memory as uint32 words
// (rows padded to 9 words so the 16 column threads of a warp hit
// distinct banks) and has each of the 256 threads produce a 4 x 4 patch
// with columns strided by 16, so a warp's stores are coalesced rows.
// The result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kWords = 8;
constexpr int kPad = kWords + 1;

__global__ void __launch_bounds__(256)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int n, int m, int32_t* __restrict__ out) {
  __shared__ uint32_t sa[kTile][kPad];
  __shared__ uint32_t sb[kTile][kPad];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  // 64 rows x 8 words per tile: two words per thread per operand
  for (int e = tid; e < kTile * kWords; e += 256) {
    const int r = e / kWords, w = e % kWords;
    sa[r][w] = (row0 + r < n) ? a[(size_t)(row0 + r) * kWords + w] : 0u;
    sb[r][w] = (col0 + r < m) ? b[(size_t)(col0 + r) * kWords + w] : 0u;
  }
  __syncthreads();
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = sa[ty + 16 * i][w];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = sb[tx + 16 * j][w];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __popc(av[i] ^ bv[j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < m) out[(size_t)r * m + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int gmmloc_hamming(const void* a, const void* b, int n, int m,
                              void* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  dim3 block(16, 16);
  dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), n, m,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
