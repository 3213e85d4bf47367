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
// in-border score reads across an edge.
//
// What bounds it on the card: operations. About 206 simple float32 ops
// per pixel (16 subtracts, 16 negations, 2 x 79 for the two doubling
// arc-minimum passes, the threshold and the NMS) against 8 bytes moved
// per pixel: at 4420 x 752 that is 0.68 G ops (about 20 us at the H100's
// 33.5 T simple lane ops/s) against 26.6 MB (about 8 us at 3.35 TB/s).
// The design keeps the arithmetic in registers and every re-read in
// shared memory: a 32 x 8 block stages its tile plus a 4 px halo of the
// image (the ring radius 3, plus 1 for the NMS ring) in shared memory,
// computes the score for the tile plus a 1 px ring into shared memory,
// and each thread then applies the NMS to its own pixel. Bounds come from
// the image's own H and W. Vectorised loads and register blocking of rows
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kHalo = 4;
constexpr int kImgW = kTx + 2 * kHalo;
constexpr int kImgH = kTy + 2 * kHalo;
constexpr int kScW = kTx + 2;
constexpr int kScH = kTy + 2;
constexpr float kThLow = 7.0f;

// FAST-16 ring (row, col) offsets, the order of features/fast.py RING
__constant__ int kRingY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// max over s of min(v[s .. s+8]) (circular): doubling to 8, then one more
__device__ inline float window_max_min9(const float v[16]) {
  float m1[16], m2[16], m4[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m1[s] = fminf(v[s], v[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m2[s] = fminf(m1[s], m1[(s + 2) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m4[s] = fminf(m2[s], m2[(s + 4) & 15]);
  float out = fminf(m4[0], v[8]);
#pragma unroll
  for (int s = 1; s < 16; ++s) out = fmaxf(out, fminf(m4[s], v[(s + 8) & 15]));
  return out;
}

// score of the pixel at (r, c) of the shared image tile
__device__ inline float fast_score(const float (*img)[kImgW], int r, int c) {
  const float p = img[r][c];
  float d[16], nd[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    d[k] = img[r + kRingY[k]][c + kRingX[k]] - p;
    nd[k] = -d[k];
  }
  const float mb = window_max_min9(d);
  const float md = window_max_min9(nd);
  return fmaxf(mb > kThLow ? mb : 0.f, md > kThLow ? md : 0.f);
}

__global__ void __launch_bounds__(kTx * kTy)
fast_nms_kernel(const float* __restrict__ img, int h, int w, float* __restrict__ out) {
  __shared__ float simg[kImgH][kImgW];
  __shared__ float sscore[kScH][kScW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;

  // image tile + 4 px halo; pixels outside the image are never read by
  // an in-border score (they only feed border pixels, which are 0)
  for (int e = tid; e < kImgH * kImgW; e += kTx * kTy) {
    const int r = e / kImgW, c = e % kImgW;
    const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
    simg[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[(size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();

  // scores of the tile + 1 px ring; 0 in the 3 px image border and
  // outside the image
  for (int e = tid; e < kScH * kScW; e += kTx * kTy) {
    const int r = e / kScW, c = e % kScW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float s = 0.f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3)
      s = fast_score(simg, r + kHalo - 1, c + kHalo - 1);
    sscore[r][c] = s;
  }
  __syncthreads();

  const int ox = x0 + tx, oy = y0 + ty;
  if (ox >= w || oy >= h) return;
  const float s = sscore[ty + 1][tx + 1];
  float m = sscore[ty][tx];
  m = fmaxf(m, sscore[ty][tx + 1]);
  m = fmaxf(m, sscore[ty][tx + 2]);
  m = fmaxf(m, sscore[ty + 1][tx]);
  m = fmaxf(m, sscore[ty + 1][tx + 2]);
  m = fmaxf(m, sscore[ty + 2][tx]);
  m = fmaxf(m, sscore[ty + 2][tx + 1]);
  m = fmaxf(m, sscore[ty + 2][tx + 2]);
  out[(size_t)oy * w + ox] = (s >= m + 1e-6f) ? s : 0.f;
}

}  // namespace

extern "C" int gmmloc_fast_nms(const void* img, int h, int w, void* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  dim3 block(kTx, kTy);
  dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
