// Staged pose-only Gauss-Newton solve, one thread block cluster per solve.
//
// Replaces the Pallas kernels of gmmloc_tpu/solver/pallas_pose.py:
//   K1  optimize_pose           (_make_kernel(use_anchors=False))
//   K2  optimize_pose_anchored  (_make_kernel(use_anchors=True))
// and computes what gmmloc_tpu_torch/solver/pose_solver.py computes:
// 4 rounds x up to 10 GN iterations over F features, each round restarting
// from the initial pose; per feature the stereo/mono reprojection residual
// and its 6-column Jacobian (Huber-weighted in rounds 0-2); per iteration
// the 21+6 normal-equation sums, +1e-6 on the diagonal, a 6x6 Cholesky
// solve (here in its L D L^T form) and the quaternion boxplus, stopping
// early on max|dx| < step_tol or a non-finite step; after each round the
// chi2 reclassification. K2 adds
// one GMM anchor edge per feature (1-D point-to-plane for a degenerate
// component weighted by anc_w, 3-D sqrt-info whitened otherwise) with its
// own Huber weight, chi2 gate and outlier flags.
//
// What bounds it on the card: latency, not bytes or FLOPs. F=1280 features
// are ~45-150 KB of input and one iteration is ~230-430 FLOPs per feature,
// but the 40 iterations are a serial chain: each needs the 27 sums over
// all features, then one 6x6 solve, before the next can start. On a single
// SM the per-feature pass alone costs 2.1 ns (K1) and 4.3 ns (K2) per
// feature and step, 2.6 and 5.5 us per step at F=1280; spread over the
// cluster's SMs it drops out of the step. What is left is serial latency,
// ~2.1 us (K1) and ~2.5 us (K2) per step on an H100: the 6x6 solve and
// boxplus (~0.8 us), the exchange and barrier (~0.4 us), the reductions
// (tools/pose_kernel_sweep.py --ablate).
//
// The design: a cluster of kCluster = 16 blocks on neighbouring SMs per
// solve (the fastest of 1, 2, 4, 8 and 16 in tools/pose_kernel_sweep.py;
// 16 is the largest cluster Hopper schedules, non-portable), one launch,
// one feature per thread (up to 4 for large F). Each thread loads its
// features' inputs once into registers, where the outlier flags also
// live; nothing is read from device memory inside the GN loop. Per
// step: each warp reduces its 27 sums by a transpose (reduce-scatter)
// shuffle, warp 0 adds the warps' partials and writes the block's sums into
// slot [rank] of every block's shared memory (distributed shared memory,
// double-buffered by step parity), and one cluster barrier follows. Then
// every warp of every block adds the slots in rank order and runs the 6x6
// solve and the boxplus itself, so all threads hold bit-identical poses and
// take the same early-stop decision without a second barrier. A block reads
// the slots of parity p only before it arrives at the next barrier, so the
// writes of step s+2 cannot overtake them. The inlier and anchor counts go
// through the same path, whose barrier is also the last one: no block
// leaves while another may still write to its shared memory.
//
// Deterministic: fixed summation orders, no float atomics, IEEE arithmetic
// (no fast math). Sums are taken in another order than the PyTorch version,
// so the two agree to float tolerance, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;        // blocks per solve (non-portable above 8)
constexpr int kMaxThreads = 512;    // per block (128 registers a thread)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSums = 27;           // 21 upper-triangle H + 6 b
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ inline void quat_to_R(const float* q, float R[3][3]) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - wz); R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz); R[1][1] = 1.f - 2.f * (xx + zz); R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy); R[2][1] = 2.f * (yz + wx); R[2][2] = 1.f - 2.f * (xx + yy);
}

// One feature's inputs, held in registers for the whole solve.
struct Feat {
  float xw[3], obs[3];
  float s2i, st;        // st: 1 stereo, 0 mono
  float th, delta;      // chi2 gate and Huber delta = sqrt(th)
  bool valid, outlier;
};

struct Anchor {
  float xc[3], mean[3], nrm[3], sqi[9];
  float w;
  int type;             // 0 none, 1 degenerate, 2 full
  bool outlier;
};

// Reprojection residual rows (u, v, ur), Jacobian rows and chi2 of one
// feature at pose (R, t).
__device__ inline float reproj(const Cam& c, const float R[3][3], const float* t,
                               const Feat& f, float r[3], float J[3][6]) {
  const float* xw = f.xw;
  float pcx = R[0][0] * xw[0] + R[0][1] * xw[1] + R[0][2] * xw[2] + t[0];
  float pcy = R[1][0] * xw[0] + R[1][1] * xw[1] + R[1][2] * xw[2] + t[1];
  float pcz = R[2][0] * xw[0] + R[2][1] * xw[1] + R[2][2] * xw[2] + t[2];
  float zs = fabsf(pcz) < 1e-9f ? 1e-9f : pcz;
  float iz = 1.f / zs;
  float iz2 = iz * iz;
  float u = c.fx * pcx * iz + c.cx;
  float v = c.fy * pcy * iz + c.cy;
  float ur = u - c.bf * iz;
  const float st = f.st;
  r[0] = u - f.obs[0];
  r[1] = v - f.obs[1];
  r[2] = (ur - f.obs[2]) * st;
  float a0 = c.fx * iz, a2 = -c.fx * pcx * iz2;
  float b1 = c.fy * iz, b2 = -c.fy * pcy * iz2;
  float cc = c.bf * iz2;
  J[0][0] = a2 * pcy; J[0][1] = a0 * pcz - a2 * pcx; J[0][2] = -a0 * pcy;
  J[0][3] = a0; J[0][4] = 0.f; J[0][5] = a2;
  J[1][0] = -b1 * pcz + b2 * pcy; J[1][1] = -b2 * pcx; J[1][2] = b1 * pcx;
  J[1][3] = 0.f; J[1][4] = b1; J[1][5] = b2;
  J[2][0] = (J[0][0] + cc * pcy) * st; J[2][1] = (J[0][1] - cc * pcx) * st;
  J[2][2] = J[0][2] * st; J[2][3] = J[0][3] * st; J[2][4] = 0.f;
  J[2][5] = (J[0][5] + cc) * st;
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * f.s2i;
}

// Anchor residual rows, Jacobian rows and chi2 of one feature.
__device__ inline float anchor(const float R[3][3], const float* t, const Anchor& a,
                               float r[3], float J[3][6]) {
  const float* xc = a.xc;
  float dxc[3] = {xc[0] - t[0], xc[1] - t[1], xc[2] - t[2]};
  float d[3];
  for (int i = 0; i < 3; ++i)
    d[i] = R[0][i] * dxc[0] + R[1][i] * dxc[1] + R[2][i] * dxc[2] - a.mean[i];
  // M = [skew(xc) | -I]; Jx[i][j] = sum_k R[k][i] M[k][j]
  float sk[3][3] = {{0.f, -xc[2], xc[1]}, {xc[2], 0.f, -xc[0]}, {-xc[1], xc[0], 0.f}};
  float Jx[3][6];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Jx[i][j] = R[0][i] * sk[0][j] + R[1][i] * sk[1][j] + R[2][i] * sk[2][j];
    for (int j = 0; j < 3; ++j) Jx[i][3 + j] = -R[j][i];
  }
  if (a.type == 1) {
    const float* nrm = a.nrm;
    r[0] = d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2];
    r[1] = 0.f;
    r[2] = 0.f;
    for (int j = 0; j < 6; ++j) {
      J[0][j] = nrm[0] * Jx[0][j] + nrm[1] * Jx[1][j] + nrm[2] * Jx[2][j];
      J[1][j] = 0.f;
      J[2][j] = 0.f;
    }
  } else {
    // r_i = sum_j L[j][i] d[j] (L = sqi, row-major lower Cholesky factor)
    const float* sqi = a.sqi;
    for (int i = 0; i < 3; ++i) {
      r[i] = sqi[0 * 3 + i] * d[0] + sqi[1 * 3 + i] * d[1] + sqi[2 * 3 + i] * d[2];
      for (int j = 0; j < 6; ++j)
        J[i][j] = sqi[0 * 3 + i] * Jx[0][j] + sqi[1 * 3 + i] * Jx[1][j] +
                  sqi[2 * 3 + i] * Jx[2][j];
    }
  }
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * a.w;
}

__device__ inline float huber(float chi2, float delta) {
  float s = sqrtf(fmaxf(chi2, 1e-24f));
  return s <= delta ? 1.f : delta / s;
}

__device__ inline void accumulate(float acc[32], const float r[3], const float J[3][6],
                                  float w) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) {
      acc[k++] += w * (J[0][a] * J[0][c] + J[1][a] * J[1][c] + J[2][a] * J[2][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a)
    acc[21 + a] += w * (J[0][a] * r[0] + J[1][a] * r[1] + J[2][a] * r[2]);
}

// One halving step of the warp's transpose reduction: lanes with bit `H`
// set keep the upper half of v[0..2H), the others the lower half, and each
// adds its partner's copy of the half it keeps.
template <int H>
__device__ inline void transpose_step(float v[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = up ? v[i + H] : v[i];
    const float send = up ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// Sum of v[k] over the warp's lanes, returned in lane k: 31 shuffles
// instead of 32 x 5.
__device__ inline float warp_transpose_sum(float v[32], int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// 6x6 solve H x = b as L D L^T: D[i] = max(H[i][i] - sum_k L[i][k]^2 D[k],
// 1e-20) is the reference's clamped Cholesky pivot without its square root,
// so each pivot costs one reciprocal and no sqrt on the serial chain.
// E[j][i] = L[j][i] D[i].
__device__ inline void ldl_solve6(const float H[6][6], const float b[6], float x[6]) {
  float L[6][6], E[6][6], inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * E[i][k];
    inv[i] = 1.f / fmaxf(s, 1e-20f);
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float s2 = H[j][i];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 -= L[j][k] * E[i][k];
      E[j][i] = s2;
      L[j][i] = s2 * inv[i];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i] * inv[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s;
  }
}

// exp(dx) * (q, t), quaternion renormalized (se3.boxplus).
__device__ inline void boxplus(const float* q, const float* t, const float dx[6],
                               float qn[4], float tn[3]) {
  float w0 = dx[0], w1 = dx[1], w2 = dx[2];
  float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  float theta = sqrtf(fmaxf(theta2, 1e-24f));
  bool small = theta2 < 1e-12f;
  float sh, ch, sf, cf;
  sincosf(0.5f * theta, &sh, &ch);
  sincosf(theta, &sf, &cf);
  float qw = small ? 1.f - theta2 / 8.f : ch;
  float s = small ? 0.5f - theta2 / 48.f : sh / theta;
  float dq[4] = {qw, w0 * s, w1 * s, w2 * s};
  float dn = rsqrtf(fmaxf(dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2] + dq[3] * dq[3], 1e-24f));
  for (int i = 0; i < 4; ++i) dq[i] *= dn;
  float a = small ? 0.5f - theta2 / 24.f : (1.f - cf) / fmaxf(theta2, 1e-24f);
  float bb = small ? 1.f / 6.f - theta2 / 120.f
                   : (theta - sf) / fmaxf(theta2 * theta, 1e-24f);
  float om[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float wv[3] = {w0, w1, w2};
  float V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) V[i][j] = a * om[i][j] + bb * wv[i] * wv[j];
    V[i][i] += 1.f - bb * theta2;
  }
  float dt[3];
  for (int i = 0; i < 3; ++i) dt[i] = V[i][0] * dx[3] + V[i][1] * dx[4] + V[i][2] * dx[5];
  float aw = dq[0], ax = dq[1], ay = dq[2], az = dq[3];
  float bw = q[0], bx = q[1], by = q[2], bz = q[3];
  qn[0] = aw * bw - ax * bx - ay * by - az * bz;
  qn[1] = aw * bx + ax * bw + ay * bz - az * by;
  qn[2] = aw * by - ax * bz + ay * bw + az * bx;
  qn[3] = aw * bz + ax * by - ay * bx + az * bw;
  float Rd[3][3];
  quat_to_R(dq, Rd);
  for (int i = 0; i < 3; ++i)
    tn[i] = Rd[i][0] * t[0] + Rd[i][1] * t[1] + Rd[i][2] * t[2] + dt[i];
  float nn = rsqrtf(fmaxf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3], 1e-24f));
  for (int i = 0; i < 4; ++i) qn[i] *= nn;
}

struct Inputs {
  const float* q0;            // (4,)
  const float* t0;            // (3,)
  const float* x_w;           // (F,3)
  const float* obs;           // (F,3)
  const uint8_t* stereo;      // (F,) bool
  const float* s2i;           // (F,)
  const uint8_t* valid;       // (F,) bool
  const float* anc_xc;        // (F,3)
  const float* anc_mean;      // (F,3)
  const float* anc_normal;    // (F,3)
  const float* anc_sqi;       // (F,3,3)
  const int32_t* anc_type;    // (F,) 0 none, 1 deg, 2 nondeg
  const float* anc_w;         // (F,)
  float anc_gate;
  int n;
  int per_block;              // features of each block: [rank*per_block, ...)
  int rounds, iters;
  float step_tol;
  Cam cam;
};

struct Outputs {
  float* pose;          // (8,) q(4) t(3) 0
  int32_t* counts;      // (4,) n_inliers n_anchors gn_iters 0
  float* chi2;          // (F,)
  uint8_t* outlier;     // (F,) bool
  uint8_t* anc_outlier;  // (F,) bool (K2 only)
};

// The cluster's sums of this step: every block adds the slots of all
// ranks in rank order, each lane k < kSums one sum, then shares them.
__device__ inline void cluster_sums(const float (*slot)[32], int lane, float s[kSums]) {
  float v = 0.f;
  if (lane < kSums) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += slot[r][lane];
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = __shfl_sync(kFull, v, k);
}

// One GN update from the 27 sums: the damped 6x6 solve and the boxplus.
// Returns true when the solve stops (converged or non-finite step).
__device__ inline bool gn_update(const float s[kSums], float q[4], float t[3],
                                 float step_tol) {
  float H[6][6], b[6], dx[6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c) {
      H[a][c] = s[k];
      H[c][a] = s[k];
      ++k;
    }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    H[a][a] += 1e-6f;
    b[a] = s[21 + a];
  }
  ldl_solve6(H, b, dx);
  float maxdx = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    dx[a] = -dx[a];
    maxdx = fmaxf(maxdx, fabsf(dx[a]));
  }
  float qn[4], tn[3];
  boxplus(q, t, dx, qn, tn);
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 4; ++a) ok = ok && isfinite(qn[a]);
#pragma unroll
  for (int a = 0; a < 3; ++a) ok = ok && isfinite(tn[a]);
  if (ok) {
#pragma unroll
    for (int a = 0; a < 4; ++a) q[a] = qn[a];
#pragma unroll
    for (int a = 0; a < 3; ++a) t[a] = tn[a];
  }
  // a NaN step compares false: the non-finite check stops it
  return !ok || maxdx < step_tol;
}

template <bool ANC, int FPT>
__global__ void __launch_bounds__(kMaxThreads)
pose_solve_kernel(Inputs in, Outputs out) {
  __shared__ float red[kMaxWarps][32];
  __shared__ float slots[2][kCluster][32];   // [step parity][rank][sum]
  __shared__ int cnt_red[kMaxWarps][2];
  __shared__ int cnt_slots[kCluster][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int begin = rank * in.per_block;
  const int end = min(begin + in.per_block, in.n);
  const float anc_delta = sqrtf(fmaxf(in.anc_gate, 1e-24f));
  const float q0[4] = {in.q0[0], in.q0[1], in.q0[2], in.q0[3]};
  const float t0[3] = {in.t0[0], in.t0[1], in.t0[2]};

  Feat f[FPT];
  Anchor an[ANC ? FPT : 1];
#pragma unroll
  for (int j = 0; j < FPT; ++j) {
    const int i = begin + tid + j * blockDim.x;
    const bool live = i < end;
    const int ii = live ? i : 0;
    for (int k = 0; k < 3; ++k) {
      f[j].xw[k] = live ? in.x_w[3 * ii + k] : 0.f;
      f[j].obs[k] = live ? in.obs[3 * ii + k] : 0.f;
    }
    f[j].s2i = live ? in.s2i[ii] : 0.f;
    f[j].st = (live && in.stereo[ii]) ? 1.f : 0.f;
    f[j].th = f[j].st > 0.f ? 7.815f : 5.991f;
    f[j].delta = sqrtf(f[j].th);
    f[j].valid = live && in.valid[ii];
    f[j].outlier = false;
    if constexpr (ANC) {
      Anchor& a = an[j];
      a.type = live ? in.anc_type[ii] : 0;
      for (int k = 0; k < 3; ++k) {
        a.xc[k] = live ? in.anc_xc[3 * ii + k] : 0.f;
        a.mean[k] = live ? in.anc_mean[3 * ii + k] : 0.f;
        a.nrm[k] = live ? in.anc_normal[3 * ii + k] : 0.f;
      }
      for (int k = 0; k < 9; ++k) a.sqi[k] = live ? in.anc_sqi[9 * ii + k] : 0.f;
      a.w = live ? in.anc_w[ii] : 0.f;
      a.outlier = false;
    }
  }

  float q[4], t[3];
  int step = 0;   // GN steps run, all rounds; the same in every thread
  for (int k = 0; k < 4; ++k) q[k] = q0[k];
  for (int k = 0; k < 3; ++k) t[k] = t0[k];

  for (int rd = 0; rd < in.rounds; ++rd) {
    const bool use_huber = rd < 3;
    for (int k = 0; k < 4; ++k) q[k] = q0[k];
    for (int k = 0; k < 3; ++k) t[k] = t0[k];
    for (int it = 0; it < in.iters; ++it) {
      float R[3][3];
      quat_to_R(q, R);
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < FPT; ++j) {
        float r[3], J[3][6];
        if (f[j].valid && !f[j].outlier) {
          const float chi2 = reproj(in.cam, R, t, f[j], r, J);
          const float w = use_huber ? f[j].s2i * huber(chi2, f[j].delta) : f[j].s2i;
          accumulate(acc, r, J, w);
        }
        if constexpr (ANC) {
          const Anchor& a = an[j];
          if (a.type != 0 && (use_huber || !a.outlier)) {
            const float chi2a = anchor(R, t, a, r, J);
            const float w = use_huber ? a.w * huber(chi2a, anc_delta) : a.w;
            accumulate(acc, r, J, w);
          }
        }
      }
      const float ws = warp_transpose_sum(acc, lane);
      const int p = step & 1;
      if (lane < kSums) red[warp][lane] = ws;
      __syncthreads();
      if (warp == 0 && lane < kSums) {
        float bs = 0.f;
        for (int w = 0; w < nwarps; ++w) bs += red[w][lane];
#pragma unroll
        for (int dst = 0; dst < kCluster; ++dst)
          *cluster.map_shared_rank(&slots[p][rank][lane], dst) = bs;
      }
      cluster.sync();
      float s[kSums];
      cluster_sums(slots[p], lane, s);
      const bool done = gn_update(s, q, t, in.step_tol);
      ++step;
      if (done) break;  // uniform: every thread took the same decision
    }

    // reclassify every edge at this round's pose
    float R[3][3];
    quat_to_R(q, R);
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      float r[3], J[3][6];
      const float chi2 = reproj(in.cam, R, t, f[j], r, J);
      f[j].outlier = f[j].valid && !(chi2 <= f[j].th);
      if constexpr (ANC) {
        Anchor& a = an[j];
        a.outlier = a.type != 0 && !(anchor(R, t, a, r, J) <= in.anc_gate);
      }
    }
  }

  // final chi2, flags and counts at the last round's pose
  float R[3][3];
  quat_to_R(q, R);
  int n_inl = 0, n_anc = 0;
#pragma unroll
  for (int j = 0; j < FPT; ++j) {
    const int i = begin + tid + j * blockDim.x;
    if (i < end) {
      float r[3], J[3][6];
      out.chi2[i] = reproj(in.cam, R, t, f[j], r, J);
      out.outlier[i] = f[j].outlier ? 1 : 0;
      if constexpr (ANC) out.anc_outlier[i] = an[j].outlier ? 1 : 0;
    }
    n_inl += (f[j].valid && !f[j].outlier) ? 1 : 0;
    if constexpr (ANC) n_anc += (an[j].type != 0 && !an[j].outlier) ? 1 : 0;
  }
  n_inl = __reduce_add_sync(kFull, n_inl);
  n_anc = __reduce_add_sync(kFull, n_anc);
  if (lane == 0) {
    cnt_red[warp][0] = n_inl;
    cnt_red[warp][1] = n_anc;
  }
  __syncthreads();
  if (tid < 2) {
    int c = 0;
    for (int w = 0; w < nwarps; ++w) c += cnt_red[w][tid];
    for (int dst = 0; dst < kCluster; ++dst)
      *cluster.map_shared_rank(&cnt_slots[rank][tid], dst) = c;
  }
  // the last barrier: after it no block writes to another's shared memory
  cluster.sync();
  if (rank == 0 && tid == 0) {
    int c0 = 0, c1 = 0;
    for (int r = 0; r < kCluster; ++r) {
      c0 += cnt_slots[r][0];
      c1 += cnt_slots[r][1];
    }
    for (int k = 0; k < 4; ++k) out.pose[k] = q[k];
    for (int k = 0; k < 3; ++k) out.pose[4 + k] = t[k];
    out.pose[7] = 0.f;
    out.counts[0] = c0;
    out.counts[1] = c1;
    out.counts[2] = step;
    out.counts[3] = 0;
  }
}

template <bool ANC, int FPT>
cudaError_t launch(const Inputs& in, const Outputs& out, int threads, cudaStream_t s) {
  auto kern = pose_solve_kernel<ANC, FPT>;
  if (kCluster > 8) {
    static bool allowed = false;   // clusters above 8 are not portable
    if (!allowed) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
      allowed = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, in, out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool ANC>
cudaError_t dispatch(const Inputs& in, const Outputs& out, cudaStream_t s) {
  // the fewest features per thread that fit a block of kMaxThreads
  const int pb = in.per_block;
  for (int fpt = 1; fpt <= 4; fpt *= 2) {
    const int need = (pb + fpt - 1) / fpt;
    if (need <= kMaxThreads) {
      const int threads = need <= 32 ? 32 : (need + 31) / 32 * 32;
      if (fpt == 1) return launch<ANC, 1>(in, out, threads, s);
      if (fpt == 2) return launch<ANC, 2>(in, out, threads, s);
      return launch<ANC, 4>(in, out, threads, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Most features one solve takes.
extern "C" int gmmloc_pose_max_features() { return kCluster * kMaxThreads * 4; }

extern "C" int gmmloc_pose_solve(
    const void* q0, const void* t0, const void* x_w, const void* obs,
    const void* stereo, const void* s2i, const void* valid, const void* anc_xc,
    const void* anc_mean, const void* anc_normal, const void* anc_sqi,
    const void* anc_type, const void* anc_w, float anc_gate, int n,
    int use_anchors, int rounds, int iters, float step_tol, float fx, float fy,
    float cx, float cy, float bf, void* pose_out, void* counts_out,
    void* chi2_out, void* outlier_out, void* anc_outlier_out, void* stream) {
  Inputs in;
  in.q0 = static_cast<const float*>(q0);
  in.t0 = static_cast<const float*>(t0);
  in.x_w = static_cast<const float*>(x_w);
  in.obs = static_cast<const float*>(obs);
  in.stereo = static_cast<const uint8_t*>(stereo);
  in.s2i = static_cast<const float*>(s2i);
  in.valid = static_cast<const uint8_t*>(valid);
  in.anc_xc = static_cast<const float*>(anc_xc);
  in.anc_mean = static_cast<const float*>(anc_mean);
  in.anc_normal = static_cast<const float*>(anc_normal);
  in.anc_sqi = static_cast<const float*>(anc_sqi);
  in.anc_type = static_cast<const int32_t*>(anc_type);
  in.anc_w = static_cast<const float*>(anc_w);
  in.anc_gate = anc_gate;
  in.n = n;
  in.per_block = (n + kCluster - 1) / kCluster;
  in.rounds = rounds;
  in.iters = iters;
  in.step_tol = step_tol;
  in.cam = Cam{fx, fy, cx, cy, bf};
  Outputs out;
  out.pose = static_cast<float*>(pose_out);
  out.counts = static_cast<int32_t*>(counts_out);
  out.chi2 = static_cast<float*>(chi2_out);
  out.outlier = static_cast<uint8_t*>(outlier_out);
  out.anc_outlier = static_cast<uint8_t*>(anc_outlier_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = use_anchors ? dispatch<true>(in, out, s) : dispatch<false>(in, out, s);
  return static_cast<int>(e);
}
