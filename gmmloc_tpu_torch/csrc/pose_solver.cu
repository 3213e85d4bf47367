// Staged pose-only Gauss-Newton solve, one thread block per solve.
//
// Replaces the Pallas kernels of gmmloc_tpu/solver/pallas_pose.py:
//   K1  optimize_pose           (_make_kernel(use_anchors=False))
//   K2  optimize_pose_anchored  (_make_kernel(use_anchors=True))
// and computes what gmmloc_tpu_torch/solver/pose_solver.py computes:
// 4 rounds x up to 10 GN iterations over F features, each round restarting
// from the initial pose; per feature the stereo/mono reprojection residual
// and its 6-column Jacobian (Huber-weighted in rounds 0-2); per iteration
// the 21+6 normal-equation sums, +1e-6 on the diagonal, a 6x6 Cholesky
// solve and the quaternion boxplus, stopping early on max|dx| < step_tol or
// a non-finite step; after each round the chi2 reclassification. K2 adds
// one GMM anchor edge per feature (1-D point-to-plane for a degenerate
// component weighted by anc_w, 3-D sqrt-info whitened otherwise) with its
// own Huber weight, chi2 gate and outlier flags.
//
// What bounds it on the card: latency, not bytes or FLOPs. F=1280 features
// are ~60 KB of input and one iteration is ~100 FLOPs per feature, but the
// 40 iterations are a serial chain: each needs a block-wide reduction of
// 27 sums, then one scalar 6x6 solve, before the next can start. The
// design keeps the whole chain inside one launch on one SM (no host round
// trip, no second kernel): 256 threads each own F/256 features, the 27
// sums go through warp shuffles and then shared memory, thread 0 solves
// and broadcasts the pose through shared memory. The per-feature inputs
// are re-read from global memory each iteration and stay in L1/L2.
// Sums are taken in another order than the PyTorch version, so the two
// agree to float tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 upper-triangle H + 6 b

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct PoseState {
  float q[4];
  float t[3];
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

// Reprojection residual rows (u, v, ur), Jacobian rows and chi2 of one
// feature at pose (R, t).
__device__ inline float reproj(const Cam& c, const float R[3][3], const float* t,
                               const float* xw, const float* obs, float st,
                               float s2i, float r[3], float J[3][6]) {
  float pcx = R[0][0] * xw[0] + R[0][1] * xw[1] + R[0][2] * xw[2] + t[0];
  float pcy = R[1][0] * xw[0] + R[1][1] * xw[1] + R[1][2] * xw[2] + t[1];
  float pcz = R[2][0] * xw[0] + R[2][1] * xw[1] + R[2][2] * xw[2] + t[2];
  float zs = fabsf(pcz) < 1e-9f ? 1e-9f : pcz;
  float iz = 1.f / zs;
  float iz2 = iz * iz;
  float u = c.fx * pcx * iz + c.cx;
  float v = c.fy * pcy * iz + c.cy;
  float ur = u - c.bf * iz;
  r[0] = u - obs[0];
  r[1] = v - obs[1];
  r[2] = (ur - obs[2]) * st;
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
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * s2i;
}

// Anchor residual rows, Jacobian rows and chi2 of one feature.
__device__ inline float anchor(const float R[3][3], const float* t, const float* xc,
                               const float* mean, const float* nrm, const float* sqi,
                               bool deg, float w, float r[3], float J[3][6]) {
  float dxc[3] = {xc[0] - t[0], xc[1] - t[1], xc[2] - t[2]};
  float d[3];
  for (int i = 0; i < 3; ++i)
    d[i] = R[0][i] * dxc[0] + R[1][i] * dxc[1] + R[2][i] * dxc[2] - mean[i];
  // M = [skew(xc) | -I]; Jx[i][j] = sum_k R[k][i] M[k][j]
  float sk[3][3] = {{0.f, -xc[2], xc[1]}, {xc[2], 0.f, -xc[0]}, {-xc[1], xc[0], 0.f}};
  float Jx[3][6];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Jx[i][j] = R[0][i] * sk[0][j] + R[1][i] * sk[1][j] + R[2][i] * sk[2][j];
    for (int j = 0; j < 3; ++j) Jx[i][3 + j] = -R[j][i];
  }
  if (deg) {
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
    for (int i = 0; i < 3; ++i) {
      r[i] = sqi[0 * 3 + i] * d[0] + sqi[1 * 3 + i] * d[1] + sqi[2 * 3 + i] * d[2];
      for (int j = 0; j < 6; ++j)
        J[i][j] = sqi[0 * 3 + i] * Jx[0][j] + sqi[1 * 3 + i] * Jx[1][j] +
                  sqi[2 * 3 + i] * Jx[2][j];
    }
  }
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * w;
}

__device__ inline float huber(float chi2, float delta) {
  float s = sqrtf(fmaxf(chi2, 1e-24f));
  return s <= delta ? 1.f : delta / s;
}

__device__ inline void accumulate(float acc[kSums], const float r[3],
                                  const float J[3][6], float w) {
  int k = 0;
  for (int a = 0; a < 6; ++a) {
    for (int c = a; c < 6; ++c) {
      acc[k++] += w * (J[0][a] * J[0][c] + J[1][a] * J[1][c] + J[2][a] * J[2][c]);
    }
  }
  for (int a = 0; a < 6; ++a)
    acc[21 + a] += w * (J[0][a] * r[0] + J[1][a] * r[1] + J[2][a] * r[2]);
}

// 6x6 Cholesky solve H x = b with the reference's pivot clamp.
__device__ void chol_solve6(float H[6][6], const float b[6], float x[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    float s = H[i][i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-20f));
    for (int j = i + 1; j < 6; ++j) {
      float s2 = H[j][i];
      for (int k = 0; k < i; ++k) s2 -= L[j][k] * L[i][k];
      L[j][i] = s2 / L[i][i];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// exp(dx) * (q, t), quaternion renormalized (se3.boxplus).
__device__ void boxplus(const float* q, const float* t, const float dx[6],
                        float qn[4], float tn[3]) {
  float w0 = dx[0], w1 = dx[1], w2 = dx[2];
  float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  float theta = sqrtf(fmaxf(theta2, 1e-24f));
  bool small = theta2 < 1e-12f;
  float qw = small ? 1.f - theta2 / 8.f : cosf(0.5f * theta);
  float s = small ? 0.5f - theta2 / 48.f : sinf(0.5f * theta) / theta;
  float dq[4] = {qw, w0 * s, w1 * s, w2 * s};
  float dn = rsqrtf(fmaxf(dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2] + dq[3] * dq[3], 1e-24f));
  for (int i = 0; i < 4; ++i) dq[i] *= dn;
  float a = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta)) / fmaxf(theta2, 1e-24f);
  float bb = small ? 1.f / 6.f - theta2 / 120.f
                   : (theta - sinf(theta)) / fmaxf(theta2 * theta, 1e-24f);
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

__device__ inline float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

struct Inputs {
  const float* pose0;         // (7,) q0, t0
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
  int rounds, iters;
  float step_tol;
  Cam cam;
};

struct Outputs {
  float* pose;          // (16,) q(4) t(3) n_inliers n_anchors
  float* chi2;          // (F,)
  uint8_t* outlier;     // (F,) bool
  uint8_t* anc_outlier;  // (F,) bool (K2 only)
};

template <bool ANC>
__global__ void __launch_bounds__(kThreads)
pose_solve_kernel(Inputs in, Outputs out) {
  __shared__ float red[kWarps][kSums];
  __shared__ PoseState cur;
  __shared__ int done;
  __shared__ int counts[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = in.n;
  const float q0[4] = {in.pose0[0], in.pose0[1], in.pose0[2], in.pose0[3]};
  const float t0[3] = {in.pose0[4], in.pose0[5], in.pose0[6]};
  const float anc_delta = sqrtf(fmaxf(in.anc_gate, 1e-24f));

  // per-round outlier flags live in the output arrays (each thread owns
  // its features, so no other thread touches them)
  for (int i = tid; i < n; i += kThreads) {
    out.outlier[i] = 0;
    if (ANC) out.anc_outlier[i] = 0;
  }
  float qf[4], tf[3];

  for (int rd = 0; rd < in.rounds; ++rd) {
    const bool use_huber = rd < 3;
    if (tid == 0) {
      for (int k = 0; k < 4; ++k) cur.q[k] = q0[k];
      for (int k = 0; k < 3; ++k) cur.t[k] = t0[k];
      done = 0;
    }
    __syncthreads();
    for (int it = 0; it < in.iters; ++it) {
      float q[4] = {cur.q[0], cur.q[1], cur.q[2], cur.q[3]};
      float t[3] = {cur.t[0], cur.t[1], cur.t[2]};
      float R[3][3];
      quat_to_R(q, R);
      float acc[kSums];
      for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        float r[3], J[3][6];
        const float st = in.stereo[i] ? 1.f : 0.f;
        const float s2i = in.s2i[i];
        const float chi2 = reproj(in.cam, R, t, in.x_w + 3 * i, in.obs + 3 * i, st, s2i, r, J);
        const bool active = in.valid[i] && !out.outlier[i];
        if (active) {
          float w = s2i;
          if (use_huber) w *= huber(chi2, sqrtf(st > 0.f ? 7.815f : 5.991f));
          accumulate(acc, r, J, w);
        }
        if (ANC) {
          const int ty = in.anc_type[i];
          const bool active_anc = ty != 0 && (use_huber || !out.anc_outlier[i]);
          if (active_anc) {
            const float aw = in.anc_w[i];
            const float chi2a = anchor(R, t, in.anc_xc + 3 * i, in.anc_mean + 3 * i,
                                       in.anc_normal + 3 * i, in.anc_sqi + 9 * i,
                                       ty == 1, aw, r, J);
            float w = aw;
            if (use_huber) w *= huber(chi2a, anc_delta);
            accumulate(acc, r, J, w);
          }
        }
      }
      for (int k = 0; k < kSums; ++k) {
        const float v = warp_sum(acc[k]);
        if (lane == 0) red[warp][k] = v;
      }
      __syncthreads();
      if (tid == 0) {
        float s[kSums];
        for (int k = 0; k < kSums; ++k) {
          float v = 0.f;
          for (int w = 0; w < kWarps; ++w) v += red[w][k];
          s[k] = v;
        }
        float H[6][6], b[6], dx[6];
        int k = 0;
        for (int a = 0; a < 6; ++a)
          for (int c = a; c < 6; ++c) {
            H[a][c] = s[k];
            H[c][a] = s[k];
            ++k;
          }
        for (int a = 0; a < 6; ++a) {
          H[a][a] += 1e-6f;
          b[a] = s[21 + a];
        }
        chol_solve6(H, b, dx);
        float maxdx = 0.f;
        for (int a = 0; a < 6; ++a) {
          dx[a] = -dx[a];
          maxdx = fmaxf(maxdx, fabsf(dx[a]));
        }
        float qn[4], tn[3];
        boxplus(q, t, dx, qn, tn);
        bool ok = true;
        for (int a = 0; a < 4; ++a) ok = ok && isfinite(qn[a]);
        for (int a = 0; a < 3; ++a) ok = ok && isfinite(tn[a]);
        if (ok) {
          for (int a = 0; a < 4; ++a) cur.q[a] = qn[a];
          for (int a = 0; a < 3; ++a) cur.t[a] = tn[a];
        }
        // a NaN step compares false: the non-finite check stops it
        done = (!ok || maxdx < in.step_tol) ? 1 : 0;
      }
      __syncthreads();
      if (done) break;  // uniform: every thread read the same flag
    }
    for (int k = 0; k < 4; ++k) qf[k] = cur.q[k];
    for (int k = 0; k < 3; ++k) tf[k] = cur.t[k];

    // reclassify every valid edge at this round's pose
    float R[3][3];
    quat_to_R(qf, R);
    for (int i = tid; i < n; i += kThreads) {
      float r[3], J[3][6];
      const float st = in.stereo[i] ? 1.f : 0.f;
      const float chi2 = reproj(in.cam, R, tf, in.x_w + 3 * i, in.obs + 3 * i, st, in.s2i[i], r, J);
      const float th = st > 0.f ? 7.815f : 5.991f;
      out.outlier[i] = (in.valid[i] && !(chi2 <= th)) ? 1 : 0;
      if (ANC) {
        const int ty = in.anc_type[i];
        bool ao = false;
        if (ty != 0) {
          const float chi2a = anchor(R, tf, in.anc_xc + 3 * i, in.anc_mean + 3 * i,
                                     in.anc_normal + 3 * i, in.anc_sqi + 9 * i,
                                     ty == 1, in.anc_w[i], r, J);
          ao = !(chi2a <= in.anc_gate);
        }
        out.anc_outlier[i] = ao ? 1 : 0;
      }
    }
    __syncthreads();  // `cur` is rewritten by the next round
  }

  // final chi2 and counts at the last round's pose
  if (tid == 0) {
    counts[0] = 0;
    counts[1] = 0;
  }
  __syncthreads();
  float R[3][3];
  quat_to_R(qf, R);
  int n_inl = 0, n_anc = 0;
  for (int i = tid; i < n; i += kThreads) {
    float r[3], J[3][6];
    const float st = in.stereo[i] ? 1.f : 0.f;
    out.chi2[i] = reproj(in.cam, R, tf, in.x_w + 3 * i, in.obs + 3 * i, st, in.s2i[i], r, J);
    n_inl += (in.valid[i] && !out.outlier[i]) ? 1 : 0;
    if (ANC) n_anc += (in.anc_type[i] != 0 && !out.anc_outlier[i]) ? 1 : 0;
  }
  atomicAdd(&counts[0], n_inl);
  atomicAdd(&counts[1], n_anc);
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) out.pose[k] = qf[k];
    for (int k = 0; k < 3; ++k) out.pose[4 + k] = tf[k];
    out.pose[7] = (float)counts[0];
    out.pose[8] = (float)counts[1];
    for (int k = 9; k < 16; ++k) out.pose[k] = 0.f;
  }
}

}  // namespace

extern "C" int gmmloc_pose_solve(
    const void* pose0, const void* x_w, const void* obs, const void* stereo,
    const void* s2i, const void* valid, const void* anc_xc, const void* anc_mean,
    const void* anc_normal, const void* anc_sqi, const void* anc_type,
    const void* anc_w, float anc_gate, int n, int use_anchors, int rounds,
    int iters, float step_tol, float fx, float fy, float cx, float cy, float bf,
    void* pose_out, void* chi2_out, void* outlier_out, void* anc_outlier_out,
    void* stream) {
  Inputs in;
  in.pose0 = static_cast<const float*>(pose0);
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
  in.rounds = rounds;
  in.iters = iters;
  in.step_tol = step_tol;
  in.cam = Cam{fx, fy, cx, cy, bf};
  Outputs out;
  out.pose = static_cast<float*>(pose_out);
  out.chi2 = static_cast<float*>(chi2_out);
  out.outlier = static_cast<uint8_t*>(outlier_out);
  out.anc_outlier = static_cast<uint8_t*>(anc_outlier_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_anchors) {
    pose_solve_kernel<true><<<1, kThreads, 0, s>>>(in, out);
  } else {
    pose_solve_kernel<false><<<1, kThreads, 0, s>>>(in, out);
  }
  return static_cast<int>(cudaGetLastError());
}
