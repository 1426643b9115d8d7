// K1: the drag-iteration block — sync_k masked Adam steps of the drag loss
// for every lane, gradient written by hand.
//
// Replaces the TPU kernel dragposer_tpu/drag/iter_kernel.py:run_block_fused
// (pallas_call at iter_kernel.py:349, body _kernel and _forward).  It computes
// the same formulas, masked bookkeeping and stop rule as
// dragposer_tpu/drag/fast_iter.py:run_block (:312-342): per step the folded
// decoder (3 matmuls, LeakyReLU 0.2), quat de-normalization and x/|x|, the
// world root and joint quaternions, the displacement rotation, FK over the
// parent chain, the 3-term loss (weighted position MSE, 9-plane
// rotation-matrix MSE, temporal latent MSE), its gradient, and Adam with
// bias correction.  The TPU kernel took its gradient with jax.vjp inside the
// kernel; here the backward is the hand-written reverse of each stage.
//
// What bounds it on the H100: arithmetic and instruction issue.  One step is
// ~70 kFLOP per lane (the decoder and its transpose are ~36 kFLOP of it) on
// ~100 floats of state, so nothing needs device memory inside the loop: the
// block reads its lanes' inputs once and writes the final state once.
//
// What the design does about it: one warp per lane and a loop over the
// sync_k steps inside the kernel (the TPU's sequential k grid axis).  The
// decoder weights (W1 40x24, W2 60x40, W3 91x60, ~37 KB) sit in shared
// memory with odd row strides, so both the forward (threads over output
// rows) and the transposed backward (threads over input columns) read them
// without bank conflicts.  The joints map to the warp's threads; the
// one-hot parent matrix P and the ancestor matrix A of the TPU kernel become
// a walk up the parent chain (forward) and a reverse-topological subtree
// sum (backward) — the same function, reassociated.  A lane whose stop rule
// holds leaves the loop and does not move.  Float32 throughout, IEEE sqrt
// and division (no fast-math).
//
// Plain C interface, loaded with ctypes
// (dragposer_tpu_torch/drag/iter_kernel.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;    // lanes per block
constexpr int MAXJ = 32;    // joints  (one per thread of the warp)
constexpr int MAXL = 32;    // latent dims
constexpr int MAXH = 64;    // hidden widths H1, H2
constexpr int MAXH3 = 4 * MAXJ + 4;
constexpr float B1 = 0.9f, B2 = 0.999f, ADAM_EPS = 1e-8f;
constexpr float C1 = static_cast<float>(1.0 - 0.9);
constexpr float C2 = static_cast<float>(1.0 - 0.999);
constexpr float SLOPE = 0.2f;

// per-warp scratch (floats)
constexpr int O_Z = 0;
constexpr int O_H1 = O_Z + MAXL;
constexpr int O_H2 = O_H1 + MAXH;
constexpr int O_H3 = O_H2 + MAXH;
constexpr int O_G3 = O_H3 + MAXH3;
constexpr int O_G2 = O_G3 + MAXH3;
constexpr int O_G1 = O_G2 + MAXH;
constexpr int O_WQ = O_G1 + MAXH;         // world quats, 4 x MAXJ
constexpr int O_CT = O_WQ + 4 * MAXJ;     // FK contributions, 3 x MAXJ
constexpr int O_SB = O_CT + 3 * MAXJ;     // subtree position grads, 3 x MAXJ
constexpr int O_DQ = O_SB + 3 * MAXJ;     // grads sent to the parent, 4 x MAXJ
constexpr int SCRATCH = O_DQ + 4 * MAXJ;

struct Params {
  // constants (device)
  const float *W1, *b1, *W2, *b2, *W3, *b3, *sq, *mq, *sd, *md, *offs;
  const int* parents;
  const float *w_pos, *w_rot, *n_ee;
  int w_lane_stride, w_row_stride, n_ee_stride;
  // per-lane inputs
  const float *gr, *tpos, *trot, *tlat;
  const unsigned char* lane_act;
  const float *z0, *m0, *v0, *d0;
  const int* t0;
  const float *pl0, *lp0, *lr0, *li0;
  // outputs
  float *z, *m, *v, *dec;
  int* t;
  float *prev, *lp, *lr, *li;
  // sizes and hyperparameters
  int B, J, L, H1, H2, H3, sync_k, max_iter;
  float eps_pos, eps_rot, min_incr, lr_adam, lambda_rot, lambda_t;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* c) {
  c[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  c[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  c[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  c[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ void qconj(const float* a, float* c) {
  c[0] = a[0]; c[1] = -a[1]; c[2] = -a[2]; c[3] = -a[3];
}

// r = v + 2 (qw c1 + c2), c1 = qv x v, c2 = qv x c1 (fast_iter._qrot)
__device__ __forceinline__ void qrot(const float* q, const float* v, float* r) {
  const float c1x = q[2] * v[2] - q[3] * v[1];
  const float c1y = q[3] * v[0] - q[1] * v[2];
  const float c1z = q[1] * v[1] - q[2] * v[0];
  const float c2x = q[2] * c1z - q[3] * c1y;
  const float c2y = q[3] * c1x - q[1] * c1z;
  const float c2z = q[1] * c1y - q[2] * c1x;
  r[0] = v[0] + 2.f * (q[0] * c1x + c2x);
  r[1] = v[1] + 2.f * (q[0] * c1y + c2y);
  r[2] = v[2] + 2.f * (q[0] * c1z + c2z);
}

// Gradients of g·qrot(q, v): with respect to q (gq) and to v (gv).
__device__ __forceinline__ void qrot_grad(const float* q, const float* v,
                                          const float* g, float* gq,
                                          float* gv) {
  const float qx = q[1], qy = q[2], qz = q[3], qw = q[0];
  const float c1x = qy * v[2] - qz * v[1];
  const float c1y = qz * v[0] - qx * v[2];
  const float c1z = qx * v[1] - qy * v[0];
  const float gq_dot = g[0] * qx + g[1] * qy + g[2] * qz;
  const float qv_dot = qx * v[0] + qy * v[1] + qz * v[2];
  const float gv_dot = g[0] * v[0] + g[1] * v[1] + g[2] * v[2];
  const float qq = qx * qx + qy * qy + qz * qz;
  if (gq) {
    // v x g
    const float vgx = v[1] * g[2] - v[2] * g[1];
    const float vgy = v[2] * g[0] - v[0] * g[2];
    const float vgz = v[0] * g[1] - v[1] * g[0];
    gq[0] = 2.f * (c1x * g[0] + c1y * g[1] + c1z * g[2]);
    gq[1] = 2.f * (qw * vgx + gq_dot * v[0] + qv_dot * g[0] - 2.f * gv_dot * qx);
    gq[2] = 2.f * (qw * vgy + gq_dot * v[1] + qv_dot * g[1] - 2.f * gv_dot * qy);
    gq[3] = 2.f * (qw * vgz + gq_dot * v[2] + qv_dot * g[2] - 2.f * gv_dot * qz);
  }
  if (gv) {
    // g x qv
    const float gqx = g[1] * qz - g[2] * qy;
    const float gqy = g[2] * qx - g[0] * qz;
    const float gqz = g[0] * qy - g[1] * qx;
    gv[0] = g[0] + 2.f * (qw * gqx + gq_dot * qx - qq * g[0]);
    gv[1] = g[1] + 2.f * (qw * gqy + gq_dot * qy - qq * g[1]);
    gv[2] = g[2] + 2.f * (qw * gqz + gq_dot * qz - qq * g[2]);
  }
}

// 9 planes of quat.to_matrix, row-major.
__device__ __forceinline__ void to_matrix(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float x2 = x + x, y2 = y + y, z2 = z + z;
  const float xx = x * x2, yy = y * y2, zz = z * z2;
  const float wx = w * x2, wy = w * y2, wz = w * z2;
  const float xy = x * y2, xz = x * z2, yz = y * z2;
  m[0] = 1.f - (yy + zz); m[1] = xy - wz;          m[2] = xz + wy;
  m[3] = xy + wz;          m[4] = 1.f - (xx + zz); m[5] = yz - wx;
  m[6] = xz - wy;          m[7] = yz + wx;          m[8] = 1.f - (xx + yy);
}

// Gradient of sum_k gm[k] m_k(q) with respect to q.
__device__ __forceinline__ void to_matrix_grad(const float* q, const float* g,
                                               float* gq) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  gq[0] = 2.f * (-z * g[1] + y * g[2] + z * g[3] - x * g[5] - y * g[6] +
                 x * g[7]);
  gq[1] = 2.f * (y * g[1] + z * g[2] + y * g[3] - 2.f * x * g[4] - w * g[5] +
                 z * g[6] + w * g[7] - 2.f * x * g[8]);
  gq[2] = 2.f * (-2.f * y * g[0] + x * g[1] + w * g[2] + x * g[3] +
                 z * g[5] - w * g[6] + z * g[7] - 2.f * y * g[8]);
  gq[3] = 2.f * (-2.f * z * g[0] - w * g[1] + x * g[2] + w * g[3] -
                 2.f * z * g[4] + y * g[5] + x * g[6] + y * g[7]);
}

__device__ __forceinline__ float leaky(float a) { return a >= 0.f ? a : SLOPE * a; }

__global__ void __launch_bounds__(WARPS * 32)
iter_block_kernel(Params p, int ld1, int ld2, int ld3) {
  extern __shared__ float4 smem4[];
  float* sW1 = reinterpret_cast<float*>(smem4);
  float* sW2 = sW1 + p.H1 * ld1;
  float* sW3 = sW2 + p.H2 * ld2;
  float* sb1 = sW3 + p.H3 * ld3;
  float* sb2 = sb1 + p.H1;
  float* sb3 = sb2 + p.H2;
  float* ssq = sb3 + p.H3;
  float* smq = ssq + 4 * p.J;
  float* soff = smq + 4 * p.J;               // (J, 3)
  float* sdm = soff + 3 * p.J;               // sd[3], md[3]
  int* spar = reinterpret_cast<int*>(sdm + 6);
  float* scratch = reinterpret_cast<float*>(spar + MAXJ);

  const int J = p.J, L = p.L, H1 = p.H1, H2 = p.H2, H3 = p.H3;
  for (int i = threadIdx.x; i < H1 * p.L; i += blockDim.x)
    sW1[(i / L) * ld1 + i % L] = p.W1[i];
  for (int i = threadIdx.x; i < H2 * H1; i += blockDim.x)
    sW2[(i / H1) * ld2 + i % H1] = p.W2[i];
  for (int i = threadIdx.x; i < H3 * H2; i += blockDim.x)
    sW3[(i / H2) * ld3 + i % H2] = p.W3[i];
  for (int i = threadIdx.x; i < H1; i += blockDim.x) sb1[i] = p.b1[i];
  for (int i = threadIdx.x; i < H2; i += blockDim.x) sb2[i] = p.b2[i];
  for (int i = threadIdx.x; i < H3; i += blockDim.x) sb3[i] = p.b3[i];
  for (int i = threadIdx.x; i < 4 * J; i += blockDim.x) {
    ssq[i] = p.sq[i];
    smq[i] = p.mq[i];
  }
  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x) soff[i] = p.offs[i];
  if (threadIdx.x < 3) {
    sdm[threadIdx.x] = p.sd[threadIdx.x];
    sdm[3 + threadIdx.x] = p.md[threadIdx.x];
  }
  for (int i = threadIdx.x; i < J; i += blockDim.x) spar[i] = p.parents[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= p.B) return;
  float* S = scratch + warp * SCRATCH;
  float* sZ = S + O_Z;
  float* sH1 = S + O_H1;
  float* sH2 = S + O_H2;
  float* sH3 = S + O_H3;
  float* sG3 = S + O_G3;
  float* sG2 = S + O_G2;
  float* sG1 = S + O_G1;
  float* sWQ = S + O_WQ;
  float* sCT = S + O_CT;
  float* sSB = S + O_SB;
  float* sDQ = S + O_DQ;
  const int B = p.B;
  const bool is_joint = t < J;
  const bool is_lat = t < L;

  // ---- per-lane inputs, read once ----
  float tp[3] = {0.f, 0.f, 0.f}, tr[9] = {}, wp = 0.f, wr = 0.f;
  float off[3] = {0.f, 0.f, 0.f};
  int par = 0;
  if (is_joint) {
    for (int c = 0; c < 3; ++c) tp[c] = p.tpos[(t * 3 + c) * B + b];
    for (int k = 0; k < 9; ++k) tr[k] = p.trot[(t * 9 + k) * B + b];
    wp = p.w_pos[t * p.w_row_stride + b * p.w_lane_stride];
    wr = p.w_rot[t * p.w_row_stride + b * p.w_lane_stride];
    for (int c = 0; c < 3; ++c) off[c] = soff[t * 3 + c];
    par = spar[t];
  }
  float z = 0.f, m = 0.f, v = 0.f, dec = 0.f, tl = 0.f;
  if (is_lat) {
    z = p.z0[b * L + t];
    m = p.m0[b * L + t];
    v = p.v0[b * L + t];
    dec = p.d0[b * L + t];
    tl = p.tlat[b * L + t];
  }
  const float gr[4] = {p.gr[b * 4 + 0], p.gr[b * 4 + 1], p.gr[b * 4 + 2],
                       p.gr[b * 4 + 3]};
  const float n_ee = p.n_ee[b * p.n_ee_stride];
  const bool act = p.lane_act[b] != 0;
  int it = p.t0[b];
  float prev = p.pl0[b], lp = p.lp0[b], lr = p.lr0[b], li = p.li0[b];
  const float sd[3] = {sdm[0], sdm[1], sdm[2]};
  const float md[3] = {sdm[3], sdm[4], sdm[5]};
  const float pos_scale = n_ee * 3.f;
  const float rot_scale = n_ee * 9.f;

  for (int k = 0; k < p.sync_k; ++k) {
    const bool active = ((lp > p.eps_pos) || (lr > p.eps_rot)) &&
                        (it < p.max_iter) && (li > p.min_incr) && act;
    if (!active) break;   // warp-uniform: every thread holds the same values

    // ---------------- forward ----------------
    if (is_lat) sZ[t] = z;
    __syncwarp();
    for (int o = t; o < H1; o += 32) {
      float a = 0.f;
      for (int i = 0; i < L; ++i) a = fmaf(sW1[o * ld1 + i], sZ[i], a);
      sH1[o] = leaky(a + sb1[o]);
    }
    __syncwarp();
    for (int o = t; o < H2; o += 32) {
      float a = 0.f;
      for (int i = 0; i < H1; ++i) a = fmaf(sW2[o * ld2 + i], sH1[i], a);
      sH2[o] = leaky(a + sb2[o]);
    }
    __syncwarp();
    for (int o = t; o < H3; o += 32) {
      float a = 0.f;
      for (int i = 0; i < H2; ++i) a = fmaf(sW3[o * ld3 + i], sH2[i], a);
      sH3[o] = a + sb3[o];
    }
    __syncwarp();

    // joint quats: rows are component-major (c * J + j)
    float x[4] = {0.f, 0.f, 0.f, 1.f}, u[4] = {1.f, 0.f, 0.f, 0.f};
    float nrm = 1.f;
    if (is_joint) {
      for (int c = 0; c < 4; ++c)
        x[c] = sH3[c * J + t] * ssq[c * J + t] + smq[c * J + t];
      nrm = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3]);
      for (int c = 0; c < 4; ++c) u[c] = x[c] / nrm;
    }
    float disp[3];
    for (int c = 0; c < 3; ++c) disp[c] = sH3[4 * J + c] * sd[c] + md[c];
    float q0[4];
    for (int c = 0; c < 4; ++c) q0[c] = __shfl_sync(0xffffffffu, u[c], 0);
    float W[4];
    qmul(gr, q0, W);
    float world[4] = {W[0], W[1], W[2], W[3]};
    if (t > 0 && is_joint) qmul(W, u, world);
    float wd[3];
    qrot(W, disp, wd);
    if (is_joint)
      for (int c = 0; c < 4; ++c) sWQ[c * MAXJ + t] = world[c];
    __syncwarp();
    float pw[4] = {1.f, 0.f, 0.f, 0.f};
    float contrib[3] = {0.f, 0.f, 0.f};
    if (is_joint) {
      for (int c = 0; c < 4; ++c) pw[c] = sWQ[c * MAXJ + par];
      qrot(pw, off, contrib);
      for (int c = 0; c < 3; ++c) sCT[c * MAXJ + t] = contrib[c];
    }
    __syncwarp();
    float dpos[3] = {0.f, 0.f, 0.f}, lp_j = 0.f, lr_j = 0.f;
    float rm[9], drot[9];
    if (is_joint) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int a = t; a != 0; a = spar[a])
        for (int c = 0; c < 3; ++c) acc[c] += sCT[c * MAXJ + a];
      for (int c = 0; c < 3; ++c) dpos[c] = acc[c] + wd[c] - tp[c];
      lp_j = wp * (dpos[0] * dpos[0] + dpos[1] * dpos[1] + dpos[2] * dpos[2]);
      to_matrix(world, rm);
      float s = 0.f;
      for (int q = 0; q < 9; ++q) {
        drot[q] = rm[q] - tr[q];
        s += drot[q] * drot[q];
      }
      lr_j = wr * s;
    }
    const float dz_t = is_lat ? z - tl : 0.f;
    const float lp_n = warp_sum(lp_j) / pos_scale;
    const float lr_n = warp_sum(lr_j) / rot_scale * p.lambda_rot;
    const float lt = warp_sum(dz_t * dz_t) / L;
    const float total = lp_n + lr_n + lt * p.lambda_t;

    // ---------------- backward ----------------
    float gw[4] = {0.f, 0.f, 0.f, 0.f};   // d total / d world[t]
    float gpos[3] = {0.f, 0.f, 0.f};
    if (is_joint) {
      const float kp = 2.f * wp / pos_scale;
      for (int c = 0; c < 3; ++c) gpos[c] = kp * dpos[c];
      const float kr = p.lambda_rot * 2.f * wr / rot_scale;
      float gm[9];
      for (int q = 0; q < 9; ++q) gm[q] = kr * drot[q];
      to_matrix_grad(world, gm, gw);
      for (int c = 0; c < 3; ++c) sSB[c * MAXJ + t] = gpos[c];
    }
    float gwd[3];
    for (int c = 0; c < 3; ++c) gwd[c] = warp_sum(gpos[c]);
    __syncwarp();
    if (t == 0) {   // subtree sums, reverse topological order (parent < child)
      for (int j = J - 1; j >= 1; --j) {
        const int pj = spar[j];
        if (pj != 0)
          for (int c = 0; c < 3; ++c) sSB[c * MAXJ + pj] += sSB[c * MAXJ + j];
      }
    }
    __syncwarp();
    if (is_joint) {
      float gpw[4] = {0.f, 0.f, 0.f, 0.f};
      if (t > 0) {
        const float gc[3] = {sSB[t], sSB[MAXJ + t], sSB[2 * MAXJ + t]};
        qrot_grad(pw, off, gc, gpw, nullptr);
      }
      for (int c = 0; c < 4; ++c) sDQ[c * MAXJ + t] = gpw[c];
    }
    __syncwarp();
    float gu[4] = {0.f, 0.f, 0.f, 0.f};
    float gWp[4] = {0.f, 0.f, 0.f, 0.f};   // this joint's share of d/dW
    if (is_joint) {
      for (int j = 1; j < J; ++j)
        if (spar[j] == t)
          for (int c = 0; c < 4; ++c) gw[c] += sDQ[c * MAXJ + j];
      if (t == 0) {
        for (int c = 0; c < 4; ++c) gWp[c] = gw[c];
      } else {
        float cu[4], cW[4];
        qconj(u, cu);
        qmul(gw, cu, gWp);
        qconj(W, cW);
        qmul(cW, gw, gu);
      }
    }
    float gW[4];
    for (int c = 0; c < 4; ++c) gW[c] = warp_sum(gWp[c]);
    float gWd[4], gdisp[3];
    qrot_grad(W, disp, gwd, gWd, gdisp);
    for (int c = 0; c < 4; ++c) gW[c] += gWd[c];
    if (t == 0) {
      float cg[4];
      qconj(gr, cg);
      qmul(cg, gW, gu);
    }
    if (is_joint) {
      const float ug = u[0] * gu[0] + u[1] * gu[1] + u[2] * gu[2] + u[3] * gu[3];
      for (int c = 0; c < 4; ++c)
        sG3[c * J + t] = (gu[c] - u[c] * ug) / nrm * ssq[c * J + t];
    }
    if (t < 3) sG3[4 * J + t] = gdisp[t] * sd[t];
    __syncwarp();
    for (int i = t; i < H2; i += 32) {
      float a = 0.f;
      for (int o = 0; o < H3; ++o) a = fmaf(sW3[o * ld3 + i], sG3[o], a);
      sG2[i] = sH2[i] >= 0.f ? a : SLOPE * a;
    }
    __syncwarp();
    for (int i = t; i < H1; i += 32) {
      float a = 0.f;
      for (int o = 0; o < H2; ++o) a = fmaf(sW2[o * ld2 + i], sG2[o], a);
      sG1[i] = sH1[i] >= 0.f ? a : SLOPE * a;
    }
    __syncwarp();

    // ---------------- Adam ----------------
    if (is_lat) {
      float g = 0.f;
      for (int o = 0; o < H1; ++o) g = fmaf(sW1[o * ld1 + t], sG1[o], g);
      g += p.lambda_t * (2.f * dz_t / L);
      const float tf = static_cast<float>(it + 1);
      m = B1 * m + C1 * g;
      v = B2 * v + C2 * g * g;
      const float m_hat = m / (1.f - powf(B1, tf));
      const float v_hat = v / (1.f - powf(B2, tf));
      dec = z;
      z = z - p.lr_adam * m_hat / (sqrtf(v_hat) + ADAM_EPS);
    }
    it += 1;
    li = prev - total;
    prev = total;
    lp = lp_n;
    lr = lr_n;
    __syncwarp();
  }

  if (is_lat) {
    p.z[b * L + t] = z;
    p.m[b * L + t] = m;
    p.v[b * L + t] = v;
    p.dec[b * L + t] = dec;
  }
  if (t == 0) {
    p.t[b] = it;
    p.prev[b] = prev;
    p.lp[b] = lp;
    p.lr[b] = lr;
    p.li[b] = li;
  }
}

int odd(int n) { return n | 1; }

}  // namespace

extern "C" int iter_block_params_size() { return static_cast<int>(sizeof(Params)); }

// `params` points to a host Params struct filled by the wrapper (ctypes
// Structure of the same layout).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int iter_block(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.J > MAXJ || p.L > MAXL || p.H1 > MAXH || p.H2 > MAXH ||
      p.H3 != 4 * p.J + 3 || p.B < 1 || p.sync_k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld1 = odd(p.L), ld2 = odd(p.H1), ld3 = odd(p.H2);
  const size_t n_const = static_cast<size_t>(p.H1) * ld1 + p.H2 * ld2 +
                         p.H3 * ld3 + p.H1 + p.H2 + p.H3 + 8 * p.J +
                         3 * p.J + 6 + MAXJ;
  const size_t n_const4 = (n_const + 3) / 4 * 4;   // keep scratch aligned
  const size_t smem = (n_const4 + WARPS * SCRATCH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      iter_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (p.B + WARPS - 1) / WARPS;
  iter_block_kernel<<<grid, WARPS * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(p, ld1, ld2, ld3);
  return static_cast<int>(cudaGetLastError());
}
