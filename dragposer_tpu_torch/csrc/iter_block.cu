// K1: the drag-iteration block — sync_k masked Adam steps of the drag loss
// for every lane, the gradient written by hand, and the aux of each lane's
// last forward written by the kernel.
//
// Replaces the TPU kernel dragposer_tpu/drag/iter_kernel.py:run_block_fused
// (pallas_call at iter_kernel.py:349, body _kernel and _forward).  It computes
// the same formulas, masked bookkeeping and stop rule as
// dragposer_tpu/drag/fast_iter.py:run_block: per step the folded decoder
// (3 products, LeakyReLU 0.2), quat de-normalization and x/|x|, the world
// root and joint quaternions, the displacement rotation, FK over the parent
// chain, the 3-term loss (weighted position MSE, 9-plane rotation-matrix
// MSE, temporal latent MSE), its gradient, and Adam with bias correction.
// The TPU kernel took its gradient with jax.vjp inside the kernel and left
// the aux to XLA; here the backward is the hand-written reverse of each
// stage, and the aux (losses, root displacement and rotation, positions,
// normalized pose) comes from each lane's last forward, which is evaluated
// at the decoded latent.  A lane that takes no step gets one forward at its
// decoded latent.
//
// What bounds it on the H100: operations.  One step is 43 kFLOP per lane,
// 35 kFLOP of it the decoder and its transpose, on ~100 floats of state, so
// nothing needs device memory inside the loop.  On CUDA cores, with a
// weight and an activation read from shared memory for every multiply-add,
// the products alone take ~1,300 shared loads per lane-step.
//
// What the design does about it:
// - Lanes in tiles, as the TPU kernel put them on its 128-wide vector axis:
//   a tile of 16 lanes is the M of mma.sync.m16n8k8, and the decoder
//   (24 → 40 → 60 → 91) and its transpose (91 → 60 → 40 → 24) run as
//   tensor-core products in 3xTF32 (x = hi + lo; x·w ≈ lo·hi + hi·lo +
//   hi·hi in float32), as K2 does (csrc/temporal_forward.cu).  A product's
//   accumulator fragment (row g, columns 2t, 2t+1) is the next product's A
//   fragment (columns t, t+4) once the contraction index is numbered so
//   that column t is feature 2t and t+4 is 2t+1.
// - A team of 4 warps shares a tile: 8192 lanes make only 512 tiles, one
//   warp per SM sub-partition if a warp owned a tile, and every phase of
//   the step would wait out its own latency.  With 4 warps a tile, 4
//   tiles a block and a block an SM, each sub-partition interleaves 4
//   warps.  Each product is split by output tile (tile n to warp n % 4);
//   the activations pass through shared memory in the accumulator layout,
//   and the team meets at a named barrier of its own between the stages.
// - State that lives through the launch (latent, decoded latent, Adam's
//   moments, target latent) and the per-joint buffers sit in shared
//   memory: 512 threads a block leave 128 registers a thread, and spilled
//   registers would come back from L2 (L1 is small beside ~221 KB of
//   shared memory).
// - The weights are split once, on the host (drag/iter_kernel.py:
//   pack_fragments), padded to the tile, and held in shared memory once per
//   block (~77 KB hi + lo) in fragment order: the forward reads a float4
//   {hi, lo of feature 2t; hi, lo of 2t+1} per product, the transposed
//   backward a float2 {hi, lo} per operand from the same copy.  Fragments
//   are swizzled (position f ^ 2·(f >> 3)) so that both reads are free of
//   bank conflicts.
// - The per-joint stage runs over (lane, joint) pairs: thread th of the
//   team serves lane th & 15 and joints th >> 4, + 8, ...: 2–3 pairs a
//   thread at J = 22.  A joint's world rotation depends only on the root
//   (world = W ⊗ u_j); positions are ancestor sums and the backward's
//   position gradients descendant sums of per-joint terms, taken over bit
//   masks built on the host from the parents (the TPU kernel's ancestor
//   matrix A and its transpose).  No loop runs on one thread alone.
// - The stop rule per lane, with masks: a stopped lane's state is its
//   input, bit for bit; a team leaves the loop when all its lanes have
//   stopped.  Its backward is skipped when none of its lanes steps.
// - Everything else stays float32 on CUDA cores, with IEEE sqrt and
//   division (no fast-math).
//
// Two builds of the kernel, its limits template parameters (struct Build):
// - the narrow build (Narrow: J ≤ 32, L ≤ 32, H1/H2 ≤ 64; entries
//   iter_block*), the design above: its weights in shared memory, 4 tiles
//   a block, one 32-bit word a joint in each topology mask;
// - the general build (J ≤ 128, L ≤ 128, H1/H2 ≤ 272; entries
//   iter_block_resident*, iter_block_streamed{4,2,1}*) for every model past
//   the narrow limits.  Its weights are packed whole (8 × 8 blocks of
//   pairs, drag/iter_kernel.py:pack_weights: 42.5 KB at latent 48, 54.5
//   KB at a 33-joint chain, 190 KB at 64 joints, 0.76 MB at 128 joints and
//   latent 128) and split in registers into the hi and lo the narrow
//   build stores, so its sums are those of the design before it, bit for
//   bit.  A team's scratch (45.7 / 53.4 / 93.3 / 208 KB at those shapes)
//   sets the teams an SM holds, and 8192 lanes make 512 tiles: one wave
//   at 4 teams an SM.  The wrapper (iter_kernel.general_layout) takes
//   - Resident where the weights fit beside as many teams as an SM holds
//     without them: one copy a block, read by up to 4 teams (512 threads,
//     128 registers a thread), a tile a pass.  Latent 48: 4 teams, one
//     wave, the decoder's cycles a warp-step 37k → 31k at twice the warps
//     an SM.
//   - Streamed4 / Streamed2 / Streamed1 otherwise: a team a block, the
//     weights read from device memory (they stay in the 50 MB L2), built
//     for the 4, 2 or 1 blocks an SM its shared memory holds (Build's PASS
//     and RING).  The 33-joint chain takes Streamed4 (resident weights
//     would leave 3 teams an SM: 2 waves, 2.23 ms against 1.43), the
//     64-joint chain Streamed2 and 128 joints at latent 128 Streamed1.
//   Each joint's mask sums read four joints at a time (mask_sum): at a
//   64-joint chain the position and descendant sums take 42k cycles a
//   warp-step, 62k before.  A warp owns latent tiles w, w + 4, ...; a
//   joint's masks take (J + 31) / 32 words, summed in ascending joint
//   order as in the narrow build.  Own device time at B = 8192, sync_k =
//   24, latent 48 / 33 / 64 / 128 joints, on an H100 at 700 W: 0.83 /
//   1.43 / 4.27 / 21.8 ms; the design before it (a team a block, weights
//   split in device memory, 255 registers) 1.45 / 2.27–2.31 / 5.23 / 28.9
//   in the same call (PERF.md §6).
// The wrapper takes the narrow build wherever a model fits it, so the main
// path at the example's 22 joints runs the narrow kernel unchanged.
//
// A build of the same source with PASSES = 1 (entries iter_block_tf32,
// iter_block_<layout>_tf32) runs the products in one TF32 pass: the
// control that K1's tolerance must refuse, never on the main path.  The
// timed builds (iter_block_timed, iter_block_<layout>_timed) read the SM
// clock after each phase of each step.
//
// Plain C interface, loaded with ctypes
// (dragposer_tpu_torch/drag/iter_kernel.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 16;    // lanes per tile: the M of mma.m16n8k8
constexpr int FRAG = 128;   // floats of a packed fragment block (32 × 4)
constexpr float B1 = 0.9f, B2 = 0.999f, ADAM_EPS = 1e-8f;
constexpr float C1 = static_cast<float>(1.0 - 0.9);
constexpr float C2 = static_cast<float>(1.0 - 0.999);
constexpr float SLOPE = 0.2f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  // constants (device)
  const float* frags;          // W1, W2, W3 packed (pack_fragments), split
  const float *b1, *b2, *b3, *sq, *mq, *sd, *md, *offs;
  const int* topo;             // (4, J): parents, ancestor, descendant,
                               // child masks
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
  // the aux at the decoded latent
  float *a_lp, *a_lr, *a_wd, *a_disp, *a_wr, *a_pos, *a_pose;
  // the timed build's clock cycles by phase, 8 a warp (else unused)
  long long* clocks;
  // sizes and hyperparameters
  int B, J, L, H1, H2, H3, sync_k, max_iter;
  float eps_pos, eps_rot, min_incr, lr_adam, lambda_rot, lambda_t;
};

// Shared-memory layout (in floats), computed on the host.
struct Layout {
  int ks1, nt1, nt2, nt3;      // tiles: latent, H1, H2, H3
  int o_p2, o_p3;              // packed W2, W3 (W1 at 0)
  int o_b1, o_b2, o_b3, o_sq, o_mq, o_off, o_sdm, o_topo;
  int o_team;                  // the first team's scratch
  int ldz, ld1, ld2, ldh;      // row strides: latent, H1, H2, H3 buffers
  int team_floats;             // floats of one team's scratch
  int teams;                   // teams (tiles) per block
};

// ---- quaternions (as in fast_iter) ----

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

// Joint j's unit quaternion u = x / |x|, x = h·sq + mq, from the decoder
// output row h (component c at c·J + j); returns |x|.  Rounded as the twin
// rounds it (fast_iter.loss_from_decoded: a product, then a sum; squares
// summed in order; no fused multiply-add): the normalized pose divides by
// stds as small as ~6e-4, which turns one ulp of x into ~1e-4.
__device__ __forceinline__ float unit_quat(const float* h, const float* sq,
                                           const float* mq, int J, int j,
                                           float* u) {
  float x[4];
  for (int c = 0; c < 4; ++c)
    x[c] = __fadd_rn(__fmul_rn(h[c * J + j], sq[c * J + j]), mq[c * J + j]);
  const float ss = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]),
                                                 __fmul_rn(x[1], x[1])),
                                       __fmul_rn(x[2], x[2])),
                             __fmul_rn(x[3], x[3]));
  const float nrm = sqrtf(ss);
  for (int c = 0; c < 4; ++c) u[c] = x[c] / nrm;
  return nrm;
}

// ---- 3xTF32 on mma.sync.m16n8k8 ----

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32 for finite x, in two integer operations.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d = a·b, from a zero accumulator.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)), "f"(0.f),
        "f"(0.f), "f"(0.f), "f"(0.f));
}

// acc[n] += a·b[n] for the n < nt tiles of one k-step, in PASSES passes:
// lo·hi + hi·lo + hi·hi (3) or hi·hi (1); b[n] = {hi, lo of its first
// column; hi, lo of its second}.  The tensor cores' accumulation
// truncates, and a running sum as C would truncate every pass against
// it: so each k-step's passes start from zero and their sum is added in
// float32, rounded to nearest.  Each pass is issued for every tile before
// the next pass, so the tiles' chains overlap.
template <int PASSES, int NM>
__device__ __forceinline__ void kstep_mma(float (&acc)[NM][4], int nt,
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b)[NM][4]) {
  float s[NM][4];
#pragma unroll
  for (int n = 0; n < NM; ++n)
    if (n < nt) mma0(s[n], PASSES == 3 ? al : ah, b[n][0], b[n][2]);
  if (PASSES == 3) {
#pragma unroll
    for (int n = 0; n < NM; ++n)
      if (n < nt) mma(s[n], ah, b[n][1], b[n][3]);
#pragma unroll
    for (int n = 0; n < NM; ++n)
      if (n < nt) mma(s[n], ah, b[n][0], b[n][2]);
  }
#pragma unroll
  for (int n = 0; n < NM; ++n)
    if (n < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += s[n][e];
}

// An accumulator fragment (rows g, g+8; columns 2t, 2t+1 of its tile) as
// the A fragment of the next product (columns t, t+4 = features 2t, 2t+1),
// split.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// Position of fragment lane f in a packed block (conflict-free for both
// the forward float4 and the transposed float2 reads).
__device__ __forceinline__ int swz(int f) { return f ^ ((f >> 3) << 1); }

// Forward B operand {hi, lo of W[8n + g][8k + 2t]; hi, lo of 2t + 1} of a
// weight packed with `ks` k-steps.
__device__ __forceinline__ void load_b(const float* P, int ks, int k, int n,
                                       float (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const float4 w = *reinterpret_cast<const float4*>(P + (n * ks + k) * FRAG +
                                                    swz(lane) * 4);
  b[0] = w.x; b[1] = w.y; b[2] = w.z; b[3] = w.w;
}

// Transposed B operand: W[8k + 2t][8n + g] (hi, lo) and W[8k + 2t + 1][8n +
// g] of the same packed weight (k over its rows, n over its columns).
__device__ __forceinline__ void load_bt(const float* P, int ks, int k, int n,
                                        float (&b)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* blk = P + (k * ks + n) * FRAG + (g & 1) * 2;
  const float2 v0 = *reinterpret_cast<const float2*>(
      blk + ((8 * t + (g >> 1)) ^ (2 * t)) * 4);
  const float2 v1 = *reinterpret_cast<const float2*>(
      blk + ((8 * t + 4 + (g >> 1)) ^ (2 * t)) * 4);
  b[0] = v0.x; b[1] = v0.y; b[2] = v1.x; b[3] = v1.y;
}

// A team of TEAM warps owns one tile of 16 lanes; each product is split
// by output tile, tile n to warp n % TEAM, its A operand read from shared
// memory (rows g and g + 8 of the tile, columns 8k + 2t and 8k + 2t + 1 of
// k-step k: the accumulator layout, so a product's output tiles are
// stored as they come and read back as A fragments).
constexpr int TEAM = 4;
constexpr int TEAM_THREADS = TEAM * 32;
constexpr int NG3 = 3;                          // H3 tiles a pass

// A build's limits: joints, latent dims and hidden widths H1, H2 (multiples
// of 8 and of 32 joints), tiles a block, the blocks an SM must hold (which
// sets the register budget), and whether the weights sit in shared memory.
template <int MAXJ_, int MAXL_, int MAXH_, int TEAMS_, int MIN_BLOCKS_,
          bool SMEM_W_>
struct Build {
  static constexpr int MAXJ = MAXJ_, MAXL = MAXL_, MAXH = MAXH_;
  static constexpr int TEAMS = TEAMS_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool SMEM_W = SMEM_W_;
  static constexpr int MW = (MAXJ + 31) / 32;           // mask words a joint
  static constexpr int KS1W = (MAXL / 8 + TEAM - 1) / TEAM;  // a warp's
                                                             // latent tiles
  static constexpr int NT1W = (MAXH / 8 + TEAM - 1) / TEAM;  // H1 tiles
  static constexpr int NT2W = (MAXH / 8 + TEAM - 1) / TEAM;  // H2 tiles
  // Past the narrow limits: weights packed whole (pack_weights, split in
  // registers) and every product in passes of PASS output tiles: 1 from
  // shared memory and 3 from device memory where 4 or 2 blocks share an SM
  // (fewer registers, fewer spills), a warp's every H1 or H2 tile where
  // one block has the SM (4 warps: more independent mma chains a warp).
  // At 2 blocks an SM the weights of the next RING / PASS k-steps are
  // loaded ahead; else (RING < 0) each k-step's where it is used.  Each
  // choice is the fastest of those timed on the card (PERF.md §6).
  static constexpr bool GENERAL = MAXJ > 32;
  static constexpr int WBLK = GENERAL ? 64 : FRAG;      // floats a block
  static constexpr int PASS = SMEM_W ? 1 : (MIN_BLOCKS >= 2 ? NG3 : NT1W);
  static constexpr int RING = MIN_BLOCKS == 2 && !SMEM_W ? 6 : -1;
};
using Narrow = Build<32, 32, 64, 4, 1, true>;
// the general build's layouts: weights resident in shared memory, up to 4
// teams a block (128 registers a thread); streamed from device memory, a
// team a block, for 4 blocks an SM (128 registers), 2 or 1 (255)
using Resident = Build<128, 128, 272, 4, 1, true>;
using Streamed4 = Build<128, 128, 272, 1, 4, false>;
using Streamed2 = Build<128, 128, 272, 1, 2, false>;
using Streamed1 = Build<128, 128, 272, 1, 1, false>;

// The LeakyReLU gates of a warp's NM output tiles, a bit each.
template <int NM>
using Gates = typename std::conditional<(4 * NM <= 32), uint32_t,
                                        unsigned long long>::type;

__device__ __forceinline__ void team_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(TEAM_THREADS) : "memory");
}

// Tiles w, w + TEAM, ... below nt: how many.
__device__ __forceinline__ int owned(int nt, int w) {
  return w < nt ? (nt - w + TEAM - 1) / TEAM : 0;
}

// y[i] = (A · B) for this warp's output tiles first + TEAM·i (i < cnt),
// A of `ks` k-steps from rows r0 (lane g) and r1 (lane g + 8), B the
// packed weight P (forward: Y = A·Wᵀ, `pks` = ks; transposed: Y = A·W,
// `pks` = the forward's k-steps of W).
template <int PASSES, bool TRANSPOSED, int NM>
__device__ __forceinline__ void team_product(const float* r0, const float* r1,
                                             int ks, const float* P, int pks,
                                             int first, int cnt,
                                             float (&y)[NM][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[i][e] = 0.f;
  if (cnt <= 0) return;
  for (int k = 0; k < ks; ++k) {
    const float2 a0 = *reinterpret_cast<const float2*>(r0 + 8 * k + 2 * t);
    const float2 a1 = *reinterpret_cast<const float2*>(r1 + 8 * k + 2 * t);
    const float c[4] = {a0.x, a0.y, a1.x, a1.y};
    uint32_t ah[4], al[4];
    c_to_a(c, ah, al);
    float b[NM][4];
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      if (i >= cnt) break;
      if (TRANSPOSED)
        load_bt(P, pks, k, first + TEAM * i, b[i]);
      else
        load_b(P, pks, k, first + TEAM * i, b[i]);
    }
    kstep_mma<PASSES>(y, cnt, ah, al, b);
  }
}

// Store tiles first + TEAM·i (i < cnt) to Y (row stride ldy), with the
// bias added if given and, with `act`, LeakyReLU; returns the gates
// (pre-activation ≥ 0) as bits 4i + e.
template <int NM>
__device__ __forceinline__ Gates<NM> store_tiles(float (&y)[NM][4], int cnt,
                                                 int first, const float* bias,
                                                 bool act, float* Y, int ldy) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Gates<NM> gates = 0;
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i >= cnt) break;
    const int col = 8 * (first + TEAM * i) + 2 * t;
    if (bias) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
      y[i][0] += bb.x; y[i][1] += bb.y; y[i][2] += bb.x; y[i][3] += bb.y;
    }
    if (act) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (y[i][e] >= 0.f) gates |= Gates<NM>(1) << (4 * i + e);
        y[i][e] = leaky(y[i][e]);
      }
    }
    *reinterpret_cast<float2*>(Y + g * ldy + col) = make_float2(y[i][0], y[i][1]);
    *reinterpret_cast<float2*>(Y + (g + 8) * ldy + col) =
        make_float2(y[i][2], y[i][3]);
  }
  return gates;
}

// The backward's LeakyReLU: gradients through the forward's gates.
template <int NM>
__device__ __forceinline__ void apply_gates(float (&y)[NM][4], int cnt,
                                            Gates<NM> gates) {
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i >= cnt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!((gates >> (4 * i + e)) & 1u)) y[i][e] *= SLOPE;
  }
}

// ---- the general builds' products: whole weights, in passes ----

// Position of pair p in a whole-weight block of 8 × 8 floats (pair 4g + t
// = row g, columns 2t, 2t + 1): conflict-free for the forward float2 read
// and for the transposed reads (rows 2t, 2t + 1 of column g).
__device__ __forceinline__ int swz_pair(int p) { return p ^ ((p >> 4) << 2); }

template <bool SMEM>
__device__ __forceinline__ float ld_w(const float* a) {
  if constexpr (SMEM) return *a; else return __ldg(a);
}

// This lane's two weights of block (n, k) of a weight packed whole with
// `ks` column blocks: forward {W[8n + g][8k + 2t], W[8n + g][8k + 2t + 1]};
// transposed {W[8k + 2t][8n + g], W[8k + 2t + 1][8n + g]} (block (k, n)).
template <bool TRANSPOSED, bool SMEM>
__device__ __forceinline__ float2 load_w(const float* P, int ks, int k,
                                         int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (!TRANSPOSED) {
    const float* q = P + (n * ks + k) * 64 + 2 * swz_pair(lane);
    if constexpr (SMEM) return *reinterpret_cast<const float2*>(q);
    else return __ldg(reinterpret_cast<const float2*>(q));
  } else {
    const float* blk = P + (k * ks + n) * 64 + (g & 1);
    return make_float2(ld_w<SMEM>(blk + 2 * swz_pair(8 * t + (g >> 1))),
                       ld_w<SMEM>(blk + 2 * swz_pair(8 * t + 4 + (g >> 1))));
  }
}

// team_product on whole weights: each k-step's B operands split here into
// the hi and lo pack_fragments stores.  With RING ≥ 0 the weights of the
// next D = max(1, RING / NM) k-steps are loaded while this one's products
// run (D · NM float2 in registers); with RING < 0 each k-step loads its
// own.  Bit for bit team_product's sums.
template <int PASSES, bool TRANSPOSED, bool SMEM, int RING, int NM>
__device__ __forceinline__ void team_product_w(const float* r0,
                                               const float* r1, int ks,
                                               const float* P, int pks,
                                               int first, int cnt,
                                               float (&y)[NM][4]) {
  constexpr int D = RING / NM > 1 ? RING / NM : 1;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[i][e] = 0.f;
  if (cnt <= 0) return;
  float2 w[D][NM];
  if constexpr (RING >= 0) {
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int i = 0; i < NM; ++i)
        if (d < ks && i < cnt)
          w[d][i] = load_w<TRANSPOSED, SMEM>(P, pks, d, first + TEAM * i);
  }
  for (int k0 = 0; k0 < ks; k0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = k0 + d;
      if (k >= ks) break;
      const float2 a0 = *reinterpret_cast<const float2*>(r0 + 8 * k + 2 * t);
      const float2 a1 = *reinterpret_cast<const float2*>(r1 + 8 * k + 2 * t);
      const float c[4] = {a0.x, a0.y, a1.x, a1.y};
      uint32_t ah[4], al[4];
      c_to_a(c, ah, al);
      float b[NM][4];
      if constexpr (RING < 0) {
#pragma unroll
        for (int i = 0; i < NM; ++i)
          if (i < cnt)
            w[d][i] = load_w<TRANSPOSED, SMEM>(P, pks, k, first + TEAM * i);
      }
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        if (i >= cnt) break;
        uint32_t h0, l0, h1, l1;
        split(w[d][i].x, h0, l0);
        split(w[d][i].y, h1, l1);
        b[i][0] = __uint_as_float(h0); b[i][1] = __uint_as_float(l0);
        b[i][2] = __uint_as_float(h1); b[i][3] = __uint_as_float(l1);
      }
      if (RING >= 0 && k + D < ks) {
#pragma unroll
        for (int i = 0; i < NM; ++i)
          if (i < cnt)
            w[d][i] = load_w<TRANSPOSED, SMEM>(P, pks, k + D,
                                               first + TEAM * i);
      }
      kstep_mma<PASSES>(y, cnt, ah, al, b);
    }
  }
}

// Y = A·Wᵀ + bias (LeakyReLU with ACT) for this warp's `cnt` output
// tiles first + TEAM·i, NP tiles a pass; returns their gates (bits 4i + e,
// i < NT; 0 without ACT).
template <int PASSES, bool SMEM, int RING, int NP, bool ACT, int NT>
__device__ __forceinline__ Gates<NT> forward_w(const float* r0,
                                               const float* r1, int ks,
                                               const float* P, int first,
                                               int cnt, const float* bias,
                                               float* Y, int ldy) {
  Gates<NT> gates = 0;
  for (int i0 = 0; i0 < cnt; i0 += NP) {
    const int c = cnt - i0 < NP ? cnt - i0 : NP;
    float h[NP][4];
    team_product_w<PASSES, false, SMEM, RING>(r0, r1, ks, P, ks,
                                              first + TEAM * i0, c, h);
    const auto pass = store_tiles(h, c, first + TEAM * i0, bias, ACT, Y, ldy);
    if constexpr (ACT) gates |= static_cast<Gates<NT>>(pass) << (4 * i0);
  }
  return gates;
}

// Y = (A·W) through the forward's gates, NP tiles a pass (W packed with
// `pks` column blocks; A of `ks` k-steps).
template <int PASSES, bool SMEM, int RING, int NP, int NT>
__device__ __forceinline__ void backward_w(const float* r0, const float* r1,
                                           int ks, const float* P, int pks,
                                           int first, int cnt,
                                           Gates<NT> gates, float* Y,
                                           int ldy) {
  for (int i0 = 0; i0 < cnt; i0 += NP) {
    const int c = cnt - i0 < NP ? cnt - i0 : NP;
    float gq[NP][4];
    team_product_w<PASSES, true, SMEM, RING>(r0, r1, ks, P, pks,
                                             first + TEAM * i0, c, gq);
    apply_gates(gq, c, static_cast<Gates<NP>>(gates >> (4 * i0)));
    store_tiles(gq, c, first + TEAM * i0, nullptr, false, Y, ldy);
  }
}

// The phases a timed build reads the clock after (slot CLOCK_SLOTS - 1
// counts the steps): the decoder forward; the per-joint passes (world
// quats, FK terms, positions and loss, the per-lane reductions); the aux;
// the per-joint backward (descendant sums, then quats and root); the
// decoder backward; Adam.
enum { PH_DEC_FWD, PH_QUATS, PH_FK, PH_LOSS, PH_REDUCE, PH_AUX, PH_SUBTREE,
       PH_QUAT_GRAD, PH_DEC_BWD, PH_ADAM, N_PHASES };
constexpr int CLOCK_SLOTS = 16;

// acc[c] += buf[(c * J + a) * TILE + pl] (c < NC) over the set bits a of
// joint j's mask m (nw words a joint, word wd at m[wd * J + j]), ascending:
// four bits an iteration, their reads issued together, their sums in
// order (a bit past the last is read but not summed).
template <int NC>
__device__ __forceinline__ void mask_sum(const unsigned* m, int J, int nw,
                                         int j, const float* buf, int pl,
                                         float (&acc)[NC]) {
  for (int wd = 0; wd < nw; ++wd) {
    unsigned msk = m[wd * J + j];
    while (msk) {
      int a[4] = {32 * wd + __ffs(msk) - 1};
      bool ok[4] = {true};
      msk &= msk - 1;
#pragma unroll
      for (int u = 1; u < 4; ++u) {
        ok[u] = msk != 0;
        a[u] = ok[u] ? 32 * wd + __ffs(msk) - 1 : a[0];
        msk &= msk - 1;
      }
      float x[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) x[u][c] = buf[(c * J + a[u]) * TILE + pl];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ok[u])
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[c] += x[u][c];
    }
  }
}

// acc[c] += AT(buf, c, a) (c < NC) over the set bits a of joint j's mask
// m, ascending.  With one word a joint it is the loop of the build before
// the general one, written out, so that the narrow build compiles as that
// build did; past that, mask_sum.
#define MASK_SUM(m, j, buf, acc, NC)                                    \
  if constexpr (BD::MW == 1) {                                          \
    for (unsigned msk = (m)[j]; msk; msk &= msk - 1) {                  \
      const int a = __ffs(msk) - 1;                                     \
      for (int c = 0; c < NC; ++c) acc[c] += AT(buf, c, a);             \
    }                                                                   \
  } else {                                                              \
    mask_sum(m, J, nw, j, buf, pl, acc);                                \
  }

template <class BD, int PASSES, bool TIMED>
__global__ void __launch_bounds__(BD::TEAMS * TEAM_THREADS, BD::MIN_BLOCKS)
iter_block_kernel(const Params p, const Layout y) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int J = p.J, L = p.L;
  const int nw = BD::MW == 1 ? 1 : (J + 31) >> 5;   // mask words a joint

  // ---- constants, once per block ----
  {
    const float4* src = reinterpret_cast<const float4*>(p.frags);
    if (BD::SMEM_W)
      for (int i = threadIdx.x; i < y.o_b1 / 4; i += blockDim.x)
        smem4[i] = __ldg(src + i);
    float* b1s = sm + y.o_b1;
    for (int i = threadIdx.x; i < 8 * y.nt1; i += blockDim.x)
      b1s[i] = i < p.H1 ? p.b1[i] : 0.f;
    float* b2s = sm + y.o_b2;
    for (int i = threadIdx.x; i < 8 * y.nt2; i += blockDim.x)
      b2s[i] = i < p.H2 ? p.b2[i] : 0.f;
    float* b3s = sm + y.o_b3;
    for (int i = threadIdx.x; i < 8 * y.nt3; i += blockDim.x)
      b3s[i] = i < p.H3 ? p.b3[i] : 0.f;
    for (int i = threadIdx.x; i < 4 * J; i += blockDim.x) {
      sm[y.o_sq + i] = p.sq[i];
      sm[y.o_mq + i] = p.mq[i];
    }
    for (int i = threadIdx.x; i < 3 * J; i += blockDim.x)
      sm[y.o_off + i] = p.offs[i];
    if (threadIdx.x < 3) {
      sm[y.o_sdm + threadIdx.x] = p.sd[threadIdx.x];
      sm[y.o_sdm + 3 + threadIdx.x] = p.md[threadIdx.x];
    }
    int* topo = reinterpret_cast<int*>(sm + y.o_topo);
    for (int i = threadIdx.x; i < (1 + 3 * nw) * J; i += blockDim.x)
      topo[i] = p.topo[i];
  }
  __syncthreads();

  // the packed weights: in shared memory, or read from device memory
  const float* P1 = BD::SMEM_W ? sm : p.frags;
  const float* P2 = P1 + y.o_p2;
  const float* P3 = P1 + y.o_p3;
  const float* sb1 = sm + y.o_b1;
  const float* sb2 = sm + y.o_b2;
  const float* sb3 = sm + y.o_b3;
  const float* ssq = sm + y.o_sq;
  const float* smq = sm + y.o_mq;
  const float* soff = sm + y.o_off;
  const float sd[3] = {sm[y.o_sdm], sm[y.o_sdm + 1], sm[y.o_sdm + 2]};
  const float md[3] = {sm[y.o_sdm + 3], sm[y.o_sdm + 4], sm[y.o_sdm + 5]};
  const int* spar = reinterpret_cast<const int*>(sm + y.o_topo);
  const unsigned* sanc = reinterpret_cast<const unsigned*>(spar + J);
  const unsigned* sdesc = sanc + nw * J;
  const unsigned* schild = sdesc + nw * J;

  const int team = threadIdx.x / TEAM_THREADS;
  const int tt = threadIdx.x % TEAM_THREADS;     // thread of the team
  const int w = tt >> 5, lane = tt & 31;
  const int base = (blockIdx.x * y.teams + team) * TILE;
  if (base >= p.B) return;   // the whole team
  const int bar = 1 + team;  // the team's named barrier
  const int B = p.B;
  const int ks1 = y.ks1, nt1 = y.nt1, nt2 = y.nt2, nt3 = y.nt3;
  const int ldz = y.ldz, ld1 = y.ld1, ld2 = y.ld2, ldh = y.ldh;
  // the latent, decoded latent, Adam's moments and the target latent, a
  // row a lane (16 x ldz each): state that lives through the launch is
  // kept here rather than in registers, which 512 threads a block cap at
  // 128 a thread
  float* ZS = sm + y.o_team + team * y.team_floats;
  float* DS = ZS + TILE * ldz;
  float* MS = DS + TILE * ldz;
  float* VS = MS + TILE * ldz;
  float* TLS = VS + TILE * ldz;
  float* HG = TLS + TILE * ldz;                      // H3, then G3
  float* RED = HG + TILE * ldh;      // per-warp partial sums (TEAM, 6, 16)
  float* U = RED + TEAM * 6 * TILE;  // the union below
  // per-joint buffers (c, j, lane): unit quats and their norms, FK terms
  // (then the grads sent to the parents), position grads, the loss's grads
  // to the world quats
  float* UQ = U;
  float* CT = UQ + 5 * J * TILE;
  float* GP = CT + 4 * J * TILE;
  float* GW = GP + 3 * J * TILE;
  // the decoder's activations and gradients, over the same floats
  float* H1S = U;
  float* H2S = U + TILE * ld1;
  float* G2S = U;
  float* G1S = U + TILE * ld2;
#define AT(buf, c, j) (buf)[((c) * J + (j)) * TILE + pl]

  // ---- the pair layout: lane pl of the tile, joints jg, jg + 8, ... ----
  const int pl = tt & 15, jg = tt >> 4;
  const int b = base + pl;
  const bool in_range = b < B;
  const int bc = in_range ? b : B - 1;
  const float gr[4] = {p.gr[bc * 4 + 0], p.gr[bc * 4 + 1], p.gr[bc * 4 + 2],
                       p.gr[bc * 4 + 3]};
  const float n_ee = p.n_ee[bc * p.n_ee_stride];
  const bool act = in_range && p.lane_act[bc] != 0;
  int it = p.t0[bc];
  float prev = p.pl0[bc], lp = p.lp0[bc], lr = p.lr0[bc], li = p.li0[bc];
  const float pos_scale = n_ee * 3.f;
  const float rot_scale = n_ee * 9.f;
  // the loss gradient's factors (the losses themselves divide)
  const float kp_lane = 2.f / pos_scale;
  const float kr_lane = p.lambda_rot * 2.f / rot_scale;

  // ---- the accumulator layout: rows g and g + 8; warp w < ks1 owns the
  // latent tiles lt = w, w + TEAM, ... below ks1 (columns 8lt + 2t + e) and
  // their Adam state ----
  const int g = lane >> 2, t = lane & 3;
  const bool owner = w < ks1;
  if (owner) {
#pragma unroll
    for (int i = 0; i < BD::KS1W; ++i) {
      const int lt = w + TEAM * i;
      if (lt >= ks1) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = 8 * lt + 2 * t + (e & 1);
        const int rl = base + row < B ? base + row : B - 1;
        const bool ok = col < L;
        const int at = rl * L + col, sat = row * ldz + col;
        ZS[sat] = ok ? p.z0[at] : 0.f;
        DS[sat] = ok ? p.d0[at] : 0.f;
        MS[sat] = ok ? p.m0[at] : 0.f;
        VS[sat] = ok ? p.v0[at] : 0.f;
        TLS[sat] = ok ? p.tlat[at] : 0.f;
      }
    }
  }
  team_sync(bar);

  long long cyc[N_PHASES] = {}, mark = TIMED ? clock64() : 0;
#define PHASE(i)                            \
  if (TIMED) {                              \
    const long long now = clock64();        \
    cyc[i] += now - mark;                   \
    mark = now;                             \
  }
  int steps = 0;
  for (int step = 0;; ++step) {
    const bool active = act && step < p.sync_k &&
                        ((lp > p.eps_pos) || (lr > p.eps_rot)) &&
                        (it < p.max_iter) && (li > p.min_incr);
    // every warp holds every lane's state: the same answer in the team
    const bool any_active = __any_sync(FULL, active);
    if (step > 0 && !any_active) break;
    ++steps;
    const bool row_act[2] = {__shfl_sync(FULL, active, g) != 0,
                             __shfl_sync(FULL, active, g + 8) != 0};

    // ---------------- forward decoder ----------------
    // stepping lanes at their latent, the others at their decoded latent
    // (a lane's first forward in the launch is its aux if it takes no step)
    const float* r0 = (row_act[0] ? ZS : DS) + g * ldz;
    const float* r1 = (row_act[1] ? ZS : DS) + (g + 8) * ldz;
    float lt_row[2] = {0.f, 0.f};
    if (owner) {
#pragma unroll
      for (int i = 0; i < BD::KS1W; ++i) {
        const int lt = w + TEAM * i;
        if (lt >= ks1) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * lt + 2 * t + (e & 1);
          if (col < L) {
            const float dz = (e >> 1 ? r1 : r0)[col] -
                             TLS[(g + 8 * (e >> 1)) * ldz + col];
            lt_row[e >> 1] += dz * dz;
          }
        }
      }
    }
    Gates<BD::NT1W> gate1;
    Gates<BD::NT2W> gate2;
    if constexpr (BD::GENERAL) {
      constexpr bool SW = BD::SMEM_W;
      constexpr int RG = BD::RING, NP = BD::PASS;
      gate1 = forward_w<PASSES, SW, RG, NP, true, BD::NT1W>(
          r0, r1, ks1, P1, w, owned(nt1, w), sb1, H1S, ld1);
      team_sync(bar);
      gate2 = forward_w<PASSES, SW, RG, NP, true, BD::NT2W>(
          H1S + g * ld1, H1S + (g + 8) * ld1, nt1, P2, w, owned(nt2, w), sb2,
          H2S, ld2);
      team_sync(bar);
      forward_w<PASSES, SW, RG, NP, false, 1>(
          H2S + g * ld2, H2S + (g + 8) * ld2, nt2, P3, w, owned(nt3, w), sb3,
          HG, ldh);
      team_sync(bar);
    } else {
      {
        const int cnt = owned(nt1, w);
        float h[BD::NT1W][4];
        team_product<PASSES, false>(r0, r1, ks1, P1, ks1, w, cnt, h);
        gate1 = store_tiles(h, cnt, w, sb1, true, H1S, ld1);
      }
      team_sync(bar);
      {
        const int cnt = owned(nt2, w);
        float h[BD::NT2W][4];
        team_product<PASSES, false>(H1S + g * ld1, H1S + (g + 8) * ld1, nt1,
                                    P2, nt1, w, cnt, h);
        gate2 = store_tiles(h, cnt, w, sb2, true, H2S, ld2);
      }
      team_sync(bar);
      for (int i0 = 0, cnt3 = owned(nt3, w); i0 < cnt3; i0 += NG3) {
        const int cnt = cnt3 - i0 < NG3 ? cnt3 - i0 : NG3;
        float h[NG3][4];
        team_product<PASSES, false>(H2S + g * ld2, H2S + (g + 8) * ld2, nt2,
                                    P3, nt2, w + TEAM * i0, cnt, h);
        store_tiles(h, cnt, w + TEAM * i0, sb3, false, HG, ldh);
      }
      team_sync(bar);
    }
    PHASE(PH_DEC_FWD)

    // ---------------- per-joint forward ----------------
    const float* hrow = HG + pl * ldh;
    float u0[4];
    const float nrm0 = unit_quat(hrow, ssq, smq, J, 0, u0);
    float W[4];
    qmul(gr, u0, W);
    float disp[3];
    for (int c = 0; c < 3; ++c)
      disp[c] = __fadd_rn(__fmul_rn(hrow[4 * J + c], sd[c]), md[c]);
    float wd[3];
    qrot(W, disp, wd);
    // a joint's world quat, W for the root, W ⊗ u_j for the others
    auto world = [&](int j, float* wq) {
      if (j == 0) {
        for (int c = 0; c < 4; ++c) wq[c] = W[c];
      } else {
        const float u[4] = {AT(UQ, 0, j), AT(UQ, 1, j), AT(UQ, 2, j),
                            AT(UQ, 3, j)};
        qmul(W, u, wq);
      }
    };
    for (int j = jg; j < J; j += 2 * TEAM) {
      float u[4] = {u0[0], u0[1], u0[2], u0[3]};
      float nrm = nrm0;
      if (j > 0) nrm = unit_quat(hrow, ssq, smq, J, j, u);
      for (int c = 0; c < 4; ++c) AT(UQ, c, j) = u[c];
      AT(UQ, 4, j) = nrm;
    }
    team_sync(bar);
    PHASE(PH_QUATS)
    for (int j = jg > 0 ? jg : 2 * TEAM; j < J; j += 2 * TEAM) {
      float pw[4];
      world(spar[j], pw);
      const float off[3] = {soff[j * 3], soff[j * 3 + 1], soff[j * 3 + 2]};
      float ct[3];
      qrot(pw, off, ct);
      for (int c = 0; c < 3; ++c) AT(CT, c, j) = ct[c];
    }
    team_sync(bar);
    PHASE(PH_FK)

    // positions, the loss, and its gradient to positions (shared) and to
    // the joint's own world quat (kept for the backward)
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // lp, lr, gwd, lt
    for (int j = jg; j < J; j += 2 * TEAM) {
      float tp[3], tr[9];
      for (int c = 0; c < 3; ++c) tp[c] = __ldg(p.tpos + (j * 3 + c) * B + bc);
      for (int q = 0; q < 9; ++q) tr[q] = __ldg(p.trot + (j * 9 + q) * B + bc);
      const float wp = __ldg(p.w_pos + j * p.w_row_stride + bc * p.w_lane_stride);
      const float wr = __ldg(p.w_rot + j * p.w_row_stride + bc * p.w_lane_stride);
      float acc[3] = {0.f, 0.f, 0.f};
      MASK_SUM(sanc, j, CT, acc, 3)
      float dpos[3];
      for (int c = 0; c < 3; ++c) dpos[c] = acc[c] + wd[c] - tp[c];
      part[0] += wp * (dpos[0] * dpos[0] + dpos[1] * dpos[1] +
                       dpos[2] * dpos[2]);
      float wq[4];
      world(j, wq);
      float rm[9], drot[9], ssum = 0.f;
      to_matrix(wq, rm);
      for (int q = 0; q < 9; ++q) {
        drot[q] = rm[q] - tr[q];
        ssum += drot[q] * drot[q];
      }
      part[1] += wr * ssum;
      const float kp = wp * kp_lane;
      for (int c = 0; c < 3; ++c) {
        const float gp = kp * dpos[c];
        AT(GP, c, j) = gp;
        part[2 + c] += gp;
      }
      const float kr = wr * kr_lane;
      float gm[9], gw[4];
      for (int q = 0; q < 9; ++q) gm[q] = kr * drot[q];
      to_matrix_grad(wq, gm, gw);
      for (int c = 0; c < 4; ++c) AT(GW, c, j) = gw[c];
    }
    PHASE(PH_LOSS)
    // per-lane sums over the team: two joint groups a warp, then the warps
    for (int q = 0; q < 5; ++q) part[q] += __shfl_xor_sync(FULL, part[q], 16);
    if (lane < 16)
      for (int q = 0; q < 5; ++q) RED[(w * 6 + q) * TILE + pl] = part[q];
    // the temporal term from the latent tiles' owners (rows summed over t)
    for (int r = 0; r < 2; ++r) {
      lt_row[r] += __shfl_xor_sync(FULL, lt_row[r], 1);
      lt_row[r] += __shfl_xor_sync(FULL, lt_row[r], 2);
    }
    if (t == 0) {
      RED[(w * 6 + 5) * TILE + g] = lt_row[0];
      RED[(w * 6 + 5) * TILE + g + 8] = lt_row[1];
    }
    team_sync(bar);
    float sums[6];
    for (int q = 0; q < 6; ++q) {
      sums[q] = RED[q * TILE + pl];
      for (int v = 1; v < TEAM; ++v) sums[q] += RED[(v * 6 + q) * TILE + pl];
    }
    const float gwd[3] = {sums[2], sums[3], sums[4]};
    const float lp_n = sums[0] / pos_scale;
    const float lr_n = sums[1] / rot_scale * p.lambda_rot;
    const float total = lp_n + lr_n + sums[5] / L * p.lambda_t;
    PHASE(PH_REDUCE)

    // this forward is the lane's last of the launch: write its aux
    const bool next = active && step + 1 < p.sync_k &&
                      ((lp_n > p.eps_pos) || (lr_n > p.eps_rot)) &&
                      (it + 1 < p.max_iter) && ((prev - total) > p.min_incr);
    const bool write_aux = in_range && (active ? !next : step == 0);
    if (write_aux) {
      for (int j = jg; j < J; j += 2 * TEAM) {
        float acc[3] = {0.f, 0.f, 0.f};
        MASK_SUM(sanc, j, CT, acc, 3)
        for (int c = 0; c < 3; ++c)
          p.a_pos[(static_cast<size_t>(b) * J + j) * 3 + c] = acc[c] + wd[c];
        for (int c = 0; c < 4; ++c)
          p.a_pose[static_cast<size_t>(b) * 4 * J + 4 * j + c] =
              __fsub_rn(AT(UQ, c, j), smq[c * J + j]) / ssq[c * J + j];
      }
      if (jg == 0) {
        p.a_lp[b] = lp_n;
        p.a_lr[b] = lr_n;
        for (int c = 0; c < 3; ++c) {
          p.a_wd[b * 3 + c] = wd[c];
          p.a_disp[b * 3 + c] = disp[c];
        }
        for (int c = 0; c < 4; ++c) p.a_wr[b * 4 + c] = W[c];
      }
    }
    PHASE(PH_AUX)
    if (!any_active) continue;   // only a first step can get here

    if (active) {
      it += 1;
      li = prev - total;
      prev = total;
      lp = lp_n;
      lr = lr_n;
    }

    // ---------------- per-joint backward ----------------
    team_sync(bar);   // every read of the FK terms is done
    // subtree sums of the position grads, sent to the parents' world quats
    for (int j = jg > 0 ? jg : 2 * TEAM; j < J; j += 2 * TEAM) {
      float sub[3] = {0.f, 0.f, 0.f};
      MASK_SUM(sdesc, j, GP, sub, 3)
      float pw[4];
      world(spar[j], pw);
      const float off[3] = {soff[j * 3], soff[j * 3 + 1], soff[j * 3 + 2]};
      float gpw[4];
      qrot_grad(pw, off, sub, gpw, nullptr);
      for (int c = 0; c < 4; ++c) AT(CT, c, j) = gpw[c];
    }
    team_sync(bar);
    PHASE(PH_SUBTREE)
    // each joint's world-quat grad; through x/|x| to the decoder output
    float gWp[4] = {0.f, 0.f, 0.f, 0.f};
    float cW[4];
    qconj(W, cW);
    for (int j = jg; j < J; j += 2 * TEAM) {
      float gw[4] = {AT(GW, 0, j), AT(GW, 1, j), AT(GW, 2, j), AT(GW, 3, j)};
      MASK_SUM(schild, j, CT, gw, 4)
      if (j == 0) {
        for (int c = 0; c < 4; ++c) gWp[c] += gw[c];
        continue;
      }
      const float u[4] = {AT(UQ, 0, j), AT(UQ, 1, j), AT(UQ, 2, j),
                          AT(UQ, 3, j)};
      const float inv = 1.f / AT(UQ, 4, j);
      float cu[4], pt[4], gu[4];
      qconj(u, cu);
      qmul(gw, cu, pt);
      for (int c = 0; c < 4; ++c) gWp[c] += pt[c];
      qmul(cW, gw, gu);
      const float ug = u[0] * gu[0] + u[1] * gu[1] + u[2] * gu[2] + u[3] * gu[3];
      for (int c = 0; c < 4; ++c)
        HG[pl * ldh + c * J + j] = (gu[c] - u[c] * ug) * inv * ssq[c * J + j];
    }
    for (int c = 0; c < 4; ++c) gWp[c] += __shfl_xor_sync(FULL, gWp[c], 16);
    if (lane < 16)
      for (int c = 0; c < 4; ++c) RED[(w * 6 + c) * TILE + pl] = gWp[c];
    team_sync(bar);
    float gW[4];
    for (int c = 0; c < 4; ++c) {
      gW[c] = RED[c * TILE + pl];
      for (int v = 1; v < TEAM; ++v) gW[c] += RED[(v * 6 + c) * TILE + pl];
    }
    float gWd[4], gdisp[3];
    qrot_grad(W, disp, gwd, gWd, gdisp);
    for (int c = 0; c < 4; ++c) gW[c] += gWd[c];
    if (jg == 0) {   // the root joint
      float cg[4], gu[4];
      qconj(gr, cg);
      qmul(cg, gW, gu);
      const float ug = u0[0] * gu[0] + u0[1] * gu[1] + u0[2] * gu[2] +
                       u0[3] * gu[3];
      for (int c = 0; c < 4; ++c)
        HG[pl * ldh + c * J] = (gu[c] - u0[c] * ug) / nrm0 * ssq[c * J];
    } else if (jg == 1) {
      for (int c = 0; c < 3; ++c) HG[pl * ldh + 4 * J + c] = gdisp[c] * sd[c];
    }
    team_sync(bar);
    PHASE(PH_QUAT_GRAD)

    // ---------------- backward decoder ----------------
    float gz[BD::KS1W][4];
    if constexpr (BD::GENERAL) {
      constexpr bool SW = BD::SMEM_W;
      constexpr int RG = BD::RING, NP = BD::PASS;
      backward_w<PASSES, SW, RG, NP, BD::NT2W>(
          HG + g * ldh, HG + (g + 8) * ldh, nt3, P3, nt2, w, owned(nt2, w),
          gate2, G2S, ld2);
      team_sync(bar);
      backward_w<PASSES, SW, RG, NP, BD::NT1W>(
          G2S + g * ld2, G2S + (g + 8) * ld2, nt2, P2, nt1, w, owned(nt1, w),
          gate1, G1S, ld1);
      team_sync(bar);
      team_product_w<PASSES, true, SW, RG>(
          G1S + g * ld1, G1S + (g + 8) * ld1, nt1, P1, ks1, w, owned(ks1, w),
          gz);
    } else {
      {
        const int cnt = owned(nt2, w);
        float gq[BD::NT2W][4];
        team_product<PASSES, true>(HG + g * ldh, HG + (g + 8) * ldh, nt3, P3,
                                   nt2, w, cnt, gq);
        apply_gates(gq, cnt, gate2);
        store_tiles(gq, cnt, w, nullptr, false, G2S, ld2);
      }
      team_sync(bar);
      {
        const int cnt = owned(nt1, w);
        float gq[BD::NT1W][4];
        team_product<PASSES, true>(G2S + g * ld2, G2S + (g + 8) * ld2, nt2,
                                   P2, nt1, w, cnt, gq);
        apply_gates(gq, cnt, gate1);
        store_tiles(gq, cnt, w, nullptr, false, G1S, ld1);
      }
      team_sync(bar);
      team_product<PASSES, true>(
          G1S + g * ld1, G1S + (g + 8) * ld1, nt1, P1, ks1, w,
          BD::KS1W == 1 ? (owner ? 1 : 0) : owned(ks1, w), gz);
    }
    PHASE(PH_DEC_BWD)

    // ---------------- Adam, by the latent tiles' owners ----------------
    const int it_row[2] = {__shfl_sync(FULL, it, g), __shfl_sync(FULL, it, g + 8)};
    if (owner) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!row_act[r]) continue;
        const float tf = static_cast<float>(it_row[r]);
        const float bc1 = 1.f - powf(B1, tf);
        const float bc2 = 1.f - powf(B2, tf);
#pragma unroll
        for (int i = 0; i < BD::KS1W; ++i) {
          const int lt = w + TEAM * i;
          if (lt >= ks1) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * r + h;
            const int col = 8 * lt + 2 * t + h;
            if (col >= L) continue;
            const int sat = (g + 8 * r) * ldz + col;
            const float z = ZS[sat];
            const float dz = z - TLS[sat];
            const float gr_ = gz[i][e] + p.lambda_t * (2.f * dz / L);
            const float m = B1 * MS[sat] + C1 * gr_;
            const float v = B2 * VS[sat] + C2 * gr_ * gr_;
            MS[sat] = m;
            VS[sat] = v;
            const float m_hat = m / bc1;
            const float v_hat = v / bc2;
            DS[sat] = z;
            ZS[sat] = z - p.lr_adam * m_hat / (sqrtf(v_hat) + ADAM_EPS);
          }
        }
      }
    }
    team_sync(bar);
    PHASE(PH_ADAM)
  }
#undef PHASE
#undef AT
#undef MASK_SUM

  if (owner) {
#pragma unroll
    for (int i = 0; i < BD::KS1W; ++i) {
      const int lt = w + TEAM * i;
      if (lt >= ks1) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = base + g + 8 * (e >> 1);
        const int col = 8 * lt + 2 * t + (e & 1);
        if (col >= L || row >= B) continue;
        const size_t at = static_cast<size_t>(row) * L + col;
        const int sat = (g + 8 * (e >> 1)) * ldz + col;
        p.z[at] = ZS[sat];
        p.m[at] = MS[sat];
        p.v[at] = VS[sat];
        p.dec[at] = DS[sat];
      }
    }
  }
  if (tt < 16 && in_range) {
    p.t[b] = it;
    p.prev[b] = prev;
    p.lp[b] = lp;
    p.lr[b] = lr;
    p.li[b] = li;
  }
  if (TIMED && lane == 0) {
    long long* out = p.clocks + static_cast<size_t>(base / TILE * TEAM + w) *
                                    CLOCK_SLOTS;
    for (int i = 0; i < N_PHASES; ++i) out[i] = cyc[i];
    out[CLOCK_SLOTS - 1] = steps;
  }
}

int tiles8(int n) { return (n + 7) / 8; }

// The row stride ≥ n with stride ≡ r (mod 32).
int stride(int n, int r) { return n + ((r - n) % 32 + 32) % 32; }

// The layout for these sizes, with as many teams (tiles) a block
// (1..BD::TEAMS) as give every SM one block; 0 teams if one does not fit.
// Without weights in shared memory, its constants start at 0 and o_p2,
// o_p3 are offsets into the packed weights in device memory.
template <class BD>
Layout make_layout(const Params& p, int sms, int smem_limit) {
  Layout y{};
  y.ks1 = tiles8(p.L);
  y.nt1 = tiles8(p.H1);
  y.nt2 = tiles8(p.H2);
  y.nt3 = tiles8(p.H3);
  y.o_p2 = y.nt1 * y.ks1 * BD::WBLK;
  y.o_p3 = y.o_p2 + y.nt2 * y.nt1 * BD::WBLK;
  y.o_b1 = BD::SMEM_W ? y.o_p3 + y.nt3 * y.nt2 * BD::WBLK : 0;
  y.o_b2 = y.o_b1 + 8 * y.nt1;
  y.o_b3 = y.o_b2 + 8 * y.nt2;
  y.o_sq = y.o_b3 + 8 * y.nt3;
  y.o_mq = y.o_sq + 4 * p.J;
  y.o_off = y.o_mq + 4 * p.J;
  y.o_sdm = y.o_off + 3 * p.J;
  y.o_topo = y.o_sdm + 8;
  const int nw = (p.J + 31) / 32;   // mask words a joint
  y.o_team = (y.o_topo + (1 + 3 * nw) * p.J + 3) / 4 * 4;
  // ≡ 8 (mod 32): the A-fragment reads (rows g, g + 8; float2 at 2t) hit
  // distinct banks; the H3 / G3 rows ≡ 2, for the pair layout's column
  // reads (16 rows, two joints a column apart)
  y.ldz = 8 * y.ks1;   // three k-steps read a step: conflicts are cheap
  y.ld1 = stride(8 * y.nt1, 8);
  y.ld2 = stride(8 * y.nt2, 8);
  y.ldh = stride(8 * y.nt3, 2);
  const int joints = 16 * p.J * TILE;
  const int acts = TILE * (y.ld1 + y.ld2);
  y.team_floats = TILE * (5 * y.ldz + y.ldh) + TEAM * 6 * TILE +
                  (joints > acts ? joints : acts);
  const int tiles = (p.B + TILE - 1) / TILE;
  int teams = (tiles + sms - 1) / sms;
  teams = teams < 1 ? 1 : (teams > BD::TEAMS ? BD::TEAMS : teams);
  while (teams > 0 && (static_cast<size_t>(y.o_team) + static_cast<size_t>(
                           teams) * y.team_floats) * 4 >
                          static_cast<size_t>(smem_limit))
    --teams;
  y.teams = teams;
  return y;
}

// The layout, shared bytes and grid of a launch at p's sizes, with the
// kernel's dynamic shared memory set to fit; returns a cudaError_t.
template <class BD, int PASSES, bool TIMED>
int prepare(const Params& p, Layout& y, size_t& smem, int& grid) {
  if (p.J < 1 || p.J > BD::MAXJ || p.L < 1 || p.L > BD::MAXL || p.H1 < 1 ||
      p.H1 > BD::MAXH || p.H2 < 1 || p.H2 > BD::MAXH ||
      p.H3 != 4 * p.J + 3 || p.B < 1 || p.sync_k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  y = make_layout<BD>(p, sms, smem_limit);
  if (y.teams < 1) return static_cast<int>(cudaErrorInvalidValue);
  smem = (static_cast<size_t>(y.o_team) + static_cast<size_t>(y.teams) *
                                              y.team_floats) * sizeof(float);
  err = cudaFuncSetAttribute(iter_block_kernel<BD, PASSES, TIMED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  const int tiles = (p.B + TILE - 1) / TILE;
  grid = (tiles + y.teams - 1) / y.teams;
  return static_cast<int>(err);
}

template <class BD, int PASSES, bool TIMED>
int launch(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  Layout y;
  size_t smem = 0;
  int grid = 0;
  const int err = prepare<BD, PASSES, TIMED>(p, y, smem, grid);
  if (err != 0) return err;
  iter_block_kernel<BD, PASSES, TIMED>
      <<<grid, y.teams * TEAM_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(p, y);
  return static_cast<int>(cudaGetLastError());
}

// What a launch of the 3xTF32 kernel at p's sizes takes, as the card
// reports it: out[0..4] = registers a thread (cudaFuncGetAttributes),
// threads a block, shared bytes a block, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), blocks.
template <class BD>
int launch_config(const void* params, int* out) {
  const Params& p = *static_cast<const Params*>(params);
  Layout y;
  size_t smem = 0;
  int grid = 0;
  const int err = prepare<BD, 3, false>(p, y, smem, grid);
  if (err != 0) return err;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, iter_block_kernel<BD, 3, false>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, iter_block_kernel<BD, 3, false>, y.teams * TEAM_THREADS,
        smem);
  out[0] = attr.numRegs;
  out[1] = y.teams * TEAM_THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  out[4] = grid;
  return static_cast<int>(e);
}

}  // namespace

extern "C" int iter_block_params_size() { return static_cast<int>(sizeof(Params)); }

extern "C" int iter_block_tile_lanes() { return TILE; }

// `params` points to a host Params struct filled by the wrapper (ctypes
// Structure of the same layout).  Launches on `stream`; returns
// cudaGetLastError().
// The narrow build (J ≤ 32, L ≤ 32, H1/H2 ≤ 64).  `params` points to a
// host Params struct filled by the wrapper (ctypes Structure of the same
// layout).  Launches on `stream`; returns cudaGetLastError().
extern "C" int iter_block(const void* params, void* stream) {
  return launch<Narrow, 3, false>(params, stream);
}

// The same kernel with its products in one TF32 pass: the control that
// K1's tolerance must refuse.
extern "C" int iter_block_tf32(const void* params, void* stream) {
  return launch<Narrow, 1, false>(params, stream);
}

// The same kernel reading the SM clock after each phase of each step into
// `params->clocks` (CLOCK_SLOTS a warp: the phases; the last, the steps).
extern "C" int iter_block_timed(const void* params, void* stream) {
  return launch<Narrow, 3, true>(params, stream);
}

// The general build (J ≤ 128, L ≤ 128, H1/H2 ≤ 272) in its layouts:
// weights resident in shared memory (up to 4 teams a block, as many as
// fit beside them) or streamed from device memory (a team a block, at
// most 4 or 2 blocks an SM); the wrapper picks
// (drag/iter_kernel.py:general_layout).  Each with its TF32 control and
// its timed build, as above.
extern "C" int iter_block_resident(const void* params, void* stream) {
  return launch<Resident, 3, false>(params, stream);
}

extern "C" int iter_block_resident_tf32(const void* params, void* stream) {
  return launch<Resident, 1, false>(params, stream);
}

extern "C" int iter_block_resident_timed(const void* params, void* stream) {
  return launch<Resident, 3, true>(params, stream);
}

extern "C" int iter_block_streamed4(const void* params, void* stream) {
  return launch<Streamed4, 3, false>(params, stream);
}

extern "C" int iter_block_streamed4_tf32(const void* params, void* stream) {
  return launch<Streamed4, 1, false>(params, stream);
}

extern "C" int iter_block_streamed4_timed(const void* params, void* stream) {
  return launch<Streamed4, 3, true>(params, stream);
}

extern "C" int iter_block_streamed2(const void* params, void* stream) {
  return launch<Streamed2, 3, false>(params, stream);
}

extern "C" int iter_block_streamed2_tf32(const void* params, void* stream) {
  return launch<Streamed2, 1, false>(params, stream);
}

extern "C" int iter_block_streamed2_timed(const void* params, void* stream) {
  return launch<Streamed2, 3, true>(params, stream);
}

extern "C" int iter_block_streamed1(const void* params, void* stream) {
  return launch<Streamed1, 3, false>(params, stream);
}

extern "C" int iter_block_streamed1_tf32(const void* params, void* stream) {
  return launch<Streamed1, 1, false>(params, stream);
}

extern "C" int iter_block_streamed1_timed(const void* params, void* stream) {
  return launch<Streamed1, 3, true>(params, stream);
}

// Each kernel's launch at p's sizes (launch_config above).
extern "C" int iter_block_config(const void* params, int* out) {
  return launch_config<Narrow>(params, out);
}

extern "C" int iter_block_resident_config(const void* params, int* out) {
  return launch_config<Resident>(params, out);
}

extern "C" int iter_block_streamed4_config(const void* params, int* out) {
  return launch_config<Streamed4>(params, out);
}

extern "C" int iter_block_streamed2_config(const void* params, int* out) {
  return launch_config<Streamed2>(params, out);
}

extern "C" int iter_block_streamed1_config(const void* params, int* out) {
  return launch_config<Streamed1>(params, out);
}

// A build's limits (general = 0: the narrow build; else the general):
// limits[0..2] = joints, latent dims, hidden widths.
extern "C" void iter_block_limits(int general, int* limits) {
  static_assert(Resident::MAXJ == Streamed4::MAXJ &&
                Resident::MAXL == Streamed4::MAXL &&
                Resident::MAXH == Streamed4::MAXH &&
                Streamed2::MAXJ == Streamed4::MAXJ &&
                Streamed2::MAXL == Streamed4::MAXL &&
                Streamed2::MAXH == Streamed4::MAXH &&
                Streamed1::MAXJ == Streamed4::MAXJ &&
                Streamed1::MAXL == Streamed4::MAXL &&
                Streamed1::MAXH == Streamed4::MAXH, "one general build");
  limits[0] = general ? Resident::MAXJ : Narrow::MAXJ;
  limits[1] = general ? Resident::MAXL : Narrow::MAXL;
  limits[2] = general ? Resident::MAXH : Narrow::MAXH;
}

// The current device's SMs, shared memory a block may opt in to and shared
// memory an SM has (out[0..2]); returns a cudaError_t.  The wrapper picks
// the general build's layout from these.
extern "C" int iter_block_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        out + 2, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return static_cast<int>(err);
}
