// The fused feed-forward with counter-hash dropout, shared by both layouts:
// K3a/K3b (rows, ff_rows.cu) and K3c/K3d (lanes, ff_lanes.cu).
//
// y = drop(relu(x·W1ᵀ + b1))·W2ᵀ + b2 per column of x, with W1 (F, D) and
// W2 (D, F) as stored in the parameter tree.  A "column" is one token's D
// features: a row of x (M, D) in the rows layout, a (token, lane) pair of
// x (S, D, B) in the lanes layout.  A layout struct L says where a column's
// features lie and how its dropout hash starts:
//   L::kMinor               column tiles load feature-fastest (rows) or
//                           column-fastest (lanes), whichever is contiguous
//   lay.tiles()             column tiles of BN columns
//   lay.cols()              columns in all
//   lay.tile_view(t)        where tile t's features lie (TileView)
//   lay.col(t, j)           flat column of slot j of tile t, -1 past the end
//   lay.offset(k, c)        index of feature k of column c
//   lay.hash_base(c, seed)  the hash of (column c, hidden row 0); hidden row f
//                           hashes to hash_base + f·lay.fstride (uint32)
// so the mask is the TPU kernel's bit for bit whatever this kernel's tiling.
//
// What bounds it on the H100: tensor-core operations.  Each column costs
// 2·D·F·2 FLOP forward, the backward five products of that size, every
// product run as 3xTF32 (three TF32 passes); the bytes (x, g, y, dx and
// the ~0.8 MB of weights) are two orders of magnitude below that bound.
// The (columns, F) hidden is never stored.
//
// What the design does about it:
// * a block owns BN = 64 columns at a time; the hidden is produced in
//   chunks of FC = 64 rows and consumed at once, so no hidden value and no
//   mask bit reaches device memory;
// * every product runs on the tensor cores as 3xTF32 (mma.sync.m16n8k8,
//   operands split hi + lo, lo·hi + hi·lo + hi·hi from a zero accumulator
//   over K ≤ 64, then added in float32): float32 accuracy;
// * every pre-activation of all four kernels is formed by one routine,
//   pre_mma (preᵀ = xᵀ·W1ᵀ, then "+ b1"), with the same operand roles,
//   k order, passes and warp-to-fragment mapping in the forward and in the
//   backward, so the ReLU gate of the backward equals the forward's bit for
//   bit;
// * the forward (ff_fwd_kernel) keeps the hidden chunk in registers between
//   its two products (FF1's accumulator fragment is FF2's A fragment), the
//   next chunk's weights arrive by cp.async during the current one, and
//   when column tiles are few a thread-block cluster splits the hidden and
//   adds its partials through distributed shared memory in rank order: one
//   launch a call in both layouts;
// * the backward (ff_bwd_kernel) forms each hidden element once and feeds
//   it to all four gradient products; the weight gradients sum over all
//   columns, dx over all hidden rows: the TPU carried those sums across its
//   sequential grid, here each block writes partials and
//   ff_bwd_reduce_kernel adds them in a fixed order: deterministic, no
//   atomics.  Two launches a call.
// The TPU kernels ran bf16 operands by default; the port is float32
// throughout.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff {

constexpr int D = 48;     // d_model
constexpr int BN = 64;    // columns per tile
constexpr int FC = 64;    // hidden rows per chunk
constexpr int NT = 256;   // threads per block
constexpr int SMS = 132;  // H100 SXM
constexpr uint32_t TILE_MIX = 0x7FEB352Du;

// Shared-memory row strides (floats) that make every fragment read free of
// bank conflicts: lanes read (k = t, n or m = g) of [k][·] arrays at a
// stride ≡ 8 or 24 (mod 32), float2 pairs (m or n = g, k = 2t) of [·][k]
// arrays at ≡ 8 or 24 too.
constexpr int LD_K8 = 72;   // Gs [d][j], W2 [d][f], DP [f][j]
constexpr int LD_T = 56;    // XT, GT [j][d], W1 [f][d]
constexpr int LD_HD = 68;   // HD [f][j]

struct Mask {
  uint32_t seedmix;  // seed · 0x9E3779B1 mod 2^32
  uint32_t thresh;   // keep iff hash >= thresh
  float scale;       // float32(1 / (1 - rate))
  int use;           // rate > 0
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool keep_bit(const Mask& m, uint32_t base, int f,
                                         uint32_t fstride) {
  return fmix32(static_cast<uint32_t>(f) * fstride + base) >= m.thresh;
}

// ---- 3xTF32 on mma.sync ----

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32 for finite x, in two integer operations.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a·b, one m16n8k8 TF32 product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b as 3xTF32 passes, in this order: lo·hi, hi·lo, hi·hi.
__device__ __forceinline__ void mma3x(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4],
                                      const uint32_t (&bh)[2],
                                      const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// c[mi][ni] += A·B over KS k-steps of 8 for the warp's MT × NT tiles of
// 16 × 8, as 3xTF32: every operand split as hi + lo, lo·hi + hi·lo + hi·hi
// (ops/temporal_fused.matmul_3xtf32).  The tensor cores' accumulation
// truncates, so the product is formed from a zero accumulator over its
// K ≤ 64 alone and added to c in float32 (c sums over many products).
// a(mi, r, k) is A[16·mi + r][k] and b(ni, k, n) is B[k][8·ni + n] of the
// warp's tiles.
template <int MT, int NT, int KS, class FA, class FB>
__device__ __forceinline__ void mma3(float (&c)[MT][NT][4], FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[MT][NT][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < 8 * KS; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      split(a(mi, g, k0 + t), ah[mi][0], al[mi][0]);
      split(a(mi, g + 8, k0 + t), ah[mi][1], al[mi][1]);
      split(a(mi, g, k0 + t + 4), ah[mi][2], al[mi][2]);
      split(a(mi, g + 8, k0 + t + 4), ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      split(b(ni, k0 + t, g), bh[ni][0], bl[ni][0]);
      split(b(ni, k0 + t + 4, g), bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma3x(s[mi][ni], ah[mi], al[mi], bh[ni], bl[ni]);
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mi][ni][e] += s[mi][ni][e];
}

// ---- The pre-activation: one routine for the forward and the backward ----

// The A fragments of one m-tile of 16 columns of xᵀ (XT [j][d], LD_T),
// over the D/8 k-steps.  Within k-step s the contraction index pairs
// features, k = t ↔ d = 8s + 2t and k = t + 4 ↔ d = 8s + 2t + 1, so each
// row's two values are one float2 read.
struct XFrag {
  float v[D / 8][4];
};

__device__ __forceinline__ void x_frag(XFrag& a, const float* XT, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    const float2 r0 = *reinterpret_cast<const float2*>(
        XT + (m0 + g) * LD_T + 8 * s + 2 * t);
    const float2 r1 = *reinterpret_cast<const float2*>(
        XT + (m0 + g + 8) * LD_T + 8 * s + 2 * t);
    a.v[s][0] = r0.x;   // (row g,     k = t)
    a.v[s][1] = r1.x;   // (row g + 8, k = t)
    a.v[s][2] = r0.y;   // (row g,     k = t + 4)
    a.v[s][3] = r1.y;   // (row g + 8, k = t + 4)
  }
}

// preᵀ = xᵀ·W1ᵀ + b1 for NF n-tiles of 8 hidden rows from chunk row n0:
// pre[ni][e] is (column m0 + g + 8·(e >> 1), hidden row n0 + 8·ni + 2t +
// (e & 1)) of the m-tile whose fragments `a` holds.  W1c [f][d] (LD_T) is
// the chunk's W1 and b1 its biases.  The product is 3xTF32 over the D/8
// k-steps in order from a zero accumulator (K = 48: one chain), passes
// lo·hi, hi·lo, hi·hi, then "+ b1" once in float32.  This is the only
// place any FF kernel forms a pre-activation, so the backward's gates are
// the forward's bit for bit.
template <int NF>
__device__ __forceinline__ void pre_mma(float (&pre)[NF][4], const XFrag& a,
                                        const float* W1c,
                                        const float* __restrict__ b1,
                                        int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[NF][4] = {};
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a.v[ks][i], ah[i], al[i]);
#pragma unroll
    for (int ni = 0; ni < NF; ++ni) {
      const float2 w = *reinterpret_cast<const float2*>(
          W1c + (n0 + 8 * ni + g) * LD_T + 8 * ks + 2 * t);
      uint32_t bh[2], bl[2];
      split(w.x, bh[0], bl[0]);
      split(w.y, bh[1], bl[1]);
      mma3x(s[ni], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int ni = 0; ni < NF; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pre[ni][e] = s[ni][e] + __ldg(b1 + n0 + 8 * ni + 2 * t + (e & 1));
}

// Where tile t lies: feature k of slot j < n at first + k·kstride +
// j·jstride.
struct TileView {
  size_t first;
  int kstride, jstride, n;
};

// XT[j·xt_ld + k] = feature k of slot j of tile t, 0 past the end; with
// Xs, also Xs[k·xs_ld + j], the same values transposed.
template <class L>
__device__ __forceinline__ void load_tile(const L& lay, float* Xs, float* XT,
                                          const float* __restrict__ src,
                                          int t, int xs_ld = BN,
                                          int xt_ld = LD_T) {
  constexpr int PER = D * BN / NT;  // all loads in flight, then the stores
  const TileView v = lay.tile_view(t);
  float val[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = threadIdx.x + r * NT;
    const int k = L::kMinor ? idx % D : idx / BN;
    const int j = L::kMinor ? idx / D : idx % BN;
    val[r] = j < v.n ? src[v.first + k * v.kstride + j * v.jstride] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = threadIdx.x + r * NT;
    const int k = L::kMinor ? idx % D : idx / BN;
    const int j = L::kMinor ? idx / D : idx % BN;
    XT[j * xt_ld + k] = val[r];
    if (Xs != nullptr && !L::kMinor) Xs[k * xs_ld + j] = val[r];
  }
  // feature-fastest tiles reach Xs through XT: stored straight to Xs, a
  // warp's 32 features would hit one bank
  if (Xs != nullptr && L::kMinor) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int idx = threadIdx.x + r * NT;
      Xs[(idx / BN) * xs_ld + idx % BN] = XT[(idx % BN) * xt_ld + idx / BN];
    }
  }
}

// The flat columns of this thread's two fragment rows (slots m0 + g and
// m0 + g + 8 of tile t, -1 past the end) and their hash bases.
template <class L>
__device__ __forceinline__ void frag_cols(const L& lay, const Mask& m, int t,
                                          int m0, int col[2],
                                          uint32_t base[2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    col[h] = lay.col(t, m0 + g + 8 * h);
    base[h] = lay.hash_base(col[h] < 0 ? 0 : col[h], m.seedmix);
  }
}

// dpre for one element: the forward's gate and mask replayed.
__device__ __forceinline__ float dpre_of(const Mask& m, float pre, float dhd,
                                         bool keep) {
  if (!(pre > 0.f)) return 0.f;
  if (!m.use) return dhd;
  return keep ? dhd * m.scale : 0.f;
}

// ---- The forward ----

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

// One chunk's weights in shared memory: W1c [f][d] (LD_T), then W2c [d][f]
// (LD_K8).
constexpr int W_STAGE = FC * LD_T + D * LD_K8;
constexpr size_t FWD_SMEM = (BN * LD_T + 2 * W_STAGE) * 4;

// The weights of the chunk from hidden row f0 into `stage`, 16 bytes a
// copy, as one cp.async group.
__device__ __forceinline__ void fetch_chunk(float* stage,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ w2,
                                            int F, int f0) {
  constexpr int PER = FC * D / 4 / NT;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int q = threadIdx.x + r * NT;
    cp_async16(stage + (q / (D / 4)) * LD_T + (q % (D / 4)) * 4,
               w1 + static_cast<size_t>(f0) * D + 4 * q);
    cp_async16(stage + FC * LD_T + (q / (FC / 4)) * LD_K8 + (q % (FC / 4)) * 4,
               w2 + static_cast<size_t>(q / (FC / 4)) * F + f0 +
                   (q % (FC / 4)) * 4);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The forward.  A cluster of CS blocks owns column tile blockIdx.x / CS,
// rank r the hidden chunks [r·n/CS, (r + 1)·n/CS) of n = F/FC.  Warp w
// takes the columns of m-tile w >> 1 (16) and the hidden rows of half
// w & 1 (32) of each chunk:
//   1. preᵀ by pre_mma; the keep bits (hashes) beforehand, integer work
//      the scheduler can put between the products;
//   2. h = drop(relu(pre)) in registers, split, as FF2's A fragments: FF1's
//      n-tile i (hidden rows 8i + 2t, 2t + 1 at columns g, g + 8) is FF2's
//      k-step i with k = t ↔ hidden row 2t and k = t + 4 ↔ 2t + 1, so W2c
//      is read as float2 pairs (d, 2t);
//   3. yᵀ += hᵀ·W2ᵀ over the warp's 32 hidden rows (3xTF32 from zero, then
//      added in float32).
// The two halves' partials meet in shared memory (half 0 + half 1), the
// ranks' sums through distributed shared memory in rank order, + b2.
template <class L>
__global__ void __launch_bounds__(NT, 2)
ff_fwd_kernel(L lay, const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, float* __restrict__ y, int F,
              Mask m) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  float* XT = reinterpret_cast<float*>(smem4);  // BN x LD_T, then yᵀ sums
  float* W = XT + BN * LD_T;                    // 2 stages of W_STAGE
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (warp >> 1) * 16, half = warp & 1, n0 = half * 32;
  const int t = blockIdx.x / CS;
  const int n = F / FC, c_begin = n * rank / CS, c_end = n * (rank + 1) / CS;
  if (c_begin < c_end) fetch_chunk(W, w1, w2, F, c_begin * FC);
  load_tile(lay, nullptr, XT, x, t);
  __syncthreads();
  XFrag a;
  x_frag(a, XT, m0);
  int col[2];
  uint32_t base[2];
  frag_cols(lay, m, t, m0, col, base);
  float yacc[D / 8][4] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const float* W1c = W + ((c - c_begin) & 1) * W_STAGE;
    const float* W2c = W1c + FC * LD_T;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // chunk c visible; the other stage free
    if (c + 1 < c_end)
      fetch_chunk(W + ((c + 1 - c_begin) & 1) * W_STAGE, w1, w2, F,
                  (c + 1) * FC);
    const int f0 = c * FC;
    uint32_t keep = 0xFFFFu;
    if (m.use) {
      keep = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        keep |= static_cast<uint32_t>(keep_bit(
                    m, base[(i & 3) >> 1],
                    f0 + n0 + 8 * (i >> 2) + 2 * tq + (i & 1), lay.fstride))
                << i;
    }
    float pre[4][4];
    pre_mma<4>(pre, a, W1c, b1 + f0, n0);
    float s[D / 8][4] = {};
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = fmaxf(pre[ni][e], 0.f);
        if (m.use) h[e] = (keep >> (ni * 4 + e)) & 1u ? h[e] * m.scale : 0.f;
      }
      uint32_t ah[4], al[4];
      split(h[0], ah[0], al[0]);   // (row g,     k = t)
      split(h[2], ah[1], al[1]);   // (row g + 8, k = t)
      split(h[1], ah[2], al[2]);   // (row g,     k = t + 4)
      split(h[3], ah[3], al[3]);   // (row g + 8, k = t + 4)
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float2 w = *reinterpret_cast<const float2*>(
            W2c + (8 * nd + gq) * LD_K8 + n0 + 8 * ni + 2 * tq);
        uint32_t bh[2], bl[2];
        split(w.x, bh[0], bl[0]);
        split(w.y, bh[1], bl[1]);
        mma3x(s[nd], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nd][e] += s[nd][e];
  }
  // yᵀ (BN x D, stride LD_T) in XT: half 1's partial, then half 0 adds its
  // own in front of it
  float* Ys = XT;
  __syncthreads();
#pragma unroll
  for (int pass = 1; pass >= 0; --pass) {
    if (half == pass)
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* at = reinterpret_cast<float2*>(
              Ys + (m0 + gq + 8 * h) * LD_T + 8 * nd + 2 * tq);
          float2 v = make_float2(yacc[nd][2 * h], yacc[nd][2 * h + 1]);
          if (pass == 0) {
            v.x += at->x;
            v.y += at->y;
          }
          *at = v;
        }
    __syncthreads();
  }
  cluster.sync();
  // rank r stores its share of the tile: the ranks' sums in rank order
  constexpr int ALL = BN * D;
  for (int idx = ALL * rank / CS + tid; idx < ALL * (rank + 1) / CS;
       idx += NT) {
    const int j = L::kMinor ? idx / D : idx % BN;
    const int d = L::kMinor ? idx % D : idx / BN;
    const int c = lay.col(t, j);
    if (c < 0) continue;
    float acc = 0.f;
    for (int q = 0; q < CS; ++q)
      acc += cluster.map_shared_rank(Ys, q)[j * LD_T + d];
    y[lay.offset(d, c)] = acc + __ldg(b2 + d);
  }
  cluster.sync();  // no block leaves while its sums are read
}

// Blocks a column tile of the forward takes: a cluster that splits the
// hidden when tiles are few, so that the launch still fills the SMs (two
// blocks an SM) and its last wave is short.
inline int fwd_cluster(int tiles, int F) {
  int cs = tiles >= 8 * SMS ? 1 : (2 * tiles >= SMS ? 2 : 4);
  while (cs > F / FC) cs /= 2;
  return cs;
}

// ---- The backward: one pass over the hidden, 3xTF32 on mma.sync ----

constexpr int HCH = 4;      // hidden chunks a backward block owns
// Per hidden chunk of a block: its dW1 (FC, D), dW2ᵀ (FC, D) and db1 (FC)
// sums over the block's column tiles, the first two in the order of the
// accumulator fragments (entry (((warp & 3)·6 + mi·3 + ni)·4 + e)·32 +
// lane), so that each thread adds to its own conflict-free words.
constexpr int SUM_PER = 2 * FC * D + FC;
constexpr size_t BWD_SMEM =
    (BN * LD_T + D * LD_K8 + BN * LD_T + FC * LD_T + D * LD_K8 +
     FC * LD_K8 + FC * LD_HD + 4 * FC + HCH * SUM_PER) * 4;

// DP holds dpre at [f][j]; j's bit 2 is flipped on rows with f's bit 2
// set, so that both the k = f reads of dx and the m = f reads of dW1 are
// conflict-free.
__device__ __forceinline__ int dp_at(int f, int j) {
  return f * LD_K8 + (j ^ (f & 4));
}

// A hidden chunk's weights as float4 in registers, 2·W4 a thread: W1's
// rows f0.. (contiguous), then W2's columns f0.. row by row.
constexpr int W4 = FC * D / 4 / NT;

__device__ __forceinline__ void fetch_weights(float4 (&w)[2 * W4],
                                              const float* __restrict__ w1,
                                              const float* __restrict__ w2,
                                              int F, int f0) {
#pragma unroll
  for (int r = 0; r < W4; ++r) {
    const int q = threadIdx.x + r * NT;
    w[r] = __ldg(reinterpret_cast<const float4*>(
                     w1 + static_cast<size_t>(f0) * D) + q);
    w[W4 + r] = __ldg(reinterpret_cast<const float4*>(
        w2 + static_cast<size_t>(q / (FC / 4)) * F + f0 + (q % (FC / 4)) * 4));
  }
}

// W1d[f][k] (pre_mma's layout) and W2s[d][f] from fetch_weights.
__device__ __forceinline__ void stage_weights(const float4 (&w)[2 * W4],
                                              float* W1d, float* W2s) {
#pragma unroll
  for (int r = 0; r < W4; ++r) {
    const int q = threadIdx.x + r * NT;
    *reinterpret_cast<float4*>(W1d + (4 * q / D) * LD_T + 4 * q % D) = w[r];
    *reinterpret_cast<float4*>(W2s + (q / (FC / 4)) * LD_K8 +
                               (q % (FC / 4)) * 4) = w[W4 + r];
  }
}

// Floats of one column group's weight-gradient partial:
// [dW1 (F, D) | dW2ᵀ (F, D) | db1 (F) | db2 (D)].
__host__ __device__ __forceinline__ long long wpart_floats(int F) {
  return 2LL * F * D + F + D;
}

// The backward: (dx, dW1, db1, dW2, db2) at x for output gradient g, the
// hidden recomputed.  grid (CG column groups, HG hidden groups): block
// (cg, hg) takes the column tiles of cg in turn and, for each, the HCH
// hidden chunks of hg.  Per (tile, chunk), warp w on the forward's
// fragments (columns of m-tile w >> 1, hidden rows of half w & 1):
//   1. dhᵀ = gᵀ·W2 and preᵀ by pre_mma, the forward's own arithmetic, so
//      the gate is the forward's bit for bit, both on the tensor cores;
//   2. dpre = gate · mask · dh and hd = relu(pre) · mask in registers,
//      stored to DP and HD; db1 summed over the tile's columns;
//   3. dx += W1ᵀ·dpre (registers, over the chunks), then dW1 = dpre·xᵀ
//      (warps 0-3) and dW2ᵀ = hd·gᵀ (warps 4-7) over the tile's columns,
//      added to the chunk's sums in shared memory.
// Each hidden element is formed once.  One block an SM (BWD_SMEM).  dx
// goes out as one partial per hidden group (laid out like x), the weight
// gradients as one partial per column group (wpart_floats);
// ff_bwd_reduce_kernel adds them in order.
template <class L>
__global__ void __launch_bounds__(NT, 1)
ff_bwd_kernel(L lay, const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ g, float* __restrict__ dx_parts,
              float* __restrict__ w_parts, int F, Mask m) {
  extern __shared__ float4 smem4[];
  float* XT = reinterpret_cast<float*>(smem4);  // BN x LD_T
  float* Gs = XT + BN * LD_T;                   // D x LD_K8
  float* GT = Gs + D * LD_K8;                   // BN x LD_T
  float* W1d = GT + BN * LD_T;                  // FC x LD_T (pre_mma)
  float* W2s = W1d + FC * LD_T;                 // D x LD_K8
  float* DP = W2s + D * LD_K8;                  // FC x LD_K8, dp_at
  float* HD = DP + FC * LD_K8;                  // FC x LD_HD
  float* DB1 = HD + FC * LD_HD;                 // 4 x FC, db1 by m-tile
  float* sums = DB1 + 4 * FC;                   // HCH x SUM_PER
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int T = lay.tiles(), cg = blockIdx.x, hg = blockIdx.y;
  const int t_begin =
      static_cast<int>(static_cast<long long>(T) * cg / gridDim.x);
  const int t_end =
      static_cast<int>(static_cast<long long>(T) * (cg + 1) / gridDim.x);
  const int c_begin = hg * HCH;
  const int nc = min(F / FC - c_begin, HCH);
  // the warp's tiles: dhᵀ and preᵀ m-tile mt (16 columns) and n-tiles
  // nh.. (hidden rows); dx m-tile mt (16 columns) and n-tiles nw..
  // (features); dW m-tiles from row mw (32 hidden rows) and n-tiles nw..
  const int mt = warp >> 1, nh = (warp & 1) * 4, nw = (warp & 1) * 3;
  const int mw = ((warp & 3) >> 1) * 32;
  for (int i = tid; i < HCH * SUM_PER; i += NT) sums[i] = 0.f;
  float db2 = 0.f;
  // the weights of the chunk after the current one (a block's tiles cycle
  // over the same chunks), fetched a whole step ahead
  float4 wnext[2 * W4];
  fetch_weights(wnext, w1, w2, F, c_begin * FC);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();
    load_tile(lay, nullptr, XT, x, t);
    load_tile(lay, Gs, GT, g, t, LD_K8, LD_T);
    __syncthreads();
    if (hg == 0 && tid < 4 * D) {  // db2: 4 threads a feature, then a tree
      float s = 0.f;
      for (int j = (tid & 3) * 16; j < (tid & 3) * 16 + 16; ++j)
        s += Gs[(tid >> 2) * LD_K8 + j];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      db2 += s + __shfl_xor_sync(0xffffffffu, s, 2);
    }
    int col[2];
    uint32_t base[2];
    frag_cols(lay, m, t, mt * 16, col, base);
    float cdx[1][3][4] = {};
    for (int c = 0; c < nc; ++c) {
      const int f0 = (c_begin + c) * FC;
      float* csum = sums + c * SUM_PER;
      __syncthreads();
      stage_weights(wnext, W1d, W2s);
      __syncthreads();
      fetch_weights(wnext, w1, w2, F, (c_begin + (c + 1) % nc) * FC);
      // 1. dhᵀ and preᵀ on the warp's fragments
      float dh[1][4][4] = {};
      mma3<1, 4, D / 8>(
          dh, [&](int, int r, int k) { return Gs[k * LD_K8 + mt * 16 + r]; },
          [&](int ni, int k, int n) {
            return W2s[k * LD_K8 + (nh + ni) * 8 + n];
          });
      float pre[4][4];
      {
        XFrag a;
        x_frag(a, XT, mt * 16);
        pre_mma<4>(pre, a, W1d, b1 + f0, nh * 8);
      }
      // 2. dpre and the dropped hidden, the forward's gate and mask; db1
      // over the warp's 16 columns, e's halves in order, then lanes
      float db1p[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        db1p[ni][0] = db1p[ni][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = (nh + ni) * 8 + 2 * tq + (e & 1);
          const int j = mt * 16 + gq + 8 * (e >> 1);
          const bool keep =
              m.use ? keep_bit(m, base[e >> 1], f0 + f, lay.fstride) : true;
          float h = fmaxf(pre[ni][e], 0.f);
          if (m.use) h = keep ? h * m.scale : 0.f;
          float dp = dpre_of(m, pre[ni][e], dh[0][ni][e], keep);
          if (col[e >> 1] < 0) dp = h = 0.f;
          DP[dp_at(f, j)] = dp;
          HD[f * LD_HD + j] = h;
          db1p[ni][e & 1] += dp;
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            db1p[ni][h] += __shfl_xor_sync(0xffffffffu, db1p[ni][h], off);
          if (gq == 0) DB1[mt * FC + (nh + ni) * 8 + 2 * tq + h] = db1p[ni][h];
        }
      __syncthreads();
      if (tid < FC)  // db1 of the tile: the four m-tiles in order
        csum[2 * FC * D + tid] +=
            ((DB1[tid] + DB1[FC + tid]) + DB1[2 * FC + tid]) +
            DB1[3 * FC + tid];
      // 3. dx += W1ᵀ·dpre (every warp), then dW1 = dpre·xᵀ (warps 0-3) or
      // dW2ᵀ = hd·gᵀ (warps 4-7) over the tile, 2 × 3 tiles a warp
      mma3<1, 3, FC / 8>(
          cdx, [&](int, int r, int k) { return DP[dp_at(k, mt * 16 + r)]; },
          [&](int ni, int k, int n) {
            return W1d[k * LD_T + (nw + ni) * 8 + n];
          });
      float cw[2][3][4] = {};
      if (warp < 4)
        mma3<2, 3, BN / 8>(
            cw,
            [&](int mi, int r, int k) {
              return DP[dp_at(mw + mi * 16 + r, k)];
            },
            [&](int ni, int k, int n) {
              return XT[k * LD_T + (nw + ni) * 8 + n];
            });
      else
        mma3<2, 3, BN / 8>(
            cw,
            [&](int mi, int r, int k) {
              return HD[(mw + mi * 16 + r) * LD_HD + k];
            },
            [&](int ni, int k, int n) {
              return GT[k * LD_T + (nw + ni) * 8 + n];
            });
      float* cs = csum + (warp < 4 ? 0 : FC * D);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 3; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cs[(((warp & 3) * 6 + mi * 3 + ni) * 4 + e) * 32 + lane] +=
                cw[mi][ni][e];
    }
    // this hidden group's dx partial of the tile
    float* dst = dx_parts + static_cast<size_t>(hg) * lay.cols() * D;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = lay.col(t, mt * 16 + gq + 8 * (e >> 1));
      if (c < 0) continue;
#pragma unroll
      for (int ni = 0; ni < 3; ++ni)
        dst[lay.offset((nw + ni) * 8 + 2 * tq + (e & 1), c)] = cdx[0][ni][e];
    }
  }
  __syncthreads();
  float* part = w_parts + cg * wpart_floats(F);
  const size_t r0 = static_cast<size_t>(c_begin) * FC;
  for (int i = tid; i < nc * FC * D; i += NT) {
    // sums hold dW1 and dW2ᵀ in fragment order: see phase 3
    const int r = i % (FC * D), ln = r % 32, e = (r / 32) % 4;
    const int tile = r / 128, q = tile / 6, mi = tile % 6 / 3, ni = tile % 3;
    const int f = (q >> 1) * 32 + mi * 16 + (ln >> 2) + 8 * (e >> 1);
    const int d = ((q & 1) * 3 + ni) * 8 + 2 * (ln & 3) + (e & 1);
    const size_t at = (r0 + (i / (FC * D)) * FC + f) * D + d;
    const float* cs = sums + (i / (FC * D)) * SUM_PER + r;
    part[at] = cs[0];
    part[static_cast<size_t>(F) * D + at] = cs[FC * D];
  }
  for (int i = tid; i < nc * FC; i += NT)
    part[2 * static_cast<size_t>(F) * D + r0 + i] =
        sums[(i / FC) * SUM_PER + 2 * FC * D + i % FC];
  if (hg == 0 && tid < 4 * D && (tid & 3) == 0)
    part[2 * static_cast<size_t>(F) * D + F + tid / 4] = db2;
}

// The backward's sums, one launch: dx[i] = the HG hidden groups' partials
// added in order; each weight gradient the CG column groups' partials
// added in order (dW2 transposed back to (D, F)).
template <class L>
__global__ void ff_bwd_reduce_kernel(const float* __restrict__ dx_parts,
                                     int HG, long long n_dx,
                                     const float* __restrict__ w_parts,
                                     int CG, int F, float* __restrict__ dx,
                                     float* __restrict__ dw1,
                                     float* __restrict__ db1,
                                     float* __restrict__ dw2,
                                     float* __restrict__ db2) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i < n_dx) {
    float acc = 0.f;
    for (int p = 0; p < HG; ++p) acc += dx_parts[p * n_dx + i];
    dx[i] = acc;
    return;
  }
  const long long e = i - n_dx, per = wpart_floats(F), fd = 1LL * F * D;
  if (e >= per) return;
  float acc = 0.f;
  for (int q = 0; q < CG; ++q) acc += w_parts[q * per + e];
  if (e < fd) {
    dw1[e] = acc;
  } else if (e < 2 * fd) {
    const long long r = e - fd;
    dw2[(r % D) * F + r / D] = acc;
  } else if (e < 2 * fd + F) {
    db1[e - 2 * fd] = acc;
  } else {
    db2[e - 2 * fd - F] = acc;
  }
}

inline Mask make_mask(unsigned seedmix, unsigned thresh, float scale,
                      int use) {
  Mask m;
  m.seedmix = seedmix;
  m.thresh = thresh;
  m.scale = scale;
  m.use = use;
  return m;
}

inline int bad_width(int F) { return F < FC || F % FC != 0; }

// cp.async and fetch_weights read W1 and W2 16 bytes at a time.
inline bool misaligned(const float* w1, const float* w2) {
  return ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) &
          15) != 0;
}

// Host side: y = FF(x), one launch on `st` (fwd_cluster blocks a tile).
template <class L>
cudaError_t forward(const L& lay, const float* x, const float* w1,
                    const float* b1, const float* w2, const float* b2,
                    float* y, int F, Mask m, cudaStream_t st) {
  if (misaligned(w1, w2)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ff_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(FWD_SMEM));
  if (err != cudaSuccess) return err;
  const int cs = fwd_cluster(lay.tiles(), F);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(lay.tiles() * cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = FWD_SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ff_fwd_kernel<L>, lay, x, w1, b1, w2, b2, y,
                           F, m);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Hidden groups and column groups of the backward's grid: HCH chunks a
// hidden group, and as many column groups as fill the SMs once (one block
// an SM: BWD_SMEM), at most one a tile.
inline int bwd_hidden_groups(int F) { return (F / FC + HCH - 1) / HCH; }

inline int bwd_column_groups(int tiles, int F) {
  const int cg = SMS / bwd_hidden_groups(F);
  return cg < 1 ? 1 : (cg < tiles ? cg : tiles);
}

// Floats of the backward's workspace: the dx partials, then the weight-
// gradient partials.
inline long long bwd_workspace_floats(long long cols, int tiles, int F) {
  return bwd_hidden_groups(F) * cols * D +
         bwd_column_groups(tiles, F) * wpart_floats(F);
}

// Host side: (dx, dW1, db1, dW2, db2) of FF at x for output gradient g, in
// two launches (the pass, the sums); ws holds bwd_workspace_floats floats.
template <class L>
cudaError_t backward(const L& lay, const float* x, const float* w1,
                     const float* b1, const float* w2, const float* g,
                     float* dx, float* dw1, float* db1, float* dw2,
                     float* db2, float* ws, int F, Mask m, cudaStream_t st) {
  if (misaligned(w1, w2)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ff_bwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BWD_SMEM));
  if (err != cudaSuccess) return err;
  const int HG = bwd_hidden_groups(F);
  const int CG = bwd_column_groups(lay.tiles(), F);
  const long long n_dx = static_cast<long long>(lay.cols()) * D;
  float* w_parts = ws + HG * n_dx;
  ff_bwd_kernel<L><<<dim3(CG, HG), NT, BWD_SMEM, st>>>(lay, x, w1, b1, w2, g,
                                                       ws, w_parts, F, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = n_dx + wpart_floats(F);
  ff_bwd_reduce_kernel<L><<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0,
                            st>>>(ws, HG, n_dx, w_parts, CG, F, dx, dw1, db1,
                                  dw2, db2);
  return cudaGetLastError();
}

}  // namespace ff
