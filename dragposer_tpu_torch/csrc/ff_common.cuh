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
// What bounds it on the H100: arithmetic.  Each column costs 2·D·F·2 FLOP
// forward, the backward five products of that size; the bytes (x, g, y, dx
// and the ~0.8 MB of weights) are two orders of magnitude below the float32
// bound.  The (columns, F) hidden is never stored.
//
// What the design does about it:
// * a block owns BN = 64 columns at a time; the hidden is produced in
//   chunks of FC = 64 rows in shared memory and consumed at once, so no
//   hidden value and no mask bit reaches device memory;
// * every pre-activation is the same fmaf chain over k = 0..D-1 followed by
//   "+ b1" (pre_tile), on CUDA cores in the forward and in the backward, so
//   the ReLU gate of the backward equals the forward's bit for bit;
// * the forward (ff_fwd_kernel): float32 on CUDA cores, register tiles of
//   4×4 (hidden) and 3×4 (outputs) a thread; a launch may split the hidden
//   chunks over gridDim.y (partial sums, then a fixed-order sum) to put
//   enough blocks in flight when there are few column tiles;
// * the backward (ff_bwd_kernel) forms each hidden element once and feeds
//   it to all four gradient products, which run on the tensor cores as
//   3xTF32 (mma.sync.m16n8k8, float32 accuracy); the weight gradients sum
//   over all columns, dx over all hidden rows: the TPU carried those sums
//   across its sequential grid, here each block writes partials and
//   ff_bwd_reduce_kernel adds them in a fixed order: deterministic, no
//   atomics.  Two launches a call.
// The TPU kernels ran bf16 operands by default; the port is float32
// throughout.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ff {

constexpr int D = 48;     // d_model
constexpr int BN = 64;    // columns per tile
constexpr int FC = 64;    // hidden rows per chunk
constexpr int NT = 256;   // threads per block
constexpr uint32_t TILE_MIX = 0x7FEB352Du;

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

// pre[i][j] = (sum over k = 0..D-1, in order, of W1s[fl+i][k] · Xs[k][bl+j])
//             + b1[fl+i].  The one place a pre-activation is computed.
__device__ __forceinline__ void pre_tile(const float* W1s, const float* Xs,
                                         const float* __restrict__ b1,
                                         int fl, int bl, float pre[4][4]) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(Xs + k * BN + bl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = W1s[(fl + i) * D + k];
      acc[i][0] = fmaf(w, x.x, acc[i][0]);
      acc[i][1] = fmaf(w, x.y, acc[i][1]);
      acc[i][2] = fmaf(w, x.z, acc[i][2]);
      acc[i][3] = fmaf(w, x.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float bias = __ldg(b1 + fl + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) pre[i][j] = acc[i][j] + bias;
  }
}

// Where tile t lies: feature k of slot j < n at first + k·kstride +
// j·jstride.
struct TileView {
  size_t first;
  int kstride, jstride, n;
};

// Xs[k·xs_ld + j] = feature k of slot j of tile t, 0 past the end;
// XsT[j·xt_ld + k] the same values transposed, when given.
template <class L>
__device__ __forceinline__ void load_tile(const L& lay, float* Xs, float* XsT,
                                          const float* __restrict__ src,
                                          int t, int xs_ld = BN,
                                          int xt_ld = D) {
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
  // feature-fastest tiles go to XsT first and reach Xs through shared
  // memory: stored straight to Xs, a warp's 32 features would hit one bank
  const bool via_t = L::kMinor && XsT != nullptr;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = threadIdx.x + r * NT;
    const int k = L::kMinor ? idx % D : idx / BN;
    const int j = L::kMinor ? idx / D : idx % BN;
    if (!via_t) Xs[k * xs_ld + j] = val[r];
    if (XsT != nullptr) XsT[j * xt_ld + k] = val[r];
  }
  if (via_t) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int idx = threadIdx.x + r * NT;
      Xs[(idx / BN) * xs_ld + idx % BN] = XsT[(idx % BN) * xt_ld + idx / BN];
    }
  }
}

// W1s[f][k] = w1[f0 + f][k];  W2s[d][f] = w2[d][f0 + f]
__device__ __forceinline__ void load_weights(float* W1s, float* W2s,
                                             const float* __restrict__ w1,
                                             const float* __restrict__ w2,
                                             int F, int f0) {
  for (int idx = threadIdx.x; idx < FC * D; idx += NT)
    W1s[idx] = __ldg(w1 + static_cast<size_t>(f0) * D + idx);
  for (int idx = threadIdx.x; idx < D * FC; idx += NT)
    W2s[idx] = __ldg(w2 + static_cast<size_t>(idx / FC) * F + f0 + idx % FC);
}

// dpre for one element: the forward's gate and mask replayed.
__device__ __forceinline__ float dpre_of(const Mask& m, float pre, float dhd,
                                         bool keep) {
  if (!(pre > 0.f)) return 0.f;
  if (!m.use) return dhd;
  return keep ? dhd * m.scale : 0.f;
}

// This thread's four columns of tile t and their hash bases.
template <class L>
__device__ __forceinline__ void thread_cols(const L& lay, const Mask& m, int t,
                                            int bl, int col[4],
                                            uint32_t base[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    col[j] = lay.col(t, bl + j);
    base[j] = lay.hash_base(col[j] < 0 ? 0 : col[j], m.seedmix);
  }
}

// Hidden chunks [begin, end) of split blockIdx.y of gridDim.y.
__device__ __forceinline__ void chunk_range(int F, int& begin, int& end) {
  const int n = F / FC;
  begin = n * static_cast<int>(blockIdx.y) / static_cast<int>(gridDim.y);
  end = n * (static_cast<int>(blockIdx.y) + 1) / static_cast<int>(gridDim.y);
}

// The forward.  grid (lay.tiles(), splits).  One split: out = y.  Several:
// out holds one partial of y (no b2) per split, each laid out like y.
template <class L>
__global__ void __launch_bounds__(NT)
ff_fwd_kernel(L lay, const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out, int F,
           Mask m) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // D x BN
  float* W1s = Xs + D * BN;                     // FC x D
  float* W2s = W1s + FC * D;                    // D x FC
  float* Hs = W2s + D * FC;                     // FC x BN
  const int t = blockIdx.x, tid = threadIdx.x;
  const int bl = (tid % 16) * 4, fl = (tid / 16) * 4, dl = (tid / 16) * 3;
  load_tile(lay, Xs, nullptr, x, t);
  int col[4];
  uint32_t base[4];
  thread_cols(lay, m, t, bl, col, base);
  int c_begin, c_end;
  chunk_range(F, c_begin, c_end);
  float acc[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int ch = c_begin; ch < c_end; ++ch) {
    const int f0 = ch * FC;
    __syncthreads();
    load_weights(W1s, W2s, w1, w2, F, f0);
    __syncthreads();
    float pre[4][4];
    pre_tile(W1s, Xs, b1 + f0, fl, bl, pre);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float h = fmaxf(pre[i][j], 0.f);
        if (m.use)
          h = keep_bit(m, base[j], f0 + fl + i, lay.fstride) ? h * m.scale
                                                             : 0.f;
        Hs[(fl + i) * BN + bl + j] = h;
      }
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < FC; ++f) {
      const float4 h = *reinterpret_cast<const float4*>(Hs + f * BN + bl);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float w = W2s[(dl + i) * FC + f];
        acc[i][0] = fmaf(w, h.x, acc[i][0]);
        acc[i][1] = fmaf(w, h.y, acc[i][1]);
        acc[i][2] = fmaf(w, h.z, acc[i][2]);
        acc[i][3] = fmaf(w, h.w, acc[i][3]);
      }
    }
  }
  const bool whole = gridDim.y == 1;
  float* dst = out + static_cast<size_t>(blockIdx.y) * lay.cols() * D;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float bias = whole ? __ldg(b2 + dl + i) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col[j] >= 0) dst[lay.offset(dl + i, col[j])] =
          whole ? acc[i][j] + bias : acc[i][j];
  }
}

// ---- The backward: one pass over the hidden, 3xTF32 on mma.sync ----

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
      for (int ni = 0; ni < NT; ++ni) {
        mma(s[mi][ni], al[mi], bh[ni]);
        mma(s[mi][ni], ah[mi], bl[ni]);
        mma(s[mi][ni], ah[mi], bh[ni]);
      }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mi][ni][e] += s[mi][ni][e];
}

constexpr int HCH = 4;      // hidden chunks a backward block owns
constexpr int SMS = 132;    // H100 SXM
// Shared-memory row strides (floats) that make every fragment read free of
// bank conflicts: lanes read (k = t, n or m = g) of [k][·] arrays at a
// stride ≡ 8 or 24 (mod 32), (m = g, k = t) of [m][·] arrays at ≡ 4.
constexpr int LD_K8 = 72;   // Gs [d][j], W2s [d][f], DP [f][j]
constexpr int LD_T = 56;    // XT, GT [j][d], W1d [f][d]
constexpr int LD_HD = 68;   // HD [f][j]
// Per hidden chunk of a block: its dW1 (FC, D), dW2ᵀ (FC, D) and db1 (FC)
// sums over the block's column tiles, the first two in the order of the
// accumulator fragments (entry (((warp & 3)·6 + mi·3 + ni)·4 + e)·32 +
// lane), so that each thread adds to its own conflict-free words.
constexpr int SUM_PER = 2 * FC * D + FC;
constexpr size_t BWD_SMEM =
    (D * BN + BN * LD_T + D * LD_K8 + BN * LD_T + FC * D + FC * LD_T +
     D * LD_K8 + FC * LD_K8 + FC * LD_HD + HCH * SUM_PER) * 4;

// DP holds dh, then dpre, at [f][j]; j's bit 2 is flipped on rows with
// f's bit 2 set, so that both the k = f reads of dx and the m = f reads of
// dW1 are conflict-free.
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

// W1s[f][k] (pre_tile's layout), W1d[f][k] and W2s[d][f] from fetch_weights.
__device__ __forceinline__ void stage_weights(const float4 (&w)[2 * W4],
                                              float* W1s, float* W1d,
                                              float* W2s) {
#pragma unroll
  for (int r = 0; r < W4; ++r) {
    const int q = threadIdx.x + r * NT;
    *reinterpret_cast<float4*>(W1s + 4 * q) = w[r];
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
// hidden chunks of hg.  Per (tile, chunk):
//   1. dh = W2ᵀ·g on the tensor cores; pre = W1·x + b1 by pre_tile, the
//      forward's own arithmetic, so the gate is the forward's bit for bit;
//   2. dpre = gate · mask · dh and hd = relu(pre) · mask on CUDA cores,
//      db1 summed over the tile's columns;
//   3. dx += W1ᵀ·dpre (registers, over the chunks), then dW1 = dpre·xᵀ
//      (warps 0-3) and dW2ᵀ = hd·gᵀ (warps 4-7) over the tile's columns,
//      added to the chunk's sums in shared memory.
// Each hidden element is formed once.  One block an SM (BWD_SMEM); a step
// is limited by shared-memory bandwidth (pre_tile's reads most) and by
// instruction throughput.  dx goes out as one partial per hidden group
// (laid out like x), the weight gradients as one partial per column group
// (wpart_floats); ff_bwd_reduce_kernel adds them in order.
template <class L>
__global__ void __launch_bounds__(NT, 1)
ff_bwd_kernel(L lay, const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ g, float* __restrict__ dx_parts,
              float* __restrict__ w_parts, int F, Mask m) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // D x BN (pre_tile)
  float* XT = Xs + D * BN;                      // BN x LD_T
  float* Gs = XT + BN * LD_T;                   // D x LD_K8
  float* GT = Gs + D * LD_K8;                   // BN x LD_T
  float* W1s = GT + BN * LD_T;                  // FC x D (pre_tile)
  float* W1d = W1s + FC * D;                    // FC x LD_T
  float* W2s = W1d + FC * LD_T;                 // D x LD_K8
  float* DP = W2s + D * LD_K8;                  // FC x LD_K8, dp_at
  float* HD = DP + FC * LD_K8;                  // FC x LD_HD
  float* sums = HD + FC * LD_HD;                // HCH x SUM_PER
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int bl = (tid % 16) * 4, fl = (tid / 16) * 4;
  const int T = lay.tiles(), cg = blockIdx.x, hg = blockIdx.y;
  const int t_begin =
      static_cast<int>(static_cast<long long>(T) * cg / gridDim.x);
  const int t_end =
      static_cast<int>(static_cast<long long>(T) * (cg + 1) / gridDim.x);
  const int c_begin = hg * HCH;
  const int nc = min(F / FC - c_begin, HCH);
  // the warp's tiles: dh m-tile mt (16 hidden rows) and n-tiles nh..
  // (columns); dx m-tile mt (16 columns) and n-tiles nw.. (features); dW
  // m-tiles from row mw (32 hidden rows) and n-tiles nw..
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
    load_tile(lay, Xs, XT, x, t, BN, LD_T);
    load_tile(lay, Gs, GT, g, t, LD_K8, LD_T);
    __syncthreads();
    if (hg == 0 && tid < 4 * D) {  // db2: 4 threads a feature, then a tree
      float s = 0.f;
      for (int j = (tid & 3) * 16; j < (tid & 3) * 16 + 16; ++j)
        s += Gs[(tid >> 2) * LD_K8 + j];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      db2 += s + __shfl_xor_sync(0xffffffffu, s, 2);
    }
    int col[4];
    uint32_t base[4];
    thread_cols(lay, m, t, bl, col, base);
    float cdx[1][3][4] = {};
    for (int c = 0; c < nc; ++c) {
      const int f0 = (c_begin + c) * FC;
      float* csum = sums + c * SUM_PER;
      __syncthreads();
      stage_weights(wnext, W1s, W1d, W2s);
      __syncthreads();
      fetch_weights(wnext, w1, w2, F, (c_begin + (c + 1) % nc) * FC);
      // 1. dh = W2ᵀ·g into DP (tensor cores) and pre (CUDA cores, bound by
      // shared memory): the two warps of each SM sub-partition take them in
      // opposite orders, so that one's products overlap the other's pre
      float pre[4][4];
      const bool pre_first = (warp >> 2) & 1;
      if (pre_first) pre_tile(W1s, Xs, b1 + f0, fl, bl, pre);
      {
        float ch[1][4][4] = {};
        mma3<1, 4, D / 8>(
            ch, [&](int, int r, int k) { return W2s[k * LD_K8 + mt * 16 + r]; },
            [&](int ni, int k, int n) {
              return Gs[k * LD_K8 + (nh + ni) * 8 + n];
            });
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = mt * 16 + gq + 8 * h, j = (nh + ni) * 8 + 2 * tq;
            *reinterpret_cast<float2*>(DP + dp_at(f, j)) =
                make_float2(ch[0][ni][2 * h], ch[0][ni][2 * h + 1]);
          }
      }
      if (!pre_first) pre_tile(W1s, Xs, b1 + f0, fl, bl, pre);
      __syncthreads();
      // 2. dpre and the dropped hidden, the forward's gate and mask
      float db1p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = fl + i;
        const float4 dh4 = *reinterpret_cast<const float4*>(DP + dp_at(f, bl));
        const float dh[4] = {dh4.x, dh4.y, dh4.z, dh4.w};
        float dp[4], hd[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool keep =
              m.use ? keep_bit(m, base[j], f0 + f, lay.fstride) : true;
          float h = fmaxf(pre[i][j], 0.f);
          if (m.use) h = keep ? h * m.scale : 0.f;
          dp[j] = dpre_of(m, pre[i][j], dh[j], keep);
          hd[j] = h;
          if (col[j] < 0) dp[j] = hd[j] = 0.f;
        }
        *reinterpret_cast<float4*>(DP + dp_at(f, bl)) =
            make_float4(dp[0], dp[1], dp[2], dp[3]);
        *reinterpret_cast<float4*>(HD + f * LD_HD + bl) =
            make_float4(hd[0], hd[1], hd[2], hd[3]);
        db1p[i] = ((dp[0] + dp[1]) + dp[2]) + dp[3];
      }
      // db1 over the tile: the 16 threads of a hidden row, a fixed tree
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          db1p[i] += __shfl_xor_sync(0xffffffffu, db1p[i], off);
      if ((tid & 15) == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i) csum[2 * FC * D + fl + i] += db1p[i];
      __syncthreads();
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

// The forward's split sum: y[i] = (sum over s = 0..S-1, in order, of
// parts[s][i]) + b2[i % D], for the n = cols·D entries of a rows-layout
// tensor.
template <class L>
__global__ void ff_fwd_sum_kernel(const float* __restrict__ parts, int S,
                                  long long n, const float* __restrict__ b2,
                                  float* __restrict__ y) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += parts[s * n + i];
  y[i] = acc + __ldg(b2 + i % D);
}

constexpr size_t FWD_SMEM = (D * BN + FC * D + D * FC + FC * BN) * 4;

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

// Host side: y = FF(x), launched on `st`.  With splits > 1 the partials go
// to `parts` (splits · cols · D floats) and ff_fwd_sum_kernel adds them;
// that sum indexes features as i % D, so splits > 1 needs a layout whose
// offset(k, c) is c·D + k.
template <class L>
cudaError_t forward(const L& lay, const float* x, const float* w1,
                    const float* b1, const float* w2, const float* b2,
                    float* y, float* parts, int splits, int F, Mask m,
                    cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ff_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(FWD_SMEM));
  if (err != cudaSuccess) return err;
  ff_fwd_kernel<L><<<dim3(lay.tiles(), splits), NT, FWD_SMEM, st>>>(
      lay, x, w1, b1, w2, b2, splits == 1 ? y : parts, F, m);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(lay.cols()) * D;
  ff_fwd_sum_kernel<L><<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0,
                         st>>>(parts, splits, n, b2, y);
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
  // fetch_weights reads W1 and W2 as float4
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) &
      15)
    return cudaErrorInvalidValue;
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
