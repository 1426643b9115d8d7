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
// * a block owns BN = 64 columns; the hidden is produced in chunks of
//   FC = 64 rows in shared memory and consumed at once, so no hidden value
//   and no mask bit reaches device memory.  A launch may split the hidden
//   chunks over gridDim.y (partial sums, then a fixed-order sum) to put
//   enough blocks in flight when there are few column tiles;
// * register tiles of 4×4 (hidden) and 3×4 (outputs) per thread, operands
//   from shared memory as float4 where they are contiguous;
// * every pre-activation is the same fmaf chain over k = 0..D-1 followed by
//   "+ b1" (pre_tile), in the forward and in both backward kernels, so the
//   ReLU gate of the backward equals the forward's bit for bit;
// * the weight gradients sum over all columns.  The TPU carried those sums
//   across its sequential grid; here ff_bwd_dw_kernel owns 64 hidden rows
//   and 1/P of the column tiles, writes its partial sums to a workspace,
//   and ff_bwd_reduce_kernel adds the P partials in a fixed order:
//   deterministic, no atomics.
// Float32 on CUDA cores (the TPU kernels ran bf16 operands by default);
// tensor cores are later work.
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

// dhd[i][j] = sum over d of W2s[d][fl+i] · Gs[d][bl+j]  (W2ᵀ g)
__device__ __forceinline__ void w2t_g_tile(const float* W2s, const float* Gs,
                                           int fl, int bl, float out[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 g = *reinterpret_cast<const float4*>(Gs + d * BN + bl);
    const float4 w = *reinterpret_cast<const float4*>(W2s + d * FC + fl);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i][0] = fmaf(wv[i], g.x, out[i][0]);
      out[i][1] = fmaf(wv[i], g.y, out[i][1]);
      out[i][2] = fmaf(wv[i], g.z, out[i][2]);
      out[i][3] = fmaf(wv[i], g.w, out[i][3]);
    }
  }
}

// Where tile t lies: feature k of slot j < n at first + k·kstride +
// j·jstride.
struct TileView {
  size_t first;
  int kstride, jstride, n;
};

// Xs[k][j] = feature k of slot j of tile t, 0 past the end; XsT[j][k] the
// same values transposed, when given.
template <class L>
__device__ __forceinline__ void load_tile(const L& lay, float* Xs, float* XsT,
                                          const float* __restrict__ src,
                                          int t) {
  const TileView v = lay.tile_view(t);
  for (int idx = threadIdx.x; idx < D * BN; idx += NT) {
    const int k = L::kMinor ? idx % D : idx / BN;
    const int j = L::kMinor ? idx / D : idx % BN;
    const float val =
        j < v.n ? src[v.first + k * v.kstride + j * v.jstride] : 0.f;
    Xs[k * BN + j] = val;
    if (XsT != nullptr) XsT[j * D + k] = val;
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

// The backward, part 1: dx = W1ᵀ dpre.  grid (lay.tiles(), splits), the
// splits as in ff_fwd_kernel.
template <class L>
__global__ void __launch_bounds__(NT)
ff_bwd_dx_kernel(L lay, const float* __restrict__ x, const float* __restrict__ w1,
          const float* __restrict__ b1, const float* __restrict__ w2,
          const float* __restrict__ g, float* __restrict__ out, int F,
          Mask m) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // D x BN
  float* Gs = Xs + D * BN;                      // D x BN
  float* W1s = Gs + D * BN;                     // FC x D
  float* W2s = W1s + FC * D;                    // D x FC
  float* DP = W2s + D * FC;                     // FC x BN
  const int t = blockIdx.x, tid = threadIdx.x;
  const int bl = (tid % 16) * 4, fl = (tid / 16) * 4, dl = (tid / 16) * 3;
  load_tile(lay, Xs, nullptr, x, t);
  load_tile(lay, Gs, nullptr, g, t);
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
    float pre[4][4], dhd[4][4];
    pre_tile(W1s, Xs, b1 + f0, fl, bl, pre);
    w2t_g_tile(W2s, Gs, fl, bl, dhd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep =
            m.use ? keep_bit(m, base[j], f0 + fl + i, lay.fstride) : true;
        DP[(fl + i) * BN + bl + j] = dpre_of(m, pre[i][j], dhd[i][j], keep);
      }
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < FC; ++f) {
      const float4 dp = *reinterpret_cast<const float4*>(DP + f * BN + bl);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float w = W1s[f * D + dl + i];
        acc[i][0] = fmaf(w, dp.x, acc[i][0]);
        acc[i][1] = fmaf(w, dp.y, acc[i][1]);
        acc[i][2] = fmaf(w, dp.z, acc[i][2]);
        acc[i][3] = fmaf(w, dp.w, acc[i][3]);
      }
    }
  }
  float* dst = out + static_cast<size_t>(blockIdx.y) * lay.cols() * D;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col[j] >= 0) dst[lay.offset(dl + i, col[j])] = acc[i][j];
}

// The backward, part 2: partial dW1, dW2, db1 of 64 hidden rows over 1/P of
// the column tiles.  grid (F / FC, P).  Workspace per partial p:
// [dW1 (F, D) | dW2 (D, F) | db1 (F)].
template <class L>
__global__ void __launch_bounds__(NT)
ff_bwd_dw_kernel(L lay, const float* __restrict__ x, const float* __restrict__ w1,
          const float* __restrict__ b1, const float* __restrict__ w2,
          const float* __restrict__ g, float* __restrict__ ws, int F,
          Mask m) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // D x BN
  float* Gs = Xs + D * BN;                      // D x BN
  float* XsT = Gs + D * BN;                     // BN x D
  float* GsT = XsT + BN * D;                    // BN x D
  float* W1s = GsT + BN * D;                    // FC x D
  float* W2s = W1s + FC * D;                    // D x FC
  float* HDt = W2s + D * FC;                    // BN x FC  dropped hidden
  float* DPt = HDt + BN * FC;                   // BN x FC  dpre
  const int f0 = blockIdx.x * FC, p = blockIdx.y, P = gridDim.y;
  const int tid = threadIdx.x;
  const int T = lay.tiles();
  const int t_begin = static_cast<int>(static_cast<long long>(T) * p / P);
  const int t_end = static_cast<int>(static_cast<long long>(T) * (p + 1) / P);
  // pre / dhd tile: rows fl.., columns bl..;  reduction tiles: 4 hidden rows
  // (fa..) by 3 of D (kb..)
  const int bl = (tid % 16) * 4, fl = (tid / 16) * 4;
  const int fa = (tid / 16) * 4, kb = (tid % 16) * 3;
  load_weights(W1s, W2s, w1, w2, F, f0);
  float dw1[4][3], dw2[3][4], db1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db1[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) dw1[i][j] = dw2[j][i] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();
    load_tile(lay, Xs, XsT, x, t);
    load_tile(lay, Gs, GsT, g, t);
    int col[4];
    uint32_t base[4];
    thread_cols(lay, m, t, bl, col, base);
    __syncthreads();
    float pre[4][4], dhd[4][4];
    pre_tile(W1s, Xs, b1 + f0, fl, bl, pre);
    w2t_g_tile(W2s, Gs, fl, bl, dhd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep =
            m.use ? keep_bit(m, base[j], f0 + fl + i, lay.fstride) : true;
        float h = fmaxf(pre[i][j], 0.f);
        if (m.use) h = keep ? h * m.scale : 0.f;
        float dp = dpre_of(m, pre[i][j], dhd[i][j], keep);
        if (col[j] < 0) h = dp = 0.f;
        HDt[(bl + j) * FC + fl + i] = h;
        DPt[(bl + j) * FC + fl + i] = dp;
      }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      const float4 dp = *reinterpret_cast<const float4*>(DPt + j * FC + fa);
      const float4 hd = *reinterpret_cast<const float4*>(HDt + j * FC + fa);
      const float dpv[4] = {dp.x, dp.y, dp.z, dp.w};
      const float hdv[4] = {hd.x, hd.y, hd.z, hd.w};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xv = XsT[j * D + kb + c];
        const float gv = GsT[j * D + kb + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dw1[i][c] = fmaf(dpv[i], xv, dw1[i][c]);
          dw2[c][i] = fmaf(gv, hdv[i], dw2[c][i]);
        }
      }
      if (kb == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) db1[i] += dpv[i];
      }
    }
  }
  float* part = ws + static_cast<size_t>(p) * (2 * F * D + F);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      part[static_cast<size_t>(f0 + fa + i) * D + kb + c] = dw1[i][c];
      part[static_cast<size_t>(F) * D + static_cast<size_t>(kb + c) * F +
           f0 + fa + i] = dw2[c][i];
    }
    if (kb == 0) part[2 * F * D + f0 + fa + i] = db1[i];
  }
}

// The backward, part 3: the weight gradients as the P partials summed in
// order.
template <class L>
__global__ void ff_bwd_reduce_kernel(const float* __restrict__ ws, int P,
                                     int F, float* __restrict__ dw1,
                                     float* __restrict__ dw2,
                                     float* __restrict__ db1) {
  const int per = 2 * F * D + F;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc += ws[static_cast<size_t>(p) * per + idx];
  if (idx < F * D) dw1[idx] = acc;
  else if (idx < 2 * F * D) dw2[idx - F * D] = acc;
  else db1[idx - 2 * F * D] = acc;
}

// The backward, part 4: db2[d] = sum of feature d of g over all columns, a
// fixed-order tree in one block per d.
template <class L>
__global__ void __launch_bounds__(NT)
ff_bwd_db2_kernel(L lay, const float* __restrict__ g, float* __restrict__ db2) {
  __shared__ float part[NT];
  const int d = blockIdx.x;
  const long long n = lay.cols();
  float acc = 0.f;
  for (long long c = threadIdx.x; c < n; c += NT)
    acc += g[lay.offset(d, static_cast<int>(c))];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) db2[d] = part[0];
}

// out[i] = (sum over s = 0..S-1, in order, of parts[s][i]) + bias[i % D]
// (no bias when null), for the n = cols·D entries of a rows-layout tensor.
__device__ __forceinline__ void sum_splits(const float* __restrict__ parts,
                                           int S, long long n,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += parts[s * n + i];
  out[i] = bias != nullptr ? acc + __ldg(bias + i % D) : acc;
}

// The forward's and dx's split sums, one kernel each so that a profile
// tells them apart.
template <class L>
__global__ void ff_fwd_sum_kernel(const float* __restrict__ parts, int S,
                                  long long n, const float* __restrict__ b2,
                                  float* __restrict__ y) {
  sum_splits(parts, S, n, b2, y);
}

template <class L>
__global__ void ff_bwd_dx_sum_kernel(const float* __restrict__ parts, int S,
                                     long long n, float* __restrict__ dx) {
  sum_splits(parts, S, n, nullptr, dx);
}

constexpr size_t FWD_SMEM = (D * BN + FC * D + D * FC + FC * BN) * 4;
constexpr size_t DX_SMEM = (2 * D * BN + FC * D + D * FC + FC * BN) * 4;
constexpr size_t DW_SMEM =
    (2 * D * BN + 2 * BN * D + FC * D + D * FC + 2 * BN * FC) * 4;

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

// Host side: (dx, dW1, db1, dW2, db2) of FF at x for output gradient g.
// ws holds P · (2·F·D + F) floats of weight-gradient partials, followed
// (splits > 1) by splits · cols · D floats of dx partials.
template <class L>
cudaError_t backward(const L& lay, const float* x, const float* w1,
                     const float* b1, const float* w2, const float* g,
                     float* dx, float* dw1, float* db1, float* dw2,
                     float* db2, float* ws, int P, int splits, int F, Mask m,
                     cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ff_bwd_dx_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DX_SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ff_bwd_dw_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DW_SMEM));
  if (err != cudaSuccess) return err;
  const int per = 2 * F * D + F;
  float* dx_parts = ws + static_cast<size_t>(P) * per;
  ff_bwd_dx_kernel<L><<<dim3(lay.tiles(), splits), NT, DX_SMEM, st>>>(
      lay, x, w1, b1, w2, g, splits == 1 ? dx : dx_parts, F, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n = static_cast<long long>(lay.cols()) * D;
    ff_bwd_dx_sum_kernel<L><<<static_cast<unsigned>((n + NT - 1) / NT), NT,
                              0, st>>>(dx_parts, splits, n, dx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ff_bwd_dw_kernel<L><<<dim3(F / FC, P), NT, DW_SMEM, st>>>(lay, x, w1, b1,
                                                             w2, g, ws, F, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff_bwd_reduce_kernel<L><<<(per + NT - 1) / NT, NT, 0, st>>>(ws, P, F,
                                                           dw1, dw2, db1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff_bwd_db2_kernel<L><<<D, NT, 0, st>>>(lay, g, db2);
  return cudaGetLastError();
}

}  // namespace ff
