// K3c / K3d: the lanes-layout fused feed-forward with counter-hash dropout,
// forward and recompute backward.
//
// Replaces the TPU kernels of dragposer_tpu/ops/ff_fused.py:
//   K3c  _fwd_kernel_T (pallas_call in _fwd_call_T, public ff_dropout_lanes)
//   K3d  _bwd_kernel_T (pallas_call in _bwd_call_T)
// y = W2 · drop(relu(W1 · x + b1)) + b2 on x of shape (S, D, B), batch in
// the minor axis, with W1 (F, D) and W2 (D, F) as stored in the parameter
// tree.  The backward recomputes the hidden and returns dx, dW1, db1, dW2,
// db2.
//
// What bounds it on the H100: arithmetic.  Each of the S·B columns costs
// 2·D·F·2 FLOP forward (3.02 GFLOP at S = 15, B = 512, F = 2048), the
// backward five products of that size; the bytes (x, g, y, dx and the
// ~0.8 MB of weights) are two orders of magnitude below the float32 bound.
// The (S·B, 2048) hidden would be 63 MB at B = 512 and is never stored.
//
// What the design does about it:
// * a block owns BN = 64 columns of one token s; the hidden is produced in
//   chunks of FC = 64 rows in shared memory and consumed at once, so no
//   hidden value and no mask bit reaches device memory;
// * register tiles of 4×4 (hidden) and 3×4 (outputs) per thread, operands
//   from shared memory as float4 where they are contiguous;
// * the dropout mask is the JAX package's own hash, computed per element
//   from (seed, token s, hidden row f, lane b) with the TPU tiling's
//   indices (tile = min(256, max(128, B))), so it matches JAX bit for bit
//   whatever this kernel's own tiling is;
// * every pre-activation is the same fmaf chain over k = 0..D-1 followed by
//   "+ b1" (pre_tile), in the forward and in both backward kernels, so the
//   ReLU gate of the backward equals the forward's bit for bit;
// * the weight gradients sum over all S·B columns.  The TPU carried those
//   sums across its sequential grid; here kernel ff_bwd_dw_kernel owns 64
//   hidden rows and 1/P of the column tiles, writes its partial sums to a
//   workspace, and ff_bwd_reduce_kernel adds the P partials in a fixed
//   order: deterministic, no atomics.
// Float32 on CUDA cores (the TPU kernel ran bf16 operands by default);
// tensor cores are later work.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 48;     // d_model
constexpr int BN = 64;    // columns (lanes of one token) per block
constexpr int FC = 64;    // hidden rows per chunk
constexpr int NT = 256;   // threads per block
constexpr int TILE_B = 256;

struct Mask {
  uint32_t seedmix;  // seed · 0x9E3779B1 mod 2^32
  uint32_t thresh;   // keep iff hash >= thresh
  float scale;       // float32(1 / (1 - rate))
  int use;           // rate > 0
  int tile;          // the TPU kernel's lane tile
  int nb;            // lane tiles per token
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// ops/ff_fused.py:_keep_mask_T for element (token s, hidden row f, lane b).
__device__ __forceinline__ bool keep_bit(const Mask& m, int s, int f, int b) {
  const uint32_t tile_id = static_cast<uint32_t>(s * m.nb + b / m.tile);
  const uint32_t pos = static_cast<uint32_t>(f * m.tile + b % m.tile);
  return fmix32(pos + m.seedmix + tile_id * 0x7FEB352Du) >= m.thresh;
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

// Xs[k][j] = src[k][b0 + j] of one token's (D, B) plane, 0 beyond B.
__device__ __forceinline__ void load_cols(float* Xs, const float* src, int B,
                                          int b0) {
  for (int idx = threadIdx.x; idx < D * BN; idx += NT) {
    const int k = idx / BN, b = b0 + idx % BN;
    Xs[idx] = b < B ? src[static_cast<size_t>(k) * B + b] : 0.f;
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

// K3c.  grid (ceil(B / BN), S).
__global__ void __launch_bounds__(NT)
ff_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, float* __restrict__ y, int B,
              int F, Mask m) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // D x BN
  float* W1s = Xs + D * BN;                     // FC x D
  float* W2s = W1s + FC * D;                    // D x FC
  float* Hs = W2s + D * FC;                     // FC x BN
  const int s = blockIdx.y, b0 = blockIdx.x * BN, tid = threadIdx.x;
  const int bl = (tid % 16) * 4, fl = (tid / 16) * 4, dl = (tid / 16) * 3;
  load_cols(Xs, x + static_cast<size_t>(s) * D * B, B, b0);
  float acc[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int f0 = 0; f0 < F; f0 += FC) {
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
        if (m.use) h = keep_bit(m, s, f0 + fl + i, b0 + bl + j) ? h * m.scale
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float bias = __ldg(b2 + dl + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + bl + j;
      if (b < B) y[(static_cast<size_t>(s) * D + dl + i) * B + b] =
          acc[i][j] + bias;
    }
  }
}

// dpre for one element: the forward's gate and mask replayed.
__device__ __forceinline__ float dpre_of(const Mask& m, float pre, float dhd,
                                         bool keep) {
  if (!(pre > 0.f)) return 0.f;
  if (!m.use) return dhd;
  return keep ? dhd * m.scale : 0.f;
}

// K3d, part 1: dx = W1ᵀ dpre.  grid (ceil(B / BN), S).
__global__ void __launch_bounds__(NT)
ff_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ g, float* __restrict__ dx, int B,
                 int F, Mask m) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // D x BN
  float* Gs = Xs + D * BN;                      // D x BN
  float* W1s = Gs + D * BN;                     // FC x D
  float* W2s = W1s + FC * D;                    // D x FC
  float* DP = W2s + D * FC;                     // FC x BN
  const int s = blockIdx.y, b0 = blockIdx.x * BN, tid = threadIdx.x;
  const int bl = (tid % 16) * 4, fl = (tid / 16) * 4, dl = (tid / 16) * 3;
  load_cols(Xs, x + static_cast<size_t>(s) * D * B, B, b0);
  load_cols(Gs, g + static_cast<size_t>(s) * D * B, B, b0);
  float acc[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int f0 = 0; f0 < F; f0 += FC) {
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
            m.use ? keep_bit(m, s, f0 + fl + i, b0 + bl + j) : true;
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
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + bl + j;
      if (b < B) dx[(static_cast<size_t>(s) * D + dl + i) * B + b] = acc[i][j];
    }
}

// K3d, part 2: partial dW1, dW2, db1 of 64 hidden rows over 1/P of the
// column tiles.  grid (F / FC, P).  Workspace per partial p:
// [dW1 (F, D) | dW2 (D, F) | db1 (F)].
__global__ void __launch_bounds__(NT)
ff_bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ g, float* __restrict__ ws, int S,
                 int B, int F, Mask m) {
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
  const int nbt = (B + BN - 1) / BN;
  const int T = S * nbt;
  const int t_begin = static_cast<int>(static_cast<long long>(T) * p / P);
  const int t_end = static_cast<int>(static_cast<long long>(T) * (p + 1) / P);
  // pre / dhd tile: rows fl.., lanes bl..;  reduction tiles: 4 hidden rows
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
    const int s = t / nbt, b0 = (t % nbt) * BN;
    __syncthreads();
    const float* xs = x + static_cast<size_t>(s) * D * B;
    const float* gs = g + static_cast<size_t>(s) * D * B;
    for (int idx = tid; idx < D * BN; idx += NT) {
      const int k = idx / BN, j = idx % BN, b = b0 + j;
      const float xv = b < B ? xs[static_cast<size_t>(k) * B + b] : 0.f;
      const float gv = b < B ? gs[static_cast<size_t>(k) * B + b] : 0.f;
      Xs[idx] = xv;
      Gs[idx] = gv;
      XsT[j * D + k] = xv;
      GsT[j * D + k] = gv;
    }
    __syncthreads();
    float pre[4][4], dhd[4][4];
    pre_tile(W1s, Xs, b1 + f0, fl, bl, pre);
    w2t_g_tile(W2s, Gs, fl, bl, dhd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = b0 + bl + j;
        const bool keep = m.use ? keep_bit(m, s, f0 + fl + i, b) : true;
        float h = fmaxf(pre[i][j], 0.f);
        if (m.use) h = keep ? h * m.scale : 0.f;
        float dp = dpre_of(m, pre[i][j], dhd[i][j], keep);
        if (b >= B) h = dp = 0.f;
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

// K3d, part 3: the weight gradients as the P partials summed in order.
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

// K3d, part 4: db2[d] = sum of g[s, d, b] over all columns, a fixed-order
// tree in one block per d.
__global__ void __launch_bounds__(NT)
ff_bwd_db2_kernel(const float* __restrict__ g, int S, int B,
                  float* __restrict__ db2) {
  __shared__ float part[NT];
  const int d = blockIdx.x;
  const long long n = static_cast<long long>(S) * B;
  float acc = 0.f;
  for (long long c = threadIdx.x; c < n; c += NT) {
    const long long s = c / B, b = c % B;
    acc += g[(s * D + d) * B + b];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) db2[d] = part[0];
}

Mask make_mask(int B, unsigned seedmix, unsigned thresh, float scale,
               int use) {
  Mask m;
  m.seedmix = seedmix;
  m.thresh = thresh;
  m.scale = scale;
  m.use = use;
  m.tile = B < 128 ? 128 : (B > TILE_B ? TILE_B : B);
  m.nb = (B + m.tile - 1) / m.tile;
  return m;
}

constexpr size_t FWD_SMEM = (D * BN + FC * D + D * FC + FC * BN) * 4;
constexpr size_t DX_SMEM = (2 * D * BN + FC * D + D * FC + FC * BN) * 4;
constexpr size_t DW_SMEM =
    (2 * D * BN + 2 * BN * D + FC * D + D * FC + 2 * BN * FC) * 4;

bool bad_shape(int S, int B, int F) {
  return S < 1 || B < 1 || F < FC || F % FC != 0;
}

}  // namespace

// x, y (S, 48, B); w1 (F, 48); b1 (F); w2 (48, F); b2 (48); float32,
// contiguous.  F a multiple of 64.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ff_lanes_forward(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* y,
                                int S, int B, int F, unsigned seedmix,
                                unsigned thresh, float scale, int use_mask,
                                void* stream) {
  if (bad_shape(S, B, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ff_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(FWD_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mask m = make_mask(B, seedmix, thresh, scale, use_mask);
  dim3 grid((B + BN - 1) / BN, S);
  ff_fwd_kernel<<<grid, NT, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), B, F, m);
  return static_cast<int>(cudaGetLastError());
}

// Floats of workspace ff_lanes_backward needs for P partials.
extern "C" long long ff_lanes_workspace_floats(int P, int F) {
  return static_cast<long long>(P) * (2LL * F * D + F);
}

// Column tiles of the weight-gradient pass (P <= this).
extern "C" int ff_lanes_column_tiles(int S, int B) {
  return S * ((B + BN - 1) / BN);
}

// g, dx like x; dw1 like w1; db1 (F); dw2 like w2; db2 (48); ws of
// ff_lanes_workspace_floats(P, F) floats, 1 <= P <= ff_lanes_column_tiles.
extern "C" int ff_lanes_backward(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* g, void* dx,
                                 void* dw1, void* db1, void* dw2, void* db2,
                                 void* ws, int P, int S, int B, int F,
                                 unsigned seedmix, unsigned thresh,
                                 float scale, int use_mask, void* stream) {
  if (bad_shape(S, B, F) || P < 1 || P > S * ((B + BN - 1) / BN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ff_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DX_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ff_bwd_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DW_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mask m = make_mask(B, seedmix, thresh, scale, use_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* gf = static_cast<const float*>(g);
  ff_bwd_dx_kernel<<<dim3((B + BN - 1) / BN, S), NT, DX_SMEM, st>>>(
      xf, w1f, b1f, w2f, gf, static_cast<float*>(dx), B, F, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ff_bwd_dw_kernel<<<dim3(F / FC, P), NT, DW_SMEM, st>>>(
      xf, w1f, b1f, w2f, gf, static_cast<float*>(ws), S, B, F, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = 2 * F * D + F;
  ff_bwd_reduce_kernel<<<(per + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(ws), P, F, static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(db1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ff_bwd_db2_kernel<<<D, NT, 0, st>>>(gf, S, B, static_cast<float*>(db2));
  return static_cast<int>(cudaGetLastError());
}
