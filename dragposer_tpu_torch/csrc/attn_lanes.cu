// K4a / K4b: the lanes-layout attention core, forward and recompute
// backward.
//
// Replaces the TPU kernels of dragposer_tpu/ops/attn_fused.py:
//   K4a  _fwd_kernel (pallas_call in _fwd_call, public attn_core_lanes)
//   K4b  _bwd_kernel (pallas_call in _bwd_call)
// o = softmax(q·kᵀ/√dh + mask)·v per head and lane on q (Sq, h, dh, B) and
// k, v (Sk, h, dh, B), batch in the minor axis, with an additive (Sq, Sk)
// mask; the backward recomputes the scores and returns dq, dk, dv.
//
// What bounds it on the H100: bytes.  Per lane and head at 15 × 15 the
// forward is ~11 kFLOP against ~2.9 kB of q, k, v and o, far below the
// card's ~20 FLOP per byte.  At the training batch (B = 512) the whole call
// moves ~1.5 MB, about half a microsecond of HBM time, so launch latency
// dominates; that is left for later (a CUDA graph over the step).
//
// What the design does about it: every operand is read from device memory
// in its own layout, consecutive threads on consecutive lanes (coalesced),
// and written once; the (Sq, Sk) score block of a lane never leaves the
// chip.  S ≤ 16 and dh = 12, so a query row's scores live in registers and
// no online softmax is needed; the softmax subtracts the row maximum, so
// the causal mask's -inf entries give exact zeros.
// * forward: one thread per (query i, head, lane);
// * backward: a block owns one head and 32 lanes.  Phase 1, one thread per
//   (query i, lane): recompute the row's probabilities a, walk the softmax
//   VJP (da = g·v, ds = a ⊙ (da − Σ a·da)/√dh), write dq, and keep a and ds
//   in shared memory.  Phase 2, one thread per (key k, lane): dk = Σ_i ds·q
//   and dv = Σ_i a·g.  dk and dv belong to one lane, so no sum crosses
//   blocks and the result is deterministic.
// Float32 on CUDA cores.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 12;     // head width
constexpr int SMAX = 16;   // longest sequence the kernels take
constexpr int FWD_NT = 128;
constexpr int LB = 32;     // lanes per backward block
constexpr int BWD_NT = LB * SMAX;

// Row i of one (head, lane): a[kk] = softmax_kk(q_i·k_kk · scale + mask).
// Strides: token `ts`, head offset `hoff`, dh `B` (all in floats).
__device__ __forceinline__ void row_probs(const float* qi,
                                          const float* __restrict__ k,
                                          const float* __restrict__ mask_row,
                                          int sk, size_t ts, size_t hoff,
                                          int B, float scale,
                                          float a[SMAX]) {
  float mx = -INFINITY;
#pragma unroll
  for (int kk = 0; kk < SMAX; ++kk) {
    if (kk < sk) {
      const float* kr = k + kk * ts + hoff;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qi[d], __ldg(kr + d * B), dot);
      const float s = dot * scale + __ldg(mask_row + kk);
      a[kk] = s;
      mx = fmaxf(mx, s);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int kk = 0; kk < SMAX; ++kk) {
    if (kk < sk) {
      a[kk] = expf(a[kk] - mx);
      sum += a[kk];
    }
  }
#pragma unroll
  for (int kk = 0; kk < SMAX; ++kk)
    if (kk < sk) a[kk] = a[kk] / sum;
}

// K4a.  grid (ceil(B / FWD_NT), Sq · h).
__global__ void __launch_bounds__(FWD_NT)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                float* __restrict__ o, int sk, int h, int B, float scale) {
  const int b = blockIdx.x * FWD_NT + threadIdx.x;
  if (b >= B) return;
  const int i = blockIdx.y / h, hh = blockIdx.y % h;
  const size_t ts = static_cast<size_t>(h) * DH * B;   // token stride
  const size_t hoff = static_cast<size_t>(hh) * DH * B + b;
  float qi[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qi[d] = __ldg(q + i * ts + hoff + d * B);
  float a[SMAX];
  row_probs(qi, k, mask + i * sk, sk, ts, hoff, B, scale, a);
  float out[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) out[d] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SMAX; ++kk) {
    if (kk < sk) {
      const float* vr = v + kk * ts + hoff;
#pragma unroll
      for (int d = 0; d < DH; ++d) out[d] = fmaf(a[kk], __ldg(vr + d * B),
                                                 out[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) o[i * ts + hoff + d * B] = out[d];
}

// K4b.  grid (ceil(B / LB), h), LB · SMAX threads; dynamic shared memory
// 2 · sq · sk · LB floats.
__global__ void __launch_bounds__(BWD_NT)
attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                const float* __restrict__ g, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv, int sq,
                int sk, int h, int B, float scale) {
  extern __shared__ float smem[];
  float* A = smem;                    // [sq][sk][LB] probabilities
  float* DS = smem + sq * sk * LB;    // [sq][sk][LB] score gradients
  const int lane = threadIdx.x % LB, row = threadIdx.x / LB;
  const int b = blockIdx.x * LB + lane, hh = blockIdx.y;
  const bool live = b < B;
  const size_t ts = static_cast<size_t>(h) * DH * B;
  const size_t hoff = static_cast<size_t>(hh) * DH * B + b;

  if (live && row < sq) {
    const int i = row;
    float qi[DH], gi[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qi[d] = __ldg(q + i * ts + hoff + d * B);
      gi[d] = __ldg(g + i * ts + hoff + d * B);
    }
    float a[SMAX], da[SMAX];
    row_probs(qi, k, mask + i * sk, sk, ts, hoff, B, scale, a);
    float r = 0.f;
#pragma unroll
    for (int kk = 0; kk < SMAX; ++kk) {
      if (kk < sk) {
        const float* vr = v + kk * ts + hoff;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(gi[d], __ldg(vr + d * B), dot);
        da[kk] = dot;
        r = fmaf(a[kk], dot, r);
      }
    }
    float dqi[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dqi[d] = 0.f;
#pragma unroll
    for (int kk = 0; kk < SMAX; ++kk) {
      if (kk < sk) {
        const float ds = a[kk] * (da[kk] - r) * scale;
        A[(i * sk + kk) * LB + lane] = a[kk];
        DS[(i * sk + kk) * LB + lane] = ds;
        const float* kr = k + kk * ts + hoff;
#pragma unroll
        for (int d = 0; d < DH; ++d) dqi[d] = fmaf(ds, __ldg(kr + d * B),
                                                   dqi[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[i * ts + hoff + d * B] = dqi[d];
  }
  __syncthreads();
  if (live && row < sk) {
    const int kk = row;
    float dki[DH], dvi[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dki[d] = dvi[d] = 0.f;
    for (int i = 0; i < sq; ++i) {
      const float ds = DS[(i * sk + kk) * LB + lane];
      const float a = A[(i * sk + kk) * LB + lane];
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dki[d] = fmaf(ds, __ldg(q + i * ts + hoff + d * B), dki[d]);
        dvi[d] = fmaf(a, __ldg(g + i * ts + hoff + d * B), dvi[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[kk * ts + hoff + d * B] = dki[d];
      dv[kk * ts + hoff + d * B] = dvi[d];
    }
  }
}

bool bad_shape(int sq, int sk, int h, int dh, int B) {
  return sq < 1 || sq > SMAX || sk < 1 || sk > SMAX || h < 1 || dh != DH ||
         B < 1;
}

}  // namespace

// q, o (sq, h, 12, B); k, v (sk, h, 12, B); mask (sq, sk) additive; float32,
// contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int attn_lanes_forward(const void* q, const void* k, const void* v,
                                  const void* mask, void* o, int sq, int sk,
                                  int h, int dh, int B, float scale,
                                  void* stream) {
  if (bad_shape(sq, sk, h, dh, B))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((B + FWD_NT - 1) / FWD_NT, sq * h);
  attn_fwd_kernel<<<grid, FWD_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<float*>(o), sk, h, B, scale);
  return static_cast<int>(cudaGetLastError());
}

// g, dq like q; dk, dv like k.
extern "C" int attn_lanes_backward(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* g, void* dq, void* dk,
                                   void* dv, int sq, int sk, int h, int dh,
                                   int B, float scale, void* stream) {
  if (bad_shape(sq, sk, h, dh, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(sq) * sk * LB * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((B + LB - 1) / LB, h);
  attn_bwd_kernel<<<grid, BWD_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, h, B, scale);
  return static_cast<int>(cudaGetLastError());
}
