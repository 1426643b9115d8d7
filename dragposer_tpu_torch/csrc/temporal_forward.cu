// K2: the temporal-transformer inference forward in one kernel.
//
// Replaces the TPU kernel dragposer_tpu/ops/temporal_fused.py:_kernel
// (pallas_call in _call, public forward): the whole seq2seq forward —
// input projections + positional encoding, 3 post-LN encoder layers, the
// encoder norm, 3 decoder layers (masked self-attention, cross-attention,
// FF 48→2048→48 ReLU), the final LayerNorm and the output projection.
//
// What bounds it on the H100: arithmetic.  Per lane the forward is about
// 19 MFLOP (the FF layers on the 14 encoder tokens are 88% of it) and moves
// only ~2 KB of activations in and 0.1 KB out; the ~5 MB of weights are
// shared by every lane and stay resident in the 50 MB L2.  The float32
// bound at B = 8192 is ~156 GFLOP / 67 TFLOP/s = 2.3 ms.
//
// What the design does about it: a block owns G = 4 lanes; every token
// activation of those lanes lives in shared memory for the whole forward,
// and the (rows, 2048) FF hidden is produced and consumed in chunks of 64
// columns, so no intermediate reaches device memory (the point of the TPU
// kernel, which kept them in VMEM).  Each linear layer is a register tile of
// 8 rows × 1 column per thread: one weight load (coalesced across the
// warp, from L1/L2) feeds 8 FMAs, and the activations are read as float4
// broadcasts from shared memory.  Float32 on CUDA cores; tensor cores are
// later work.  Attention (S ≤ 16, dh = 12) is one thread per (lane, head,
// query) with a max-subtracted softmax.
//
// Weights arrive as a table of 84 device pointers (order fixed by
// dragposer_tpu_torch/ops/temporal_fused.py:_POINTERS), each array in math
// layout (in, out), row-major.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 48;       // d_model
constexpr int H = 4;        // heads
constexpr int DH = D / H;   // 12
constexpr int FF = 2048;
constexpr int D_ENC = 33;   // latent + 3 + 6 heights
constexpr int D_LAT = 24;
constexpr int G = 4;        // lanes per block
constexpr int NT = 256;     // threads per block
constexpr int FC = 64;      // FF hidden columns per chunk
constexpr int RPT = 8;      // rows per thread in a linear tile
constexpr int SMAX = 16;    // longest sequence the kernel takes
constexpr int XLD = 36;     // shared-memory row stride of the encoder input

enum { W_IN_ENC, B_IN_ENC, W_IN_DEC, B_IN_DEC, W_OUT, B_OUT, PE, ENC_NORM,
       DEC_NORM, ENC_BASE };
enum { E_W_IN, E_B_IN, E_W_OUT, E_B_OUT, E_FF_W1, E_FF_B1, E_FF_W2, E_FF_B2,
       E_LN1, E_LN2, ENC_STRIDE };
enum { S_W_IN, S_B_IN, S_W_OUT, S_B_OUT, C_W_IN, C_B_IN, C_W_OUT, C_B_OUT,
       F_W1, F_B1, F_W2, F_B2, D_LN1, D_LN2, D_LN3, DEC_STRIDE };
constexpr int LAYERS = 3;
constexpr int DEC_BASE = ENC_BASE + LAYERS * ENC_STRIDE;
constexpr int N_PTR = DEC_BASE + LAYERS * DEC_STRIDE;   // 84

struct Weights {
  const float* p[N_PTR];
};

// Y[r, o] (= or +=) act(sum_i X[r, i] W[i, o] + b[o]) for r < R, o < out.
// Rows beyond R up to the next multiple of RPT are read (they lie inside
// the buffer) but never written.
__device__ void linear(const float* X, int ldx, int R, int in,
                       const float* __restrict__ W, int ldw,
                       const float* __restrict__ b, int out, float* Y,
                       int ldy, bool relu, bool accumulate) {
  const int ngroups = (R + RPT - 1) / RPT;
  for (int item = threadIdx.x; item < out * ngroups; item += blockDim.x) {
    const int o = item % out;
    const int r0 = (item / out) * RPT;
    float acc[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = 0.f;
    int i = 0;
    for (; i + 4 <= in; i += 4) {
      const float w0 = __ldg(W + (i + 0) * ldw + o);
      const float w1 = __ldg(W + (i + 1) * ldw + o);
      const float w2 = __ldg(W + (i + 2) * ldw + o);
      const float w3 = __ldg(W + (i + 3) * ldw + o);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (r0 + k) * ldx + i);
        acc[k] = fmaf(x.x, w0, acc[k]);
        acc[k] = fmaf(x.y, w1, acc[k]);
        acc[k] = fmaf(x.z, w2, acc[k]);
        acc[k] = fmaf(x.w, w3, acc[k]);
      }
    }
    for (; i < in; ++i) {
      const float wi = __ldg(W + i * ldw + o);
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        acc[k] = fmaf(X[(r0 + k) * ldx + i], wi, acc[k]);
    }
    const float bias = b ? __ldg(b + o) : 0.f;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = r0 + k;
      if (r < R) {
        float v = acc[k] + bias;
        if (relu) v = fmaxf(v, 0.f);
        if (accumulate) Y[r * ldy + o] += v;
        else Y[r * ldy + o] = v;
      }
    }
  }
}

// O[(g, q), h*DH + d] = softmax_k(Q·K / sqrt(DH) + mask) · V for each lane
// g < nl, head h and query q < sq.  mask: additive, (1, sk) or (sq, sk).
__device__ void attention(const float* Q, const float* K, const float* V,
                          int ld, int nl, int sq, int sk,
                          const float* __restrict__ mask, int mask_rows,
                          float* O) {
  const float root = sqrtf(static_cast<float>(DH));
  for (int item = threadIdx.x; item < nl * H * sq; item += blockDim.x) {
    const int q = item % sq;
    const int h = (item / sq) % H;
    const int g = item / (sq * H);
    const float* qr = Q + (g * sq + q) * ld + h * DH;
    float qv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qv[d] = qr[d];
    float s[SMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < SMAX; ++k) {
      if (k < sk) {
        const float* kr = K + (g * sk + k) * ld + h * DH;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(qv[d], kr[d], dot);
        float v = dot / root;
        if (mask) v += __ldg(mask + (mask_rows == 1 ? 0 : q) * sk + k);
        s[k] = v;
        mx = fmaxf(mx, v);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < SMAX; ++k) {
      if (k < sk) {
        s[k] = expf(s[k] - mx);
        sum += s[k];
      }
    }
    float o[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
#pragma unroll
    for (int k = 0; k < SMAX; ++k) {
      if (k < sk) {
        const float a = s[k] / sum;
        const float* vr = V + (g * sk + k) * ld + h * DH;
#pragma unroll
        for (int d = 0; d < DH; ++d) o[d] = fmaf(a, vr[d], o[d]);
      }
    }
    float* orow = O + (g * sq + q) * D + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = o[d];
  }
}

__device__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// X[r] = LayerNorm(X[r] + Y[r]) * gb[0] + gb[1]; one warp per row.
__device__ void add_layer_norm(float* X, const float* Y, int R,
                               const float* __restrict__ gb) {
  const int lane = threadIdx.x & 31;
  const bool two = lane < D - 32;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    float* x = X + r * D;
    float v0 = x[lane] + (Y ? Y[r * D + lane] : 0.f);
    float v1 = two ? x[32 + lane] + (Y ? Y[r * D + 32 + lane] : 0.f) : 0.f;
    const float mu = warp_sum(v0 + v1) / D;
    const float d0 = v0 - mu;
    const float d1 = two ? v1 - mu : 0.f;
    const float var = warp_sum(d0 * d0 + d1 * d1) / D;
    const float root = sqrtf(var + 1e-5f);
    x[lane] = d0 / root * __ldg(gb + lane) + __ldg(gb + D + lane);
    if (two)
      x[32 + lane] = d1 / root * __ldg(gb + 32 + lane) +
                     __ldg(gb + D + 32 + lane);
  }
}

// FF block: X = LayerNorm(X + relu(X W1 + b1) W2 + b2), the hidden in
// chunks of FC columns (HID) accumulated into ACC.
__device__ void ff_block(float* X, int R, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* ln,
                         float* HID, float* ACC) {
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
    ACC[idx] = __ldg(b2 + idx % D);
  __syncthreads();
  for (int c0 = 0; c0 < FF; c0 += FC) {
    linear(X, D, R, D, w1 + c0, FF, b1 + c0, FC, HID, FC, true, false);
    __syncthreads();
    linear(HID, FC, R, FC, w2 + c0 * D, D, nullptr, D, ACC, D, false, true);
    __syncthreads();
  }
  add_layer_norm(X, ACC, R, ln);
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
temporal_forward_kernel(Weights w, const float* __restrict__ enc,
                        const float* __restrict__ dec,
                        const float* __restrict__ mask, int mask_rows,
                        float* __restrict__ out, int B, int s_enc, int s_dec,
                        int rc) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // rc x D   encoder / memory
  float* T = S + rc * D;                       // rc x D   decoder stream
  float* QKV = T + rc * D;                     // rc x 3D  projections
  float* AO = QKV + rc * 3 * D;                // rc x D   attention heads
  float* TMP = AO + rc * D;                    // rc x D   sublayer output
  float* HID = TMP + rc * D;                   // rc x FC  FF hidden chunk

  const int lane0 = blockIdx.x * G;
  const int nl = min(G, B - lane0);
  const int Re = nl * s_enc;
  const int Rd = nl * s_dec;
  const float* pe = w.p[PE];

  // ---- encoder ----
  float* XIN = QKV;                            // rc x XLD
  for (int idx = threadIdx.x; idx < Re * D_ENC; idx += blockDim.x)
    XIN[(idx / D_ENC) * XLD + idx % D_ENC] =
        enc[static_cast<size_t>(lane0) * s_enc * D_ENC + idx];
  __syncthreads();
  linear(XIN, XLD, Re, D_ENC, w.p[W_IN_ENC], D, w.p[B_IN_ENC], D, S, D,
         false, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < Re * D; idx += blockDim.x)
    S[idx] += __ldg(pe + ((idx / D) % s_enc) * D + idx % D);
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LAYERS; ++l) {
#define L(k) w.p[ENC_BASE + l * ENC_STRIDE + (k)]
    linear(S, D, Re, D, L(E_W_IN), 3 * D, L(E_B_IN), 3 * D, QKV, 3 * D,
           false, false);
    __syncthreads();
    attention(QKV, QKV + D, QKV + 2 * D, 3 * D, nl, s_enc, s_enc, nullptr,
              0, AO);
    __syncthreads();
    linear(AO, D, Re, D, L(E_W_OUT), D, L(E_B_OUT), D, TMP, D, false, false);
    __syncthreads();
    add_layer_norm(S, TMP, Re, L(E_LN1));
    __syncthreads();
    ff_block(S, Re, L(E_FF_W1), L(E_FF_B1), L(E_FF_W2), L(E_FF_B2), L(E_LN2),
             HID, TMP);
#undef L
  }
  add_layer_norm(S, nullptr, Re, w.p[ENC_NORM]);   // S is now the memory
  __syncthreads();

  // ---- decoder ----
  float* DIN = QKV;                            // rc x D_LAT
  for (int idx = threadIdx.x; idx < Rd * D_LAT; idx += blockDim.x)
    DIN[idx] = dec[static_cast<size_t>(lane0) * s_dec * D_LAT + idx];
  __syncthreads();
  linear(DIN, D_LAT, Rd, D_LAT, w.p[W_IN_DEC], D, w.p[B_IN_DEC], D, T, D,
         false, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < Rd * D; idx += blockDim.x)
    T[idx] += __ldg(pe + ((idx / D) % s_dec) * D + idx % D);
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LAYERS; ++l) {
#define L(k) w.p[DEC_BASE + l * DEC_STRIDE + (k)]
    // masked self-attention
    linear(T, D, Rd, D, L(S_W_IN), 3 * D, L(S_B_IN), 3 * D, QKV, 3 * D,
           false, false);
    __syncthreads();
    attention(QKV, QKV + D, QKV + 2 * D, 3 * D, nl, s_dec, s_dec, mask,
              mask_rows, AO);
    __syncthreads();
    linear(AO, D, Rd, D, L(S_W_OUT), D, L(S_B_OUT), D, TMP, D, false, false);
    __syncthreads();
    add_layer_norm(T, TMP, Rd, L(D_LN1));
    __syncthreads();
    // cross-attention: Q from the decoder rows, K and V from the memory
    linear(T, D, Rd, D, L(C_W_IN), 3 * D, L(C_B_IN), D, QKV, 3 * D, false,
           false);
    linear(S, D, Re, D, L(C_W_IN) + D, 3 * D, L(C_B_IN) + D, 2 * D, QKV + D,
           3 * D, false, false);
    __syncthreads();
    attention(QKV, QKV + D, QKV + 2 * D, 3 * D, nl, s_dec, s_enc, nullptr,
              0, AO);
    __syncthreads();
    linear(AO, D, Rd, D, L(C_W_OUT), D, L(C_B_OUT), D, TMP, D, false, false);
    __syncthreads();
    add_layer_norm(T, TMP, Rd, L(D_LN2));
    __syncthreads();
    ff_block(T, Rd, L(F_W1), L(F_B1), L(F_W2), L(F_B2), L(D_LN3), HID, TMP);
#undef L
  }
  add_layer_norm(T, nullptr, Rd, w.p[DEC_NORM]);
  __syncthreads();
  linear(T, D, Rd, D, w.p[W_OUT], D_LAT, w.p[B_OUT], D_LAT,
         out + static_cast<size_t>(lane0) * s_dec * D_LAT, D_LAT, false,
         false);
}

}  // namespace

extern "C" int temporal_forward_n_pointers() { return N_PTR; }

// ptrs: host array of N_PTR device pointers.  enc (B, s_enc, 33),
// dec (B, s_dec, 24), mask (mask_rows, s_dec), out (B, s_dec, 24); float32,
// contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int temporal_forward(const void* const* ptrs, const void* enc,
                                const void* dec, const void* mask,
                                int mask_rows, void* out, int B, int s_enc,
                                int s_dec, void* stream) {
  if (s_enc < 1 || s_enc > SMAX || s_dec < 1 || s_dec > SMAX || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < N_PTR; ++i) w.p[i] = static_cast<const float*>(ptrs[i]);
  const int smax = s_enc > s_dec ? s_enc : s_dec;
  const int rc = ((G * smax + RPT - 1) / RPT) * RPT;
  const size_t smem = static_cast<size_t>(rc) * (7 * D + FC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + G - 1) / G;
  temporal_forward_kernel<<<grid, NT, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(enc), static_cast<const float*>(dec),
      static_cast<const float*>(mask), mask_rows, static_cast<float*>(out),
      B, s_enc, s_dec, rc);
  return static_cast<int>(cudaGetLastError());
}
