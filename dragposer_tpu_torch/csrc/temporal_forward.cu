// K2: the temporal-transformer inference forward in one kernel.
//
// Replaces the TPU kernel dragposer_tpu/ops/temporal_fused.py:_kernel
// (pallas_call in _call, public forward): the whole seq2seq forward —
// input projections + positional encoding, 3 post-LN encoder layers, the
// encoder norm, 3 decoder layers (masked self-attention, cross-attention,
// FF 48→2048→48 ReLU), the final LayerNorm and the output projection.
//
// What bounds it on the H100: tensor-core operations.  Per lane the
// forward is 19.11 MFLOP at S_enc = 14, S_dec = 1, 18.99 of it weight
// products.  Every product runs on the tensor cores as 3xTF32 (x = hi +
// lo, hi = tf32(x), lo = tf32(x − hi); x·w ≈ lo·hi + hi·lo + hi·hi summed
// in float32), which keeps float32 accuracy for three passes:
// 3 × 155.5 GFLOP / 495 TFLOP/s ≈ 0.95 ms at B = 8192.  Attention scores
// and values (S ≤ 30, dh = 12), softmax, LayerNorm and the residual adds
// stay float32 on CUDA cores, as the TPU kernel kept its attention at
// HIGHEST.  The weights stream from L2 once per block, split: the FF's
// 6 × 2 × 48 × 2048 × 8 B = 9.4 MB and 0.35 MB of projections, 911 times
// at B = 8192 (G = 9), ≈ 8.9 GB per call — the second bound.
//
// What the design does about it:
// - The FF (88% of the products) runs on wgmma (m64nNk8 TF32, A from
//   registers, B from shared memory): the block's 128 rows are two
//   warpgroups × 64 rows, and the FF hidden chunk stays in registers
//   between its two products.  FF1's accumulator layout (row g, columns
//   2t, 2t+1) is FF2's A fragment (columns t, t+4) once FF2's contraction
//   index is numbered so that k = t is hidden column 2t and k = t + 4 is
//   2t + 1; FF2's weights are packed in that order.  A TF32 wgmma is only
//   8 deep, so each is made as wide as the product allows: FF1 runs at
//   N = 64, FF2 at N = 48 (the model width).  The other products
//   (projections, ~3% of the work) run on mma.sync.m16n8k8.
// - Weights are split at pack time (ops/temporal_fused.py: frag_pack,
//   ff_tiles), in the layout each instruction reads: the projections as
//   mma.sync B fragments (a warp loads one as a 16-byte float4 per
//   lane), the FF as wgmma's K-major core-matrix tiles, hi then lo, chunk
//   by chunk.  Twice the weight bytes through L2, and no block spends ALU
//   time splitting the same weights again.  Activations are split when
//   they enter a product, with integer rounding (two integer operations
//   instead of the slower conversion instruction).
// - G = 128 / max(S_enc, S_dec) lanes per block (9 at S = 14; the
//   first, CUDA-core design took 4), so a block holds 113..128 rows:
//   every weight byte staged in shared memory feeds up to 128 rows, and
//   the 9 lanes' L2 traffic is what 4 lanes cost before.  Shared memory, RC = 128 rows:
//   the streams S and T, the sublayer output TMP and the heads AO, 128 ×
//   52 floats each (stride 52 keeps fragment loads conflict-free), QKV 128
//   × 148: 182,272 B.  The FF needs neither QKV nor AO, so its ring of
//   three stages (the W1 and W2 chunks of FC = 64 hidden columns as hi
//   and lo, and b1's chunk: 49,408 B each) starts at QKV and runs past
//   AO: 79,872 + 3 × 49,408 = 228,096 B of the 232,448.
// - The ring is filled by cp.async two chunks ahead of the one multiplied,
//   one barrier a chunk.  The tensor cores' accumulation truncates, so
//   FF2 restarts every chunk and its sum is added in registers, rounded
//   to nearest, rather than chaining 768 wgmma in one accumulator.
// - Ragged batches: the last block's missing lanes are rows that load as
//   0 and are never stored.
// - Sequences up to the positional encoding's 30 rows (a rollout over a
//   future window W takes W / 4 + 1 decoder steps, so W ≤ 119, as the JAX
//   package accepts).  The longest sequence is a template parameter of the
//   kernel: attention keeps a query's scores in SMAX registers and unrolls
//   its three loops over them.  Two builds, SMAX = 16 (every window up to
//   63, the code the kernel had when 16 was its only bound) and SMAX = 32;
//   the launcher takes the smaller that covers max(S_enc, S_dec).  At
//   S = 30 a block holds G = 4 lanes (120 of its 128 rows).
//
// Weights arrive as a table of 84 device pointers (order fixed by
// dragposer_tpu_torch/ops/temporal_fused.py:_weights): matrices packed and
// split as above, biases, LayerNorm (2, 48) and the positional encoding in
// float32.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 48;       // d_model
constexpr int H = 4;        // heads
constexpr int DH = D / H;   // 12
constexpr int FF = 2048;
constexpr int D_ENC = 33;   // latent + 3 + 6 heights
constexpr int D_LAT = 24;
constexpr int NT = 256;     // threads per block
constexpr int NW = NT / 32; // warps per block
constexpr int RC = 128;     // rows a block holds (G · max(S_enc, S_dec))
constexpr int SMAX_SHORT = 16;  // the two builds' longest sequences
constexpr int SMAX_LONG = 32;
constexpr int LD = 52;      // row stride of the D-wide buffers
constexpr int LDQ = 148;    // row stride of QKV
constexpr int XLD = 44;     // row stride of the encoder input (K padded to 40)
constexpr int DLD = 28;     // row stride of the decoder input
constexpr int KS_D = D / 8; // k-steps of a D-deep product
constexpr int NG = 3;       // n-tiles per warp item in a small linear
constexpr int FRAG = 32 * 4;                   // floats per fragment block
constexpr int FC = 64;      // FF hidden columns per staged chunk
constexpr int NCH = FF / FC;
constexpr int CHUNK = FC * D;                  // floats of a W1 or W2 chunk
constexpr int STAGE = 2 * CHUNK;               // W1 chunk, then W2 chunk
// a wgmma B tile: 8-row × 16-byte core matrices, the two of a k-step's
// halves LBO apart, neighbours along N SBO apart
constexpr int LBO = 128, SBO = 256;            // bytes
constexpr int W1_KSTEP = (FC / 8) * SBO / 4;   // floats of one W1 k-step
constexpr int W2_KSTEP = (D / 8) * SBO / 4;    // floats of one W2 k-step
// a stage: W1's and W2's chunk as hi, then as lo, then b1's chunk
constexpr int SPLIT = 2 * STAGE + FC;
constexpr int NSTAGE = 3;
// activations: S, T, TMP (RC x LD each), QKV (RC x LDQ), AO (RC x LD)
constexpr int ACT_FLOATS = 4 * RC * LD + RC * LDQ;
// the FF's stages from QKV on, past AO into the rest of the 227 KB
constexpr int RING_AT = 3 * RC * LD;
constexpr int RING_END = RING_AT + NSTAGE * SPLIT;
constexpr int SMEM_FLOATS = RING_END > ACT_FLOATS ? RING_END : ACT_FLOATS;
static_assert(SMEM_FLOATS * 4 <= 232448, "shared memory");
static_assert(STAGE % (4 * NT) == 0 && FC / 4 <= NT,
              "a thread's share of a chunk");
static_assert(NW == 8 && RC == 128, "two warpgroups of 64 rows");

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

// ---- 3xTF32 ----

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the result of cvt.rna.tf32.f32 for finite x, in two integer
// operations (the conversion instruction runs at a fraction of their rate).
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

// The A fragment of rows m0 + g, m0 + g + 8 and columns k0 + t, k0 + t + 4
// of X (row stride ld), split.
__device__ __forceinline__ void load_a(const float* X, int ld, int m0,
                                       int k0, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31;
  const float* x = X + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split(x[0], ah[0], al[0]);
  split(x[8 * ld], ah[1], al[1]);
  split(x[4], ah[2], al[2]);
  split(x[8 * ld + 4], ah[3], al[3]);
}

// Y[r, o] = sum_k X[r, k] W[k, o] + b[o] for r < R, o < 8·ntiles, on
// mma.sync.  W is fragment-packed n-major ([n-tile][k-step][lane] float4
// {hi(k=t), hi(k=t+4), lo(k=t), lo(k=t+4)} of column g, split at pack
// time, in global memory); X is read to 8·KSTEPS columns and to the last
// m-tile's rows (inside the buffer; rows ≥ R are never stored).  Warp
// items: (m-tile, NG n-tiles), each item's weight fragments loaded before
// its first product, and each of the 3 passes with its own accumulator
// (chains of KSTEPS mma, not 3·KSTEPS).
template <int KSTEPS>
__device__ void linear(const float* X, int ldx, int R,
                       const float* __restrict__ Wp,
                       const float* __restrict__ b, int ntiles, float* Y,
                       int ldy) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ngroups = (ntiles + NG - 1) / NG;
  const int items = (R + 15) / 16 * ngroups;
  const float4* W = reinterpret_cast<const float4*>(Wp);
  for (int item = threadIdx.x >> 5; item < items; item += NW) {
    const int m0 = (item / ngroups) * 16;
    const int n0 = (item % ngroups) * NG;
    float4 cur[NG][KSTEPS];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        cur[j][kk] = n0 + j < ntiles
                         ? __ldg(W + ((n0 + j) * KSTEPS + kk) * 32 + lane)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float acc[3][NG][4] = {};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ah[4], al[4];
      load_a(X, ldx, m0, kk * 8, ah, al);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (n0 + j >= ntiles) continue;
        const float4 v = cur[j][kk];
        mma(acc[0][j], al, v.x, v.y);
        mma(acc[1][j], ah, v.z, v.w);
        mma(acc[2][j], ah, v.x, v.y);
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (n0 + j >= ntiles) continue;
      const int c = (n0 + j) * 8 + 2 * t;
      const float b0 = __ldg(b + c), b1 = __ldg(b + c + 1);
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (acc[0][j][i] + acc[1][j][i]) + acc[2][j][i];
      const int r0 = m0 + g, r1 = m0 + g + 8;
      if (r0 < R)
        *reinterpret_cast<float2*>(Y + r0 * ldy + c) =
            make_float2(v[0] + b0, v[1] + b1);
      if (r1 < R)
        *reinterpret_cast<float2*>(Y + r1 * ldy + c) =
            make_float2(v[2] + b0, v[3] + b1);
    }
  }
}

// X[r] = LayerNorm(X[r] + Y[r]) * gb[0] + gb[1] for r < R (row stride LD,
// Y optional): four threads a row, each the float4s q, q + 4, q + 8.
__device__ void add_layer_norm(float* X, const float* Y, int R,
                               const float* __restrict__ gb) {
  const int q = threadIdx.x & 3;
  float4 gam[3], bet[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gam[i] = __ldg(reinterpret_cast<const float4*>(gb) + q + 4 * i);
    bet[i] = __ldg(reinterpret_cast<const float4*>(gb + D) + q + 4 * i);
  }
  for (int r0 = 0; r0 < R; r0 += NT / 4) {   // uniform: shuffles below
    const int r = r0 + (threadIdx.x >> 2);
    const bool ok = r < R;
    float4* x = reinterpret_cast<float4*>(X + r * LD);
    const float4* y = reinterpret_cast<const float4*>(Y + r * LD);
    float4 v[3];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i] = ok ? x[q + 4 * i] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (Y && ok) {
        const float4 u = y[q + 4 * i];
        v[i].x += u.x; v[i].y += u.y; v[i].z += u.z; v[i].w += u.w;
      }
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s / D;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i].x -= mu; v[i].y -= mu; v[i].z -= mu; v[i].w -= mu;
      ss += (v[i].x * v[i].x + v[i].y * v[i].y) +
            (v[i].z * v[i].z + v[i].w * v[i].w);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float root = sqrtf(ss / D + 1e-5f);
    if (ok) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        x[q + 4 * i] = make_float4(v[i].x / root * gam[i].x + bet[i].x,
                                   v[i].y / root * gam[i].y + bet[i].y,
                                   v[i].z / root * gam[i].z + bet[i].z,
                                   v[i].w / root * gam[i].w + bet[i].w);
    }
  }
}

// ---- the FF block: split weights through cp.async ----

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Chunk c of W1 and of W2 (each hi then lo, 2·CHUNK floats, contiguous in
// the packed layout) and of b1 into a stage (hi of W1 and W2, lo of W1
// and W2, b1); c ≥ NCH commits an empty group, so that every step commits
// one.
__device__ __forceinline__ void stage_chunk(float* dst, const float* w1,
                                            const float* b1, const float* w2,
                                            int c) {
  if (c < NCH) {
    const float* s1 = w1 + static_cast<size_t>(c) * 2 * CHUNK;
    const float* s2 = w2 + static_cast<size_t>(c) * 2 * CHUNK;
    for (int a = threadIdx.x * 4; a < 2 * CHUNK; a += NT * 4) {
      const int at = a < CHUNK ? a : STAGE + (a - CHUNK);
      cp_async16(dst + at, s1 + a);
      cp_async16(dst + CHUNK + at, s2 + a);
    }
    if (threadIdx.x < FC / 4)
      cp_async16(dst + 2 * STAGE + threadIdx.x * 4,
                 b1 + c * FC + threadIdx.x * 4);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// ---- wgmma (m64nNk8, TF32, A from registers, B from shared memory) ----

// Shared-memory descriptor of a K-major B tile without swizzle.
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

// Registers an in-flight wgmma owns (accumulators, A fragments): touched
// after the wait, so the compiler neither reads nor reuses them earlier.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n48(float (&d)[24],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <int NC>
__device__ __forceinline__ void wgmma_ff1(float (&d)[NC / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  if constexpr (NC == 64) wgmma_n64(d, a, desc, accumulate);
  else wgmma_n32(d, a, desc, accumulate);
}

// X = LayerNorm(X + relu(X W1 + b1) W2 + b2) over R rows, the hidden in
// registers chunk by chunk.  KSPLIT = 1 (R > 64): warpgroup w owns rows
// 64w..64w+63 and all FC hidden columns of a chunk; KSPLIT = 2 (R ≤ 64):
// both own rows 0..63 and warpgroup w the hidden columns 32w..32w+31.
//
// The chunks arrive split (pack time) through a ring of NSTAGE stages,
// two ahead of the one multiplied, one barrier a chunk.  The tensor cores'
// accumulation truncates, so FF2 restarts its accumulator every chunk and
// the chunk's sum is added to a float32 sum in registers (rounded to
// nearest) instead of chaining 768 wgmma.  Warpgroup w's sum goes to PART
// rows 64w..64w+63 at the end.
template <int KSPLIT>
__device__ void ff_block(float* X, int R, const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ ln, float* ring,
                         float* PART) {
  constexpr int NC = FC / KSPLIT;   // FF1 columns per warpgroup
  constexpr int HT = NC / 8;        // FF2 k-steps per warpgroup
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (KSPLIT == 1 ? wg * 64 : 0) + (warp & 3) * 16;
  const int h0 = KSPLIT == 1 ? 0 : wg * NC;   // first hidden column

  stage_chunk(ring, w1, b1, w2, 0);
  stage_chunk(ring + SPLIT, w1, b1, w2, 1);
  // X's A fragments for the warp's 16 rows, split once for the whole FF
  uint32_t xh[KS_D][4], xl[KS_D][4];
#pragma unroll
  for (int kk = 0; kk < KS_D; ++kk) load_a(X, LD, m0, kk * 8, xh[kk], xl[kk]);
  float sum[D / 2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float2 v = KSPLIT == 1 || wg == 0
                         ? __ldg(reinterpret_cast<const float2*>(
                               b2 + n * 8 + 2 * t))
                         : make_float2(0.f, 0.f);
    sum[4 * n + 0] = sum[4 * n + 2] = v.x;
    sum[4 * n + 1] = sum[4 * n + 3] = v.y;
  }

  for (int c = 0; c < NCH; ++c) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");   // chunk c here
    // the tensor cores read shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();   // chunk c whole; the stage of chunk c − 1 free
    stage_chunk(ring + ((c + 2) % NSTAGE) * SPLIT, w1, b1, w2, c + 2);
    const float* st = ring + (c % NSTAGE) * SPLIT;

    // FF1: (64 × 48) · (48 × NC), lo·hi, hi·lo, hi·hi
    float h[NC / 2];
    wg_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int kk = 0; kk < KS_D; ++kk)
        wgmma_ff1<NC>(h, p == 0 ? xl[kk] : xh[kk],
                      b_desc(st + (p == 1 ? STAGE : 0) + kk * W1_KSTEP +
                             h0 / 8 * SBO / 4),
                      p > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    hold(h);

    // FF1's (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of hidden block j
    // are FF2's A at (g, t), (g, t+4), (g+8, t), (g+8, t+4): W2 is packed
    // to match
    uint32_t ah[HT][4], al[HT][4];
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(
          st + 2 * STAGE + h0 + j * 8 + 2 * t);
      split(fmaxf(h[4 * j + 0] + bb.x, 0.f), ah[j][0], al[j][0]);
      split(fmaxf(h[4 * j + 2] + bb.x, 0.f), ah[j][1], al[j][1]);
      split(fmaxf(h[4 * j + 1] + bb.y, 0.f), ah[j][2], al[j][2]);
      split(fmaxf(h[4 * j + 3] + bb.y, 0.f), ah[j][3], al[j][3]);
    }

    // FF2: (64 × NC) · (NC × 48)
    float acc[D / 2];
    wg_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int j = 0; j < HT; ++j)
        wgmma_n48(acc, p == 0 ? al[j] : ah[j],
                  b_desc(st + CHUNK + (p == 1 ? STAGE : 0) +
                         (h0 / 8 + j) * W2_KSTEP),
                  p > 0 || j > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    hold(acc);
    hold(ah);
    hold(al);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) sum[i] += acc[i];
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  float* part = PART + (wg * 64 + (warp & 3) * 16) * LD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(part + g * LD + col) =
        make_float2(sum[4 * n + 0], sum[4 * n + 1]);
    *reinterpret_cast<float2*>(part + (g + 8) * LD + col) =
        make_float2(sum[4 * n + 2], sum[4 * n + 3]);
  }
  __syncthreads();
  if (KSPLIT == 2) {   // the second warpgroup's half, in a fixed order
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      const int r = idx / D, col = idx % D;
      PART[r * LD + col] += PART[(64 + r) * LD + col];
    }
    __syncthreads();
  }
  add_layer_norm(X, PART, R, ln);
  __syncthreads();
}

// ff_block at the split that R needs.
__device__ void ff(float* X, int R, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* ln,
                   float* ring, float* PART) {
  if (R > 64) ff_block<1>(X, R, w1, b1, w2, b2, ln, ring, PART);
  else ff_block<2>(X, R, w1, b1, w2, b2, ln, ring, PART);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// O[(g, q), h*DH + d] = softmax_k(Q·K / sqrt(DH) + mask) · V for each lane
// g < nl, head h and query q < sq.  mask: additive, (1, sk) or (sq, sk).
// Q, K, V with row stride LDQ, O with LD; a head's 12 values as 3 float4.
// sk ≤ SMAX: a query's scores stay in registers.
template <int SMAX>
__device__ void attention(const float* Q, const float* K, const float* V,
                          int nl, int sq, int sk,
                          const float* __restrict__ mask, int mask_rows,
                          float* O) {
  const float root = sqrtf(static_cast<float>(DH));
  for (int item = threadIdx.x; item < nl * H * sq; item += NT) {
    const int q = item % sq;
    const int h = (item / sq) % H;
    const int g = item / (sq * H);
    const float4* qr =
        reinterpret_cast<const float4*>(Q + (g * sq + q) * LDQ + h * DH);
    const float4 q0 = qr[0], q1 = qr[1], q2 = qr[2];
    float s[SMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < SMAX; ++k) {
      if (k < sk) {
        const float4* kr =
            reinterpret_cast<const float4*>(K + (g * sk + k) * LDQ + h * DH);
        float v = dot4(q2, kr[2], dot4(q1, kr[1], dot4(q0, kr[0], 0.f))) /
                  root;
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
    float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0, o2 = o0;
#pragma unroll
    for (int k = 0; k < SMAX; ++k) {
      if (k < sk) {
        const float a = s[k] / sum;
        const float4* vr =
            reinterpret_cast<const float4*>(V + (g * sk + k) * LDQ + h * DH);
        o0 = axpy4(a, vr[0], o0);
        o1 = axpy4(a, vr[1], o1);
        o2 = axpy4(a, vr[2], o2);
      }
    }
    float4* orow = reinterpret_cast<float4*>(O + (g * sq + q) * LD + h * DH);
    orow[0] = o0;
    orow[1] = o1;
    orow[2] = o2;
  }
}

template <int SMAX>
__global__ void __launch_bounds__(NT, 1)
temporal_forward_kernel(Weights w, const float* __restrict__ enc,
                        const float* __restrict__ dec,
                        const float* __restrict__ mask, int mask_rows,
                        float* __restrict__ out, int B, int G, int s_enc,
                        int s_dec) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // RC x LD   encoder / memory
  float* T = S + RC * LD;                      // RC x LD   decoder stream
  float* TMP = T + RC * LD;                    // RC x LD   sublayer output
  float* QKV = TMP + RC * LD;                  // RC x LDQ  projections
  float* AO = QKV + RC * LDQ;                  // RC x LD   attention heads
  float* RING = QKV;                           // FF weights, from QKV on

  const int lane0 = blockIdx.x * G;
  const int nl = min(G, B - lane0);
  const int Re = nl * s_enc;
  const int Rd = nl * s_dec;
  const float* pe = w.p[PE];

  // every activation buffer starts at 0: rows past the last lane, and the
  // encoder input's padding columns 33..39, stay 0
  for (int i = threadIdx.x; i < ACT_FLOATS / 4; i += NT)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // ---- encoder ----
  float* XIN = QKV;                            // RC x XLD
  for (int idx = threadIdx.x; idx < Re * D_ENC; idx += NT)
    XIN[(idx / D_ENC) * XLD + idx % D_ENC] =
        enc[static_cast<size_t>(lane0) * s_enc * D_ENC + idx];
  __syncthreads();
  linear<(D_ENC + 7) / 8>(XIN, XLD, Re, w.p[W_IN_ENC], w.p[B_IN_ENC], D / 8,
                          S, LD);
  __syncthreads();
  for (int idx = threadIdx.x; idx < Re * D; idx += NT)
    S[(idx / D) * LD + idx % D] += __ldg(pe + ((idx / D) % s_enc) * D +
                                         idx % D);
  __syncthreads();
  for (int l = 0; l < LAYERS; ++l) {
#define L(k) w.p[ENC_BASE + l * ENC_STRIDE + (k)]
    linear<KS_D>(S, LD, Re, L(E_W_IN), L(E_B_IN), 3 * D / 8, QKV, LDQ);
    __syncthreads();
    attention<SMAX>(QKV, QKV + D, QKV + 2 * D, nl, s_enc, s_enc, nullptr, 0, AO);
    __syncthreads();
    linear<KS_D>(AO, LD, Re, L(E_W_OUT), L(E_B_OUT), D / 8, TMP, LD);
    __syncthreads();
    add_layer_norm(S, TMP, Re, L(E_LN1));
    __syncthreads();
    ff(S, Re, L(E_FF_W1), L(E_FF_B1), L(E_FF_W2), L(E_FF_B2), L(E_LN2), RING,
       TMP);
#undef L
  }
  add_layer_norm(S, nullptr, Re, w.p[ENC_NORM]);   // S is now the memory
  __syncthreads();

  // ---- decoder ----
  float* DIN = QKV;                            // RC x DLD
  for (int idx = threadIdx.x; idx < Rd * D_LAT; idx += NT)
    DIN[(idx / D_LAT) * DLD + idx % D_LAT] =
        dec[static_cast<size_t>(lane0) * s_dec * D_LAT + idx];
  __syncthreads();
  linear<D_LAT / 8>(DIN, DLD, Rd, w.p[W_IN_DEC], w.p[B_IN_DEC], D / 8, T, LD);
  __syncthreads();
  for (int idx = threadIdx.x; idx < Rd * D; idx += NT)
    T[(idx / D) * LD + idx % D] += __ldg(pe + ((idx / D) % s_dec) * D +
                                         idx % D);
  __syncthreads();
  for (int l = 0; l < LAYERS; ++l) {
#define L(k) w.p[DEC_BASE + l * DEC_STRIDE + (k)]
    // masked self-attention
    linear<KS_D>(T, LD, Rd, L(S_W_IN), L(S_B_IN), 3 * D / 8, QKV, LDQ);
    __syncthreads();
    attention<SMAX>(QKV, QKV + D, QKV + 2 * D, nl, s_dec, s_dec, mask, mask_rows,
              AO);
    __syncthreads();
    linear<KS_D>(AO, LD, Rd, L(S_W_OUT), L(S_B_OUT), D / 8, TMP, LD);
    __syncthreads();
    add_layer_norm(T, TMP, Rd, L(D_LN1));
    __syncthreads();
    // cross-attention: Q from the decoder rows (n-tiles 0..5 of the packed
    // in-projection), K and V from the memory (n-tiles 6..17)
    linear<KS_D>(T, LD, Rd, L(C_W_IN), L(C_B_IN), D / 8, QKV, LDQ);
    linear<KS_D>(S, LD, Re, L(C_W_IN) + (D / 8) * KS_D * FRAG,
                 L(C_B_IN) + D, 2 * D / 8, QKV + D, LDQ);
    __syncthreads();
    attention<SMAX>(QKV, QKV + D, QKV + 2 * D, nl, s_dec, s_enc, nullptr, 0, AO);
    __syncthreads();
    linear<KS_D>(AO, LD, Rd, L(C_W_OUT), L(C_B_OUT), D / 8, TMP, LD);
    __syncthreads();
    add_layer_norm(T, TMP, Rd, L(D_LN2));
    __syncthreads();
    ff(T, Rd, L(F_W1), L(F_B1), L(F_W2), L(F_B2), L(D_LN3), RING, TMP);
#undef L
  }
  add_layer_norm(T, nullptr, Rd, w.p[DEC_NORM]);
  __syncthreads();
  linear<KS_D>(T, LD, Rd, w.p[W_OUT], w.p[B_OUT], D_LAT / 8,
               out + static_cast<size_t>(lane0) * s_dec * D_LAT, D_LAT);
}

int lanes_per_block(int s_enc, int s_dec) {
  return RC / (s_enc > s_dec ? s_enc : s_dec);
}

template <int SMAX>
cudaError_t launch(const Weights& w, const float* enc, const float* dec,
                   const float* mask, int mask_rows, float* out, int B,
                   int s_enc, int s_dec, cudaStream_t stream) {
  const int G = lanes_per_block(s_enc, s_dec);
  const size_t smem = static_cast<size_t>(SMEM_FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_forward_kernel<SMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (B + G - 1) / G;
  temporal_forward_kernel<SMAX><<<grid, NT, smem, stream>>>(
      w, enc, dec, mask, mask_rows, out, B, G, s_enc, s_dec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int temporal_forward_n_pointers() { return N_PTR; }

extern "C" int temporal_forward_max_sequence() { return SMAX_LONG; }

extern "C" int temporal_forward_lanes_per_block(int s_enc, int s_dec) {
  return lanes_per_block(s_enc, s_dec);
}

// ptrs: host array of N_PTR device pointers.  enc (B, s_enc, 33),
// dec (B, s_dec, 24), mask (mask_rows, s_dec), out (B, s_dec, 24); float32,
// contiguous; s_enc, s_dec ≤ SMAX_LONG.  Launches the SMAX_SHORT build
// where both sequences fit it, else the SMAX_LONG one, on `stream`;
// returns cudaGetLastError().
extern "C" int temporal_forward(const void* const* ptrs, const void* enc,
                                const void* dec, const void* mask,
                                int mask_rows, void* out, int B, int s_enc,
                                int s_dec, void* stream) {
  if (s_enc < 1 || s_enc > SMAX_LONG || s_dec < 1 || s_dec > SMAX_LONG ||
      B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < N_PTR; ++i) w.p[i] = static_cast<const float*>(ptrs[i]);
  const auto e = static_cast<const float*>(enc);
  const auto d = static_cast<const float*>(dec);
  const auto m = static_cast<const float*>(mask);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (s_enc > s_dec ? s_enc : s_dec) <= SMAX_SHORT
          ? launch<SMAX_SHORT>(w, e, d, m, mask_rows, o, B, s_enc, s_dec, st)
          : launch<SMAX_LONG>(w, e, d, m, mask_rows, o, B, s_enc, s_dec, st);
  return static_cast<int>(err);
}
