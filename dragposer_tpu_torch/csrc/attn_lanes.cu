// K4a / K4b: the lanes-layout attention core, forward and recompute
// backward.
//
// Replaces the TPU kernels of dragposer_tpu/ops/attn_fused.py:
//   K4a  _fwd_kernel (pallas_call at :159 in _fwd_call, public
//        attn_core_lanes)
//   K4b  _bwd_kernel (pallas_call at :188 in _bwd_call)
// o = softmax(q·kᵀ/√dh + mask)·v per head and lane on q (Sq, h, dh, B) and
// k, v (Sk, h, dh, B), batch in the minor axis, with an additive (Sq, Sk)
// mask; the backward recomputes the probabilities and returns dq, dk, dv.
//
// What bounds it on the H100: bytes.  At Sq = Sk = 15, h = 4 each operand
// is 720 floats a lane; the forward reads q, k, v and writes o (5.9 MB at
// B = 512, 1.76 µs at 3.35 TB/s; 47 MB at B = 4096), the backward reads
// q, k, v, g and writes dq, dk, dv (10.3 MB, 3.08 µs; 83 MB at 4096), and
// each does ~53 (forward) or ~130 (backward) float32 operations a score:
// under 3 µs at B = 4096 on the CUDA cores against 14 and 25 µs of bytes.
// So the design is about moving each byte once and keeping enough work in
// flight to cover the latency of each step; tensor cores would buy nothing.
//
// What the design does about it:
// * a block owns one head and LG = 8 lanes (grid ⌈B/8⌉ × h: 256 blocks at
//   B = 512, h = 4, two for each of the 132 SMs);
// * it stages every operand of its (head, lanes) box in shared memory
//   once: 16-byte loads of 4 lanes (one (token, d) row of the box is 32
//   contiguous bytes), transposed to [token][lane][12] so that a thread
//   reads a head row as three 16-byte loads, 8 lanes of a quarter-warp on
//   distinct banks; the outputs go back through the same tiles and leave
//   as 16-byte stores; the scores of a lane never leave the chip;
// * one warp per query (forward, backward phase 1) or per key (backward
//   phase 2): 16 warps a block, so that B = 512 already puts 32 warps on
//   an SM.  A warp's threads are (lane, slice s = 0..3): the dot products
//   of the scores and of da = g·v split the keys (slice s takes keys s,
//   s + 4, ...; the softmax's max and sum and Σ a·da are added over the
//   slices by shuffles), the products that sum over keys or queries (o,
//   dq, dk, dv) split the head width (slice s < 3 forms dims 4s..4s+3;
//   slice 3 stores nothing), so no output needs a sum across threads;
// * a key whose mask entry is -inf is skipped: the query's warp reads the
//   mask row, and a skipped key costs no product, no exponential and no
//   load (its probability is exactly the 0 that exp(-inf) gives, so finite
//   results are unchanged).  The decision reads the mask's value (any
//   additive mask, not only causal).  A row with no live key keeps every
//   key, so its softmax is 0/0 = NaN, as the plain twin's and the JAX
//   kernel's, and so are dk and dv, as theirs;
// * backward: phase 1 (warp = query r) recomputes a, walks the softmax VJP
//   (da = g·v, ds = a ⊙ (da − Σ a·da)/√dh), keeps a and ds in shared
//   memory and forms dq; phase 2 (warp = key r) sums dk = Σ_i ds·q and
//   dv = Σ_i a·g over the live queries in order.  dk and dv belong to one
//   (head, lane), so no sum crosses blocks: no atomics, deterministic.
// The timed build (TIMED, entry points *_timed) also writes each warp's SM
// clock cycles by phase (CLOCKS_FWD / CLOCKS_BWD slots).
// A ragged lane group (B not a multiple of 8) loads zeros and stores
// nothing past B; when B is not a multiple of 4, or a pointer is not
// 16-byte aligned, the same code moves single floats.
// Float32 on CUDA cores.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 12;                 // head width
constexpr int SMAX = 16;               // longest sequence the kernels take
constexpr int LG = 8;                  // lanes a block
constexpr int SLICES = 4;              // threads of a warp per lane
constexpr int NT = SMAX * LG * SLICES; // one warp per token
constexpr int TILE = SMAX * LG * DH;   // floats of one staged operand
constexpr int GROUPS = LG / 4;         // 16-byte groups of lanes in a row
constexpr int CHUNKS = SMAX * DH * GROUPS;
constexpr unsigned FULL = 0xffffffffu;
// timed build, cycles a warp: forward stage, own compute, the rest (barrier
// wait and the stores); backward stage, own phase 1, own phase 2, the rest
constexpr int CLOCKS_FWD = 3, CLOCKS_BWD = 4;
// a and ds: [query][key][lane]
constexpr int AROW = SMAX * LG;

static_assert(LG * SLICES == 32 && CHUNKS <= NT, "thread layout");

// Thread t of a block: warp (token) t / 32, lane t % 8, slice (t / 8) % 4.
__device__ __forceinline__ int warp_token() { return threadIdx.x >> 5; }
__device__ __forceinline__ int lane_of() { return threadIdx.x & (LG - 1); }
__device__ __forceinline__ int slice_of() {
  return (threadIdx.x >> 3) & (SLICES - 1);
}

// This thread's chunk of the (s, 12, LG) box of head hh and lanes b0.. of
// x (s, h, 12, B): chunk c is (token·12 + d, 4 lanes); zeros past s and B.
template <bool VEC>
__device__ __forceinline__ float4 fetch(const float* __restrict__ x, int s,
                                        int hh, int h, int B, int b0) {
  const int c = threadIdx.x;
  const int row = c / GROUPS, b = b0 + (c % GROUPS) * 4;
  float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < CHUNKS && row < s * DH && b < B) {
    const int tok = row / DH, d = row % DH;
    const float* p = x + (static_cast<size_t>(tok * h + hh) * DH + d) * B + b;
    if (VEC) {
      val = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      val.x = __ldg(p);
      if (b + 1 < B) val.y = __ldg(p + 1);
      if (b + 2 < B) val.z = __ldg(p + 2);
      if (b + 3 < B) val.w = __ldg(p + 3);
    }
  }
  return val;
}

// A fetched chunk into shared memory as [token][lane][12], every one of the
// SMAX tokens (zeros past s).
__device__ __forceinline__ void put(float4 val, float* tile) {
  const int c = threadIdx.x;
  if (c < CHUNKS) {
    const int row = c / GROUPS, tok = row / DH, d = row % DH;
    float* t = tile + (tok * LG + (c % GROUPS) * 4) * DH + d;
    t[0] = val.x;
    t[DH] = val.y;
    t[2 * DH] = val.z;
    t[3 * DH] = val.w;
  }
}

// The reverse: a [token][lane][12] tile out to y (s, h, 12, B), lanes < B.
template <bool VEC>
__device__ __forceinline__ void emit(float* __restrict__ y, const float* tile,
                                     int s, int hh, int h, int B, int b0) {
  const int c = threadIdx.x;
  const int row = c / GROUPS, b = b0 + (c % GROUPS) * 4;
  if (c < CHUNKS && row < s * DH && b < B) {
    const int tok = row / DH, d = row % DH;
    const float* t = tile + (tok * LG + (c % GROUPS) * 4) * DH + d;
    const float4 val = make_float4(t[0], t[DH], t[2 * DH], t[3 * DH]);
    float* p = y + (static_cast<size_t>(tok * h + hh) * DH + d) * B + b;
    if (VEC) {
      *reinterpret_cast<float4*>(p) = val;
    } else {
      p[0] = val.x;
      if (b + 1 < B) p[1] = val.y;
      if (b + 2 < B) p[2] = val.z;
      if (b + 3 < B) p[3] = val.w;
    }
  }
}

__device__ __forceinline__ const float* row_of(const float* tile, int tok,
                                               int lane) {
  return tile + (tok * LG + lane) * DH;
}

// Dims 4s..4s+3 of a row (s < 3).
__device__ __forceinline__ float4 part_of(const float* tile, int tok,
                                          int lane, int s) {
  return reinterpret_cast<const float4*>(row_of(tile, tok, lane))[s];
}

__device__ __forceinline__ void load_row(const float* t, float r[DH]) {
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) {
    const float4 x = reinterpret_cast<const float4*>(t)[j];
    r[4 * j] = x.x;
    r[4 * j + 1] = x.y;
    r[4 * j + 2] = x.z;
    r[4 * j + 3] = x.w;
  }
}

// a · row, as three independent 4-term chains added at the end.
__device__ __forceinline__ float dot_row(const float a[DH], const float* t) {
  float part[DH / 4];
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) {
    const float4 r = reinterpret_cast<const float4*>(t)[j];
    part[j] = a[4 * j] * r.x;
    part[j] = fmaf(a[4 * j + 1], r.y, part[j]);
    part[j] = fmaf(a[4 * j + 2], r.z, part[j]);
    part[j] = fmaf(a[4 * j + 3], r.w, part[j]);
  }
  return (part[0] + part[1]) + part[2];
}

__device__ __forceinline__ void axpy4(float alpha, float4 x, float4& acc) {
  acc.x = fmaf(alpha, x.x, acc.x);
  acc.y = fmaf(alpha, x.y, acc.y);
  acc.z = fmaf(alpha, x.z, acc.z);
  acc.w = fmaf(alpha, x.w, acc.w);
}

// Sum (or max) over the 4 slices of a lane.
__device__ __forceinline__ float slice_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 8);
  return x + __shfl_xor_sync(FULL, x, 16);
}
__device__ __forceinline__ float slice_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 8));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 16));
}

// The keys row i takes (the same in every thread of the warp): bit kk set
// unless mask[i][kk] is -inf; a row with none takes them all (its softmax
// is then 0/0, NaN, as the twin's); a row past sq takes none.
__device__ __forceinline__ unsigned live_keys(const float* mrow, int sk,
                                              bool valid, int s) {
  unsigned own = 0;
#pragma unroll
  for (int j = 0; j < SMAX / SLICES; ++j) {
    const int kk = s + SLICES * j;
    if (valid && kk < sk && mrow[kk] != -INFINITY) own |= 1u << kk;
  }
  const unsigned live = __reduce_or_sync(FULL, own);
  return (live || !valid) ? live : (1u << sk) - 1u;
}

// p[j] = softmax(q_i·k_kk · scale + mask) at this slice's keys kk = s + 4j,
// exactly 0 at a skipped key; the max and the sum over the slices.
__device__ __forceinline__ void slice_probs(const float qi[DH],
                                            const float* Ks,
                                            const float* mrow, unsigned live,
                                            int lane, int s, float scale,
                                            float p[SMAX / SLICES]) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < SMAX / SLICES; ++j) {
    const int kk = s + SLICES * j;
    p[j] = -INFINITY;
    if (live >> kk & 1u) {
      p[j] = dot_row(qi, row_of(Ks, kk, lane)) * scale + mrow[kk];
      mx = fmaxf(mx, p[j]);
    }
  }
  mx = slice_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < SMAX / SLICES; ++j) {
    p[j] = (live >> (s + SLICES * j) & 1u) ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  const float inv = 1.f / slice_sum(sum);
#pragma unroll
  for (int j = 0; j < SMAX / SLICES; ++j) p[j] *= inv;
}

// Where this warp's clock slots start in the timed build's output.
__device__ __forceinline__ long long* warp_clocks(long long* clocks, int n) {
  return clocks + ((static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                       (NT / 32) + warp_token()) * n;
}

// K4a.  grid (⌈B / LG⌉, h), NT threads.
template <bool VEC, bool TIMED>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                float* __restrict__ o, int sq, int sk, int h, int B,
                float scale, long long* __restrict__ clocks) {
  const long long t0 = TIMED ? clock64() : 0;
  __shared__ __align__(16) float Qs[TILE];
  __shared__ __align__(16) float Ks[TILE];
  __shared__ __align__(16) float Vs[TILE];
  __shared__ float Ms[SMAX * SMAX];
  const int hh = blockIdx.y, b0 = blockIdx.x * LG;
  {
    const float4 tq = fetch<VEC>(q, sq, hh, h, B, b0);
    const float4 tk = fetch<VEC>(k, sk, hh, h, B, b0);
    const float4 tv = fetch<VEC>(v, sk, hh, h, B, b0);
    if (static_cast<int>(threadIdx.x) < sq * sk)
      Ms[threadIdx.x] = __ldg(mask + threadIdx.x);
    put(tq, Qs);
    put(tk, Ks);
    put(tv, Vs);
  }
  __syncthreads();
  const long long t1 = TIMED ? clock64() : 0;

  const int i = warp_token(), lane = lane_of(), s = slice_of();
  const int s4 = s < 3 ? s : 0;   // slice 3 repeats slice 0's dims, unstored
  const float* mrow = Ms + i * sk;
  const unsigned live = live_keys(mrow, sk, i < sq, s);
  float qi[DH], p[SMAX / SLICES];
  load_row(row_of(Qs, i, lane), qi);
  slice_probs(qi, Ks, mrow, live, lane, s, scale, p);
  float a[SMAX];                  // every key's probability, from its slice
#pragma unroll
  for (int kk = 0; kk < SMAX; ++kk)
    a[kk] = __shfl_sync(FULL, p[kk / SLICES], lane + LG * (kk % SLICES));
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int kk = 0; kk < SMAX; ++kk)
    if (live >> kk & 1u)          // the same in the whole warp
      axpy4(a[kk], part_of(Vs, kk, lane, s4), out);
  __syncwarp();                   // every slice has read q_i
  if (s < 3)
    reinterpret_cast<float4*>(Qs + (i * LG + lane) * DH)[s] = out;
  const long long t2 = TIMED ? clock64() : 0;
  __syncthreads();
  emit<VEC>(o, Qs, sq, hh, h, B, b0);
  if (TIMED) {
    __syncthreads();
    const long long t3 = clock64();
    if ((threadIdx.x & 31) == 0) {
      long long* c = warp_clocks(clocks, CLOCKS_FWD);
      c[0] = t1 - t0;
      c[1] = t2 - t1;
      c[2] = t3 - t2;
    }
  }
}

// K4b.  grid (⌈B / LG⌉, h), NT threads.
template <bool VEC, bool TIMED>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                const float* __restrict__ g, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv, int sq,
                int sk, int h, int B, float scale,
                long long* __restrict__ clocks) {
  const long long t0 = TIMED ? clock64() : 0;
  __shared__ __align__(16) float Qs[TILE];
  __shared__ __align__(16) float Ks[TILE];
  __shared__ __align__(16) float Vs[TILE];
  __shared__ __align__(16) float Gs[TILE];
  __shared__ float As[SMAX * AROW];
  __shared__ float DSs[SMAX * AROW];
  __shared__ float Ms[SMAX * SMAX];
  __shared__ unsigned Live[SMAX];
  const int hh = blockIdx.y, b0 = blockIdx.x * LG;
  {
    const float4 tq = fetch<VEC>(q, sq, hh, h, B, b0);
    const float4 tk = fetch<VEC>(k, sk, hh, h, B, b0);
    const float4 tv = fetch<VEC>(v, sk, hh, h, B, b0);
    const float4 tg = fetch<VEC>(g, sq, hh, h, B, b0);
    if (static_cast<int>(threadIdx.x) < sq * sk)
      Ms[threadIdx.x] = __ldg(mask + threadIdx.x);
    put(tq, Qs);
    put(tk, Ks);
    put(tv, Vs);
    put(tg, Gs);
  }
  __syncthreads();
  const long long t1 = TIMED ? clock64() : 0;

  const int r = warp_token(), lane = lane_of(), s = slice_of();
  const int s4 = s < 3 ? s : 0;
  float4 dq4 = make_float4(0.f, 0.f, 0.f, 0.f);
  {                               // phase 1: warp = query r
    const float* mrow = Ms + r * sk;
    const unsigned live = live_keys(mrow, sk, r < sq, s);
    if ((threadIdx.x & 31) == 0) Live[r] = live;
    float qi[DH], gi[DH], p[SMAX / SLICES], da[SMAX / SLICES];
    load_row(row_of(Qs, r, lane), qi);
    load_row(row_of(Gs, r, lane), gi);
    slice_probs(qi, Ks, mrow, live, lane, s, scale, p);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < SMAX / SLICES; ++j) {
      const int kk = s + SLICES * j;
      da[j] = 0.f;
      if (live >> kk & 1u) {
        da[j] = dot_row(gi, row_of(Vs, kk, lane));
        rs = fmaf(p[j], da[j], rs);
      }
    }
    rs = slice_sum(rs);
#pragma unroll
    for (int j = 0; j < SMAX / SLICES; ++j) {
      const int kk = s + SLICES * j;
      if (live >> kk & 1u) {
        As[(r * SMAX + kk) * LG + lane] = p[j];
        DSs[(r * SMAX + kk) * LG + lane] = p[j] * (da[j] - rs) * scale;
      }
    }
    __syncwarp();                 // ds of every key of row r stored
#pragma unroll
    for (int kk = 0; kk < SMAX; ++kk)
      if (live >> kk & 1u)        // the same in the whole warp
        axpy4(DSs[(r * SMAX + kk) * LG + lane], part_of(Ks, kk, lane, s4),
              dq4);
  }
  const long long t2 = TIMED ? clock64() : 0;
  __syncthreads();                // k and v are read for the last time above
  const long long t3 = TIMED ? clock64() : 0;

  float4 dk4 = make_float4(0.f, 0.f, 0.f, 0.f), dv4 = dk4;
  {                               // phase 2: warp = key r
    unsigned col = 0;             // bit i: (query i, key r) is live
#pragma unroll
    for (int i = 0; i < SMAX; ++i) col |= (Live[i] >> r & 1u) << i;
#pragma unroll
    for (int i = 0; i < SMAX; ++i) {
      if (col >> i & 1u) {        // the same in the whole warp
        axpy4(DSs[(i * SMAX + r) * LG + lane], part_of(Qs, i, lane, s4),
              dk4);
        axpy4(As[(i * SMAX + r) * LG + lane], part_of(Gs, i, lane, s4),
              dv4);
      }
    }
  }
  const long long t4 = TIMED ? clock64() : 0;
  __syncthreads();                // q and g are read for the last time above
  if (s < 3) {
    reinterpret_cast<float4*>(Qs + (r * LG + lane) * DH)[s] = dq4;
    reinterpret_cast<float4*>(Ks + (r * LG + lane) * DH)[s] = dk4;
    reinterpret_cast<float4*>(Vs + (r * LG + lane) * DH)[s] = dv4;
  }
  __syncthreads();
  emit<VEC>(dq, Qs, sq, hh, h, B, b0);
  emit<VEC>(dk, Ks, sk, hh, h, B, b0);
  emit<VEC>(dv, Vs, sk, hh, h, B, b0);
  if (TIMED) {
    __syncthreads();
    const long long t5 = clock64();
    if ((threadIdx.x & 31) == 0) {
      long long* c = warp_clocks(clocks, CLOCKS_BWD);
      c[0] = t1 - t0;
      c[1] = t2 - t1;
      c[2] = t4 - t3;
      c[3] = (t3 - t2) + (t5 - t4);
    }
  }
}

bool bad_shape(int sq, int sk, int h, int dh, int B) {
  return sq < 1 || sq > SMAX || sk < 1 || sk > SMAX || h < 1 || h > 65535 ||
         dh != DH || B < 1;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool TIMED>
int forward(const void* q, const void* k, const void* v, const void* mask,
            void* o, int sq, int sk, int h, int dh, int B, float scale,
            void* clocks, void* stream) {
  if (bad_shape(sq, sk, h, dh, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + LG - 1) / LG, h);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = B % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o);
  auto kernel = vec ? attn_fwd_kernel<true, TIMED>
                    : attn_fwd_kernel<false, TIMED>;
  kernel<<<grid, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<float*>(o), sq, sk, h, B, scale,
      static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

template <bool TIMED>
int backward(const void* q, const void* k, const void* v, const void* mask,
             const void* g, void* dq, void* dk, void* dv, int sq, int sk,
             int h, int dh, int B, float scale, void* clocks, void* stream) {
  if (bad_shape(sq, sk, h, dh, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + LG - 1) / LG, h);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = B % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(g) && aligned16(dq) &&
                   aligned16(dk) && aligned16(dv);
  auto kernel = vec ? attn_bwd_kernel<true, TIMED>
                    : attn_bwd_kernel<false, TIMED>;
  kernel<<<grid, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, h, B, scale,
      static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o (sq, h, 12, B); k, v (sk, h, 12, B); mask (sq, sk) additive; float32,
// contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int attn_lanes_forward(const void* q, const void* k, const void* v,
                                  const void* mask, void* o, int sq, int sk,
                                  int h, int dh, int B, float scale,
                                  void* stream) {
  return forward<false>(q, k, v, mask, o, sq, sk, h, dh, B, scale, nullptr,
                        stream);
}

// g, dq like q; dk, dv like k.
extern "C" int attn_lanes_backward(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* g, void* dq, void* dk,
                                   void* dv, int sq, int sk, int h, int dh,
                                   int B, float scale, void* stream) {
  return backward<false>(q, k, v, mask, g, dq, dk, dv, sq, sk, h, dh, B,
                         scale, nullptr, stream);
}

// The timed builds: also `clocks`, int64 (⌈B / 8⌉ · h · 16, CLOCKS_FWD or
// CLOCKS_BWD) of the warps' cycles by phase.
extern "C" int attn_lanes_forward_timed(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* o, int sq, int sk, int h,
                                        int dh, int B, float scale,
                                        void* clocks, void* stream) {
  return forward<true>(q, k, v, mask, o, sq, sk, h, dh, B, scale, clocks,
                       stream);
}

extern "C" int attn_lanes_backward_timed(const void* q, const void* k,
                                         const void* v, const void* mask,
                                         const void* g, void* dq, void* dk,
                                         void* dv, int sq, int sk, int h,
                                         int dh, int B, float scale,
                                         void* clocks, void* stream) {
  return backward<true>(q, k, v, mask, g, dq, dk, dv, sq, sk, h, dh, B,
                        scale, clocks, stream);
}
