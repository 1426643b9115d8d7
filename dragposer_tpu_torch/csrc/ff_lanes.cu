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
// The kernels are ff_common.cuh's, on the layout below: a column is
// (token s, lane b), a tile 64 lanes of one token.  What
// bounds them and what their design does about it is written there; at
// S = 15, B = 512, F = 2048 the forward is 3.02 GFLOP and the (S·B, 2048)
// hidden, never stored, would be 63 MB.  The dropout mask is the JAX
// package's own hash with the TPU tiling's indices (tile = min(256,
// max(128, B)), tile id s·nb + b // tile, position f·tile + b % tile), so
// it matches JAX bit for bit whatever this kernel's own tiling is.
// Plain C interface, loaded with ctypes.

#include "ff_common.cuh"

namespace {

using ff::BN;
using ff::D;
using ff::FC;

constexpr int TILE_B = 256;

// x (S, D, B): column c = s·B + b.
struct LanesLayout {
  static constexpr bool kMinor = false;
  int S, B, nbt;       // tokens, lanes, lane tiles of BN per token
  int tile, nb;        // the TPU kernel's lane tile and tiles per token
  uint32_t fstride;    // = tile
  __host__ __device__ int tiles() const { return S * nbt; }
  __host__ __device__ int cols() const { return S * B; }
  __device__ ff::TileView tile_view(int t) const {
    const int s = t / nbt, b0 = (t % nbt) * BN;
    return {static_cast<size_t>(s) * D * B + b0, B, 1,
            B - b0 < BN ? B - b0 : BN};
  }
  __device__ int col(int t, int j) const {
    const int b = (t % nbt) * BN + j;
    return b < B ? (t / nbt) * B + b : -1;
  }
  __device__ size_t offset(int k, int c) const {
    return (static_cast<size_t>(c / B) * D + k) * B + c % B;
  }
  // ops/ff_fused.py:_keep_mask_T at (s, hidden row 0, b)
  __device__ uint32_t hash_base(int c, uint32_t seedmix) const {
    const int s = c / B, b = c % B;
    return static_cast<uint32_t>(b % tile) + seedmix +
           static_cast<uint32_t>(s * nb + b / tile) * ff::TILE_MIX;
  }
};

LanesLayout make_layout(int S, int B) {
  LanesLayout lay;
  lay.S = S;
  lay.B = B;
  lay.nbt = (B + BN - 1) / BN;
  lay.tile = B < 128 ? 128 : (B > TILE_B ? TILE_B : B);
  lay.nb = (B + lay.tile - 1) / lay.tile;
  lay.fstride = static_cast<uint32_t>(lay.tile);
  return lay;
}

bool bad_shape(int S, int B, int F) {
  return S < 1 || B < 1 || ff::bad_width(F);
}

}  // namespace

// x, y (S, 48, B); w1 (F, 48); b1 (F); w2 (48, F); b2 (48); float32,
// contiguous, w1 and w2 16-byte aligned.  F a multiple of 64.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ff_lanes_forward(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* y,
                                int S, int B, int F, unsigned seedmix,
                                unsigned thresh, float scale, int use_mask,
                                void* stream) {
  if (bad_shape(S, B, F)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ff::forward(
      make_layout(S, B), static_cast<const float*>(x),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(y), F,
      ff::make_mask(seedmix, thresh, scale, use_mask),
      static_cast<cudaStream_t>(stream)));
}

// Floats of the backward's workspace.
extern "C" long long ff_lanes_backward_workspace_floats(int S, int B, int F) {
  return ff::bwd_workspace_floats(static_cast<long long>(S) * B,
                                  S * ((B + BN - 1) / BN), F);
}

// g, dx like x; dw1 like w1; db1 (F); dw2 like w2; db2 (48); ws of
// ff_lanes_backward_workspace_floats(S, B, F) floats.
extern "C" int ff_lanes_backward(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* g, void* dx,
                                 void* dw1, void* db1, void* dw2, void* db2,
                                 void* ws, int S, int B, int F,
                                 unsigned seedmix, unsigned thresh,
                                 float scale, int use_mask, void* stream) {
  if (bad_shape(S, B, F)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ff::backward(
      make_layout(S, B), static_cast<const float*>(x),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(g),
      static_cast<float*>(dx), static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dw2),
      static_cast<float*>(db2), static_cast<float*>(ws), F,
      ff::make_mask(seedmix, thresh, scale, use_mask),
      static_cast<cudaStream_t>(stream)));
}
