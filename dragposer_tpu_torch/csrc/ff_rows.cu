// K3a / K3b: the rows-layout fused feed-forward with counter-hash dropout,
// forward and recompute backward.
//
// Replaces the TPU kernels of dragposer_tpu/ops/ff_fused.py:
//   K3a  _fwd_kernel (pallas_call in _fwd_call, public ff_dropout_seeded)
//   K3b  _bwd_kernel (pallas_call in _bwd_call)
// y = drop(relu(x · W1ᵀ + b1)) · W2ᵀ + b2 on x of shape (M, D), one token
// per row (M = B·S for the trainer's (B, S, D) activations), with W1 (F, D)
// and W2 (D, F) as stored in the parameter tree.  The backward recomputes
// the hidden and returns dx, dW1, db1, dW2, db2.
//
// The kernels are ff_common.cuh's, on the layout below: a column is a row
// of x, a tile 64 consecutive rows.  What bounds them is tensor-core
// arithmetic: at M = 15·512 = 7,680 the forward is 3.02 GFLOP, 0.0183 ms
// at three TF32 passes (0.045 ms at the float32 CUDA-core peak), the
// backward 2.5× that, and the (M, 2048) hidden, never stored, would be
// 63 MB.  At that M there are only 120 row tiles for 132 SMs, so the
// forward splits the 32 hidden chunks over a cluster of blocks a tile
// (ff::fwd_cluster) and adds the partials in rank order within its one
// launch; the backward's grid is column groups × hidden groups
// (ff_common.cuh).  The
// dropout mask is the TPU kernel's, from the row's global index m: row
// m % 256 of TILE_M = 256-row tile m // 256, position (m % 256)·F + f.  So
// it matches JAX bit for bit whatever this kernel's tiling, and a ragged
// last tile needs no padding (the TPU padded rows with zeros).  Plain C
// interface, loaded with ctypes.

#include "ff_common.cuh"

namespace {

using ff::BN;
using ff::D;
using ff::FC;

constexpr int TILE_M = 256;   // the TPU kernel's row tile

// x (M, D): column c = row m.
struct RowsLayout {
  static constexpr bool kMinor = true;
  int M, F;
  uint32_t fstride;   // = 1
  __host__ __device__ int tiles() const { return (M + BN - 1) / BN; }
  __host__ __device__ int cols() const { return M; }
  __device__ ff::TileView tile_view(int t) const {
    const int m0 = t * BN;
    return {static_cast<size_t>(m0) * D, 1, D, M - m0 < BN ? M - m0 : BN};
  }
  __device__ int col(int t, int j) const {
    const int m = t * BN + j;
    return m < M ? m : -1;
  }
  __device__ size_t offset(int k, int c) const {
    return static_cast<size_t>(c) * D + k;
  }
  // ops/ff_fused.py:_keep_mask at (row m, hidden column 0)
  __device__ uint32_t hash_base(int m, uint32_t seedmix) const {
    return static_cast<uint32_t>((m % TILE_M) * F) + seedmix +
           static_cast<uint32_t>(m / TILE_M) * ff::TILE_MIX;
  }
};

RowsLayout make_layout(int M, int F) {
  RowsLayout lay;
  lay.M = M;
  lay.F = F;
  lay.fstride = 1;
  return lay;
}

bool bad_shape(int M, int F) { return M < 1 || ff::bad_width(F); }

}  // namespace

// Floats of the backward's workspace.
extern "C" long long ff_rows_backward_workspace_floats(int M, int F) {
  return ff::bwd_workspace_floats(M, (M + BN - 1) / BN, F);
}

// x, y (M, 48); w1 (F, 48); b1 (F); w2 (48, F); b2 (48); float32,
// contiguous, w1 and w2 16-byte aligned.  F a multiple of 64.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int ff_rows_forward(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* y,
                               int M, int F, unsigned seedmix,
                               unsigned thresh, float scale, int use_mask,
                               void* stream) {
  if (bad_shape(M, F)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ff::forward(
      make_layout(M, F), static_cast<const float*>(x),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(y), F,
      ff::make_mask(seedmix, thresh, scale, use_mask),
      static_cast<cudaStream_t>(stream)));
}

// g, dx like x; dw1 like w1; db1 (F); dw2 like w2; db2 (48); ws of
// ff_rows_backward_workspace_floats(M, F) floats.
extern "C" int ff_rows_backward(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* g, void* dx,
                                void* dw1, void* db1, void* dw2, void* db2,
                                void* ws, int M, int F, unsigned seedmix,
                                unsigned thresh, float scale, int use_mask,
                                void* stream) {
  if (bad_shape(M, F)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ff::backward(
      make_layout(M, F), static_cast<const float*>(x),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(g),
      static_cast<float*>(dx), static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dw2),
      static_cast<float*>(db2), static_cast<float*>(ws), F,
      ff::make_mask(seedmix, thresh, scale, use_mask),
      static_cast<cudaStream_t>(stream)));
}
