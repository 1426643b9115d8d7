"""Operations and bytes of the port's kernels, counted from their shapes,
and the least time the card could take for them (``peaks.json``).

The products run at float32 accuracy on the tensor cores as three TF32
passes (hi·hi + hi·lo + lo·hi), so their peak is a third of the TF32 rate;
the rest runs on the CUDA cores.  A launch's least time is the larger of its
operations' time and its bytes' time; the operations' time is the larger of
the products' and the rest's, as the two kinds of core run side by side.
"""

from __future__ import annotations

import os

from benchmark.harness import HERE, load_json

PEAKS = load_json(os.path.join(HERE, "peaks.json"))
PRODUCTS_PEAK = (PEAKS["tf32_tensor_flops_per_s"]
                 / PEAKS["float32_products_passes"])
CUDA_CORE_PEAK = PEAKS["float32_cuda_core_flops_per_s"]
HBM = PEAKS["hbm_bytes_per_s"]
F32 = 4


def k1_step_flops(J: int, L: int, H1: int, H2: int) -> tuple:
    """(products, the rest) of one Adam step of one lane: the decoder
    forward and its transposed backward, 2 operations a multiply-add; the
    rest (quaternions, FK, the loss and their reverse, ~350 a joint; the
    temporal term and Adam, ~15 a latent dimension) is an estimate."""
    macs = L * H1 + H1 * H2 + H2 * (4 * J + 3)
    return 2 * 2 * macs, 350 * J + 15 * L


def k1_lane_bytes(J: int, L: int) -> int:
    """Bytes a launch reads and writes for one lane: the Adam carry in and
    out, the targets, the root rotation, the temporal target and the loss
    terms of the decoded latent."""
    carry = 4 * L + 5
    inputs = carry + 4 + 3 * J + 9 * J + L
    outputs = carry + 3 + 3 + 4 + 3 * J + 4 * J + 2
    return F32 * (inputs + outputs) + 1


def k1_weight_bytes(J: int, L: int, H1: int, H2: int) -> int:
    return F32 * (L * H1 + H1 + H1 * H2 + H2 + H2 * (4 * J + 4) + 4 * J + 4)


def k2_lane_flops(s_enc: int, s_dec: int, d=48, ff=2048, heads=4, layers=3,
                  d_enc=33, d_lat=24) -> tuple:
    """(products, attention) of the temporal forward for one lane: the
    weight products and the scores and values of every attention."""
    dh = d // heads

    def proj(sq, kv_rows):
        return 2 * (sq * d * d + kv_rows * d * 2 * d + sq * d * d)

    def core(sq, sk):
        return 2 * 2 * heads * sq * sk * dh

    def ffn(rows):
        return 2 * rows * d * ff * 2

    products = (2 * s_enc * d_enc * d + 2 * s_dec * d_lat * d
                + 2 * s_dec * d * d_lat
                + layers * (proj(s_enc, s_enc) + ffn(s_enc)
                            + proj(s_dec, s_dec) + proj(s_dec, s_enc)
                            + ffn(s_dec)))
    attention = layers * (core(s_enc, s_enc) + core(s_dec, s_dec)
                          + core(s_dec, s_enc))
    return products, attention


def k2_weight_bytes(d=48, ff=2048, layers=3, d_enc=33, d_lat=24) -> int:
    attn = 4 * d * d + 4 * d
    ffn = 2 * d * ff + ff + d
    norm = 2 * d
    return F32 * (layers * (attn + ffn + 2 * norm)
                  + layers * (2 * attn + ffn + 3 * norm)
                  + d_enc * d + d + d_lat * d + d + d * d_lat + d_lat
                  + 2 * norm)


def k2_lane_bytes(s_enc: int, s_dec: int, d_enc=33, d_lat=24) -> int:
    return F32 * (s_enc * d_enc + 2 * s_dec * d_lat)


def decode_flops(J: int, L: int, H1: int, H2: int) -> int:
    """The epilogue's decode of one frame: three dense layers."""
    return 2 * (L * H1 + H1 * H2 + H2 * (4 * J + 4))


def least_seconds(products: float, rest: float, nbytes: float) -> float:
    ops = max(products / PRODUCTS_PEAK, rest / CUDA_CORE_PEAK)
    return max(ops, nbytes / HBM)
