"""K2: the temporal-transformer inference forward as one CUDA kernel
(port of ``dragposer_tpu/ops/temporal_fused.py``).

:func:`pack_params` re-lays the temporal parameter tree once per model load
into math-layout ``(in, out)`` arrays, and splits every weight matrix into
the kernel's 3xTF32 operands (:func:`frag_pack`, :func:`ff_tiles`);
:func:`forward` is the
drop-in for ``models.temporal.forward`` in eval mode.  On a CUDA tensor
:func:`forward` launches ``csrc/temporal_forward.cu``, whose products run
on the tensor cores as 3xTF32 (:func:`matmul_3xtf32` is their plain
model); on a CPU tensor it runs :func:`forward_plain`, the kernel's plain
float32 PyTorch twin on the same packed weights.  ``COUNTS`` counts both.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List

import numpy as np
import torch

from dragposer_tpu_torch import _build
from dragposer_tpu_torch.models.temporal import positional_encoding

D = 48          # d_model
H = 4           # heads
DH = D // H     # 12
FF = 2048
LAYERS = 3
D_ENC = 33
D_LAT = 24
SMAX = 32       # longest sequence the kernel's builds take (csrc SMAX_LONG)
ROWS = 128      # rows a kernel block holds: G · max(S_enc, S_dec)
_EPS = 1e-5

COUNTS = _build.KernelCounts("K2")

_ENC_KEYS = ("attn_w_in", "attn_b_in", "attn_w_out", "attn_b_out",
             "ff_w1", "ff_b1", "ff_w2", "ff_b2", "ln1", "ln2")
_DEC_KEYS = ("self_w_in", "self_b_in", "self_w_out", "self_b_out",
             "cross_w_in", "cross_b_in", "cross_w_out", "cross_b_out",
             "ff_w1", "ff_b1", "ff_w2", "ff_b2", "ln1", "ln2", "ln3")
_HEAD_KEYS = ("w_in_enc", "b_in_enc", "w_in_dec", "b_in_dec", "w_out",
              "b_out", "pe", "enc_norm", "dec_norm")
# the projection matrices, split and fragment-packed for the kernel's
# mma.sync (frag_pack); the FF matrices as split wgmma tiles (ff_tiles)
_MATRICES = {"w_in_enc", "w_in_dec", "w_out", "attn_w_in", "attn_w_out",
             "self_w_in", "self_w_out", "cross_w_in", "cross_w_out"}
_FF = {"ff_w1", "ff_w2"}
FC = 64         # FF hidden columns per kernel chunk


def max_sequence(packed) -> int:
    """Longest encoder or decoder sequence :func:`forward` takes: the rows
    of the positional encoding (past + future frames, 30), as in the JAX
    package, within the kernel's ``SMAX``."""
    return min(SMAX, int(packed["pe"].shape[0]))


def lanes_per_block(s_enc: int, s_dec: int) -> int:
    """Lanes G of one kernel block (``csrc/temporal_forward.cu``
    ``lanes_per_block``): as many as fit ``ROWS`` rows."""
    return ROWS // max(s_enc, s_dec)


# ---------------------------------------------------------------------------
# 3xTF32: the kernel's tensor-core arithmetic, in plain PyTorch
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero: the rounding of PTX ``cvt.rna.tf32.f32``.  Non-finite values pass
    through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor):
    """x = hi + lo to about 2^-22 relative, hi and lo both TF32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: lo·hi + hi·lo + hi·hi of the TF32
    splits (lo·lo dropped), each product exact and summed in float32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass (the tensor cores' TF32 mode): the control
    that K2's tolerance must refuse."""
    return tf32_round(a) @ tf32_round(b)


def frag_pack(w: torch.Tensor) -> torch.Tensor:
    """A weight ``w (K, N)`` as the kernel's B fragments of
    ``mma.m16n8k8.tf32``: K padded with zeros to a multiple of 8; for each
    n-tile nn, k-step kk and lane (g = lane // 4, t = lane % 4) the float4
    {hi(r, c), hi(r + 4, c), lo(r, c), lo(r + 4, c)} of row r = 8kk + t and
    column c = 8nn + g.  Shape (N/8, K8/8, 32, 4)."""
    K, N = w.shape
    k8 = -(-K // 8) * 8
    padded = torch.zeros((k8, N), dtype=torch.float32, device=w.device)
    padded[:K] = w
    hi, lo = split_tf32(padded)
    lane = torch.arange(32, device=w.device)
    r = torch.arange(k8 // 8, device=w.device)[None, :, None] * 8 + lane % 4
    c = torch.arange(N // 8, device=w.device)[:, None, None] * 8 + lane // 4
    return torch.stack([hi[r, c], hi[r + 4, c], lo[r, c], lo[r + 4, c]],
                       dim=-1).contiguous()


def ff_tiles(w: torch.Tensor, second: bool) -> torch.Tensor:
    """An FF weight as the kernel's wgmma B tiles, split, chunk by chunk of
    FC hidden columns: [chunk][hi, lo][k-step][n-core i][k-half j][row
    r][e], the element of B (N × K, K-major) at n = 8i + r, k = 4j + e of
    the k-step.  FF1 (``w`` (48, 2048)): B = W1ᵀ of the chunk, k the input
    feature 8·kstep + 4j + e.  FF2 (``second``, ``w`` (2048, 48)): B = W2ᵀ,
    k the chunk's hidden column 8·kstep + 2e + j — the order in which
    FF1's accumulator fragment is FF2's A fragment.  Shape (32, 2, 6, 8,
    2, 8, 4) or (32, 2, 8, 6, 2, 8, 4)."""
    nch = FF // FC
    if second:   # w[FC·c + 8ks + 2e + j, 8i + r]
        tiles = w.reshape(nch, FC // 8, 4, 2, D // 8, 8) \
            .permute(0, 1, 4, 3, 5, 2)
    else:        # w[8ks + 4j + e, FC·c + 8i + r]
        tiles = w.reshape(D // 8, 2, 4, nch, FC // 8, 8) \
            .permute(3, 0, 4, 1, 5, 2)
    return torch.stack(split_tf32(tiles.contiguous()), dim=1).contiguous()


def pack_params(params: Dict, param: Dict, device) -> Dict:
    """Temporal parameter tree (numpy or tensors, torch ``(out, in)``
    convention) → the kernel's layout on ``device``: weights ``(in, out)``,
    attention in-projection ``(D, 3D)`` with columns ``[q | k | v]`` (head
    ``h`` at ``h*DH`` within each), LayerNorm ``(2, D)`` rows ``[g; b]``."""

    def a(x):
        return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                          np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    def lin(p):
        return t(a(p["w"]).T), t(a(p["b"]))

    def ln(p):
        return t(np.stack([a(p["g"]), a(p["b"])]))

    def attn(p, prefix):
        return {f"{prefix}_w_in": t(a(p["in_w"]).T),
                f"{prefix}_b_in": t(a(p["in_b"])),
                f"{prefix}_w_out": t(a(p["out_w"]).T),
                f"{prefix}_b_out": t(a(p["out_b"]))}

    def ff(lp):
        (w1, b1), (w2, b2) = lin(lp["ff1"]), lin(lp["ff2"])
        return {"ff_w1": w1, "ff_b1": b1, "ff_w2": w2, "ff_b2": b2}

    enc = [{**attn(lp["self_attn"], "attn"), **ff(lp),
            "ln1": ln(lp["ln1"]), "ln2": ln(lp["ln2"])}
           for lp in params["enc_layers"]]
    dec = [{**attn(lp["self_attn"], "self"), **attn(lp["cross_attn"], "cross"),
            **ff(lp), "ln1": ln(lp["ln1"]), "ln2": ln(lp["ln2"]),
            "ln3": ln(lp["ln3"])}
           for lp in params["dec_layers"]]
    max_len = len(param["past_frames"]) + len(param["future_frames"])
    w_in_enc, b_in_enc = lin(params["in_proj_enc"])
    w_in_dec, b_in_dec = lin(params["in_proj_dec"])
    w_out, b_out = lin(params["out_proj"])
    packed = {"w_in_enc": w_in_enc, "b_in_enc": b_in_enc,
              "w_in_dec": w_in_dec, "b_in_dec": b_in_dec,
              "w_out": w_out, "b_out": b_out,
              "pe": t(positional_encoding(max_len, D)),
              "enc_norm": ln(params["enc_norm"]),
              "dec_norm": ln(params["dec_norm"]),
              "enc": enc, "dec": dec}
    _check_packed(packed)
    packed["kernel_table"] = [_for_kernel(k, p) for k, p in _weights(packed)]
    return packed


def _weights(packed):
    """(key, float32 array) in the kernel's pointer table order
    (``csrc/temporal_forward.cu`` enums)."""
    out = [(k, packed[k]) for k in _HEAD_KEYS]
    for lp in packed["enc"]:
        out += [(k, lp[k]) for k in _ENC_KEYS]
    for lp in packed["dec"]:
        out += [(k, lp[k]) for k in _DEC_KEYS]
    return out


def _for_kernel(key: str, p: torch.Tensor) -> torch.Tensor:
    if key in _MATRICES:
        return frag_pack(p)
    if key in _FF:
        return ff_tiles(p, second=key == "ff_w2")
    return p


def _pointers(packed) -> List[torch.Tensor]:
    """The kernel's pointer table: projection matrices fragment-packed and
    split (:func:`frag_pack`), FF matrices as split wgmma tiles
    (:func:`ff_tiles`), the rest as in the packed tree."""
    return packed["kernel_table"]


def _check_packed(packed) -> None:
    shapes = {"w_in_enc": (D_ENC, D), "w_in_dec": (D_LAT, D),
              "w_out": (D, D_LAT), "enc_norm": (2, D), "dec_norm": (2, D)}
    for k, s in shapes.items():
        if tuple(packed[k].shape) != s:
            raise ValueError(f"packed {k}: {tuple(packed[k].shape)} != {s}")
    if len(packed["enc"]) != LAYERS or len(packed["dec"]) != LAYERS:
        raise ValueError("the kernel takes 3 encoder and 3 decoder layers")
    for lp in packed["enc"] + packed["dec"]:
        if tuple(lp["ff_w1"].shape) != (D, FF):
            raise ValueError(f"ff_w1 {tuple(lp['ff_w1'].shape)} != {(D, FF)}")


# ---------------------------------------------------------------------------
# Plain PyTorch twin (same packed weights, same formulas)
# ---------------------------------------------------------------------------

def _ln(x, gb):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + _EPS) * gb[0] + gb[1]


def _mha(mm, xq, xkv, w_in, b_in, w_out, b_out, mask=None):
    q = (mm(xq, w_in[:, :D]) + b_in[:D]).unflatten(-1, (H, DH))
    k = (mm(xkv, w_in[:, D:2 * D]) + b_in[D:2 * D]).unflatten(-1, (H, DH))
    v = (mm(xkv, w_in[:, 2 * D:]) + b_in[2 * D:]).unflatten(-1, (H, DH))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(DH)
    if mask is not None:
        s = s + mask
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return mm(o.flatten(-2), w_out) + b_out


def _ff(mm, x, lp):
    return mm(torch.relu(mm(x, lp["ff_w1"]) + lp["ff_b1"]), lp["ff_w2"]) \
        + lp["ff_b2"]


def forward_plain(packed, enc_in, dec_in, tgt_mask, mm=torch.matmul):
    """The kernel's plain twin: enc_in (B, S_enc, 33), dec_in (B, S_dec, 24),
    additive tgt_mask (1, S_dec) or (S_dec, S_dec) → (B, S_dec, 24).
    ``mm`` forms every weight product (:func:`matmul_3xtf32` models the
    kernel's tensor cores); attention scores and values stay float32."""
    COUNTS.plain += 1
    pe = packed["pe"]
    src = mm(enc_in, packed["w_in_enc"]) + packed["b_in_enc"] \
        + pe[: enc_in.shape[1]]
    for lp in packed["enc"]:
        a = _mha(mm, src, src, lp["attn_w_in"], lp["attn_b_in"],
                 lp["attn_w_out"], lp["attn_b_out"])
        src = _ln(src + a, lp["ln1"])
        src = _ln(src + _ff(mm, src, lp), lp["ln2"])
    memory = _ln(src, packed["enc_norm"])
    tgt = mm(dec_in, packed["w_in_dec"]) + packed["b_in_dec"] \
        + pe[: dec_in.shape[1]]
    for lp in packed["dec"]:
        a = _mha(mm, tgt, tgt, lp["self_w_in"], lp["self_b_in"],
                 lp["self_w_out"], lp["self_b_out"], mask=tgt_mask)
        tgt = _ln(tgt + a, lp["ln1"])
        a = _mha(mm, tgt, memory, lp["cross_w_in"], lp["cross_b_in"],
                 lp["cross_w_out"], lp["cross_b_out"])
        tgt = _ln(tgt + a, lp["ln2"])
        tgt = _ln(tgt + _ff(mm, tgt, lp), lp["ln3"])
    return mm(_ln(tgt, packed["dec_norm"]), packed["w_out"]) \
        + packed["b_out"]


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _declare(lib):
    fn = lib.temporal_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.temporal_forward_n_pointers.restype = ctypes.c_int
    lib.temporal_forward_max_sequence.restype = ctypes.c_int
    if lib.temporal_forward_max_sequence() != SMAX:
        raise RuntimeError("temporal_forward's longest sequence does not "
                           "match SMAX")
    lib.temporal_forward_lanes_per_block.argtypes = [ctypes.c_int,
                                                     ctypes.c_int]
    lib.temporal_forward_lanes_per_block.restype = ctypes.c_int


def _library():
    return _build.load("temporal_forward", _declare)


def _check_call(packed, enc_in, dec_in, tgt_mask) -> None:
    """What the kernel takes; checked on every device, so the CPU tests
    hold the callers to it too."""
    B, s_enc = enc_in.shape[0], enc_in.shape[1]
    s_dec = dec_in.shape[1]
    dev = enc_in.device
    longest = max_sequence(packed)
    if not (1 <= s_enc <= longest and 1 <= s_dec <= longest):
        raise ValueError(f"sequence lengths {s_enc}, {s_dec} outside "
                         f"1..{longest} (the positional encoding's rows)")
    _build.check_tensor("enc_in", enc_in, (B, s_enc, D_ENC), dev)
    _build.check_tensor("dec_in", dec_in, (B, s_dec, D_LAT), dev)
    if tgt_mask.dim() != 2 or tgt_mask.shape[0] not in (1, s_dec):
        raise ValueError(f"tgt_mask {tuple(tgt_mask.shape)}: (1, S_dec) or "
                         "(S_dec, S_dec) expected")
    _build.check_tensor("tgt_mask", tgt_mask, (tgt_mask.shape[0], s_dec),
                        dev)
    for p in _pointers(packed):
        _build.check_tensor("packed weight", p, p.shape, dev)


def forward_kernel(packed, enc_in, dec_in, tgt_mask):
    """Launch ``csrc/temporal_forward.cu`` on the current stream (inputs
    checked by :func:`forward`)."""
    B, s_enc = enc_in.shape[0], enc_in.shape[1]
    s_dec = dec_in.shape[1]
    dev = enc_in.device
    ptrs = _pointers(packed)
    lib = _library()
    if lib.temporal_forward_n_pointers() != len(ptrs):
        raise RuntimeError("pointer table does not match the kernel")
    table = (ctypes.c_void_p * len(ptrs))(*[p.data_ptr() for p in ptrs])
    out = torch.empty((B, s_dec, D_LAT), dtype=torch.float32, device=dev)
    err = lib.temporal_forward(
        ctypes.addressof(table), enc_in.data_ptr(), dec_in.data_ptr(),
        tgt_mask.data_ptr(), int(tgt_mask.shape[0]), out.data_ptr(), B,
        s_enc, s_dec, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "temporal_forward")
    COUNTS.kernel += 1
    return out


def forward(packed: Dict, param: Dict, enc_in, dec_in, tgt_mask):
    """Drop-in inference equivalent of ``models.temporal.forward``:
    enc_in (B, S_enc, latent+3+H), dec_in (B, S_dec, latent), additive
    tgt_mask (1, S_dec) or (S_dec, S_dec) → (B, S_dec, latent).

    A CUDA input launches the kernel (or raises); a CPU input runs the
    plain twin.  ``param`` is accepted for signature parity."""
    _check_call(packed, enc_in, dec_in, tgt_mask)
    if enc_in.is_cuda:
        return forward_kernel(packed, enc_in, dec_in, tgt_mask)
    return forward_plain(packed, enc_in, dec_in, tgt_mask)
