"""K2: the temporal-transformer inference forward as one CUDA kernel
(port of ``dragposer_tpu/ops/temporal_fused.py``).

:func:`pack_params` re-lays the temporal parameter tree once per model load
into math-layout ``(in, out)`` arrays; :func:`forward` is the drop-in for
``models.temporal.forward`` in eval mode.  On a CUDA tensor :func:`forward`
launches ``csrc/temporal_forward.cu``; on a CPU tensor it runs
:func:`forward_plain`, the kernel's plain PyTorch twin on the same packed
weights.  ``COUNTS`` counts both.
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
SMAX = 16       # longest sequence the kernel takes
_EPS = 1e-5

COUNTS = _build.KernelCounts()

_ENC_KEYS = ("attn_w_in", "attn_b_in", "attn_w_out", "attn_b_out",
             "ff_w1", "ff_b1", "ff_w2", "ff_b2", "ln1", "ln2")
_DEC_KEYS = ("self_w_in", "self_b_in", "self_w_out", "self_b_out",
             "cross_w_in", "cross_b_in", "cross_w_out", "cross_b_out",
             "ff_w1", "ff_b1", "ff_w2", "ff_b2", "ln1", "ln2", "ln3")
_HEAD_KEYS = ("w_in_enc", "b_in_enc", "w_in_dec", "b_in_dec", "w_out",
              "b_out", "pe", "enc_norm", "dec_norm")


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
    return packed


def _pointers(packed) -> List[torch.Tensor]:
    """The kernel's pointer table order (``csrc/temporal_forward.cu`` enums)."""
    out = [packed[k] for k in _HEAD_KEYS]
    for lp in packed["enc"]:
        out += [lp[k] for k in _ENC_KEYS]
    for lp in packed["dec"]:
        out += [lp[k] for k in _DEC_KEYS]
    return out


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


def _mha(xq, xkv, w_in, b_in, w_out, b_out, mask=None):
    q = (xq @ w_in[:, :D] + b_in[:D]).unflatten(-1, (H, DH))
    k = (xkv @ w_in[:, D:2 * D] + b_in[D:2 * D]).unflatten(-1, (H, DH))
    v = (xkv @ w_in[:, 2 * D:] + b_in[2 * D:]).unflatten(-1, (H, DH))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(DH)
    if mask is not None:
        s = s + mask
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.flatten(-2) @ w_out + b_out


def _ff(x, lp):
    return torch.relu(x @ lp["ff_w1"] + lp["ff_b1"]) @ lp["ff_w2"] \
        + lp["ff_b2"]


def forward_plain(packed, enc_in, dec_in, tgt_mask):
    """The kernel's plain twin: enc_in (B, S_enc, 33), dec_in (B, S_dec, 24),
    additive tgt_mask (1, S_dec) or (S_dec, S_dec) → (B, S_dec, 24)."""
    COUNTS.plain += 1
    pe = packed["pe"]
    src = enc_in @ packed["w_in_enc"] + packed["b_in_enc"] \
        + pe[: enc_in.shape[1]]
    for lp in packed["enc"]:
        a = _mha(src, src, lp["attn_w_in"], lp["attn_b_in"],
                 lp["attn_w_out"], lp["attn_b_out"])
        src = _ln(src + a, lp["ln1"])
        src = _ln(src + _ff(src, lp), lp["ln2"])
    memory = _ln(src, packed["enc_norm"])
    tgt = dec_in @ packed["w_in_dec"] + packed["b_in_dec"] \
        + pe[: dec_in.shape[1]]
    for lp in packed["dec"]:
        a = _mha(tgt, tgt, lp["self_w_in"], lp["self_b_in"],
                 lp["self_w_out"], lp["self_b_out"], mask=tgt_mask)
        tgt = _ln(tgt + a, lp["ln1"])
        a = _mha(tgt, memory, lp["cross_w_in"], lp["cross_b_in"],
                 lp["cross_w_out"], lp["cross_b_out"])
        tgt = _ln(tgt + a, lp["ln2"])
        tgt = _ln(tgt + _ff(tgt, lp), lp["ln3"])
    return _ln(tgt, packed["dec_norm"]) @ packed["w_out"] + packed["b_out"]


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


def _library():
    return _build.load("temporal_forward", _declare)


def _check_call(packed, enc_in, dec_in, tgt_mask) -> None:
    """What the kernel takes; checked on every device, so the CPU tests
    hold the callers to it too."""
    B, s_enc = enc_in.shape[0], enc_in.shape[1]
    s_dec = dec_in.shape[1]
    dev = enc_in.device
    if not (1 <= s_enc <= SMAX and 1 <= s_dec <= SMAX):
        raise ValueError(f"sequence lengths {s_enc}, {s_dec} outside "
                         f"1..{SMAX}")
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
