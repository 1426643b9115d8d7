"""Temporal latent predictor, inference only (port of
``dragposer_tpu/models/temporal.py`` ``forward`` / ``forward_T`` in eval mode).

Seq2seq transformer: d_model 48, 4 heads, 3+3 post-LN encoder/decoder
layers, ReLU feed-forward 2048, sinusoidal positional encoding.  Encoder
tokens are latent(24) ⊕ accumulated displacement(3) ⊕ heights(6); decoder
tokens are latents.  The layer math is ``torch.nn.Transformer``'s (post-norm,
final LayerNorm on both stacks); parameters keep the JAX package's tree.
Training and dropout are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def positional_encoding(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _linear(x, p):
    return x @ p["w"].T + p["b"]


def _layer_norm(x, p, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def _attention(p, q_in, kv_in, n_heads: int, mask=None):
    """Multi-head attention, torch packed-projection layout.
    q_in (..., Sq, D), kv_in (..., Sk, D), mask additive (Sq|1, Sk)."""
    d = q_in.shape[-1]
    dh = d // n_heads
    wq, wk, wv = p["in_w"].split(d, dim=0)
    bq, bk, bv = p["in_b"].split(d, dim=0)
    q = (q_in @ wq.T + bq).unflatten(-1, (n_heads, dh))     # (..., Sq, H, dh)
    k = (kv_in @ wk.T + bk).unflatten(-1, (n_heads, dh))
    v = (kv_in @ wv.T + bv).unflatten(-1, (n_heads, dh))
    scores = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(dh)
    if mask is not None:
        scores = scores + mask
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", attn, v).reshape(q_in.shape)
    return out @ p["out_w"].T + p["out_b"]


def _ff(lp, x):
    return _linear(torch.relu(_linear(x, lp["ff1"])), lp["ff2"])


def forward(params, param, latent, latent_target, tgt_mask=None):
    """latent (..., S_past, latent+3+H), latent_target (..., S_fut, latent)
    → (..., S_fut, latent).  Eval mode (no dropout)."""
    d = param["features_transformer"]
    h = param["n_heads"]
    max_len = len(param["past_frames"]) + len(param["future_frames"])
    pe = torch.as_tensor(positional_encoding(max_len, d), device=latent.device)

    src = _linear(latent, params["in_proj_enc"]) + pe[: latent.shape[-2]]
    tgt = _linear(latent_target, params["in_proj_dec"]) \
        + pe[: latent_target.shape[-2]]
    for lp in params["enc_layers"]:
        src = _layer_norm(src + _attention(lp["self_attn"], src, src, h),
                          lp["ln1"])
        src = _layer_norm(src + _ff(lp, src), lp["ln2"])
    memory = _layer_norm(src, params["enc_norm"])
    for lp in params["dec_layers"]:
        tgt = _layer_norm(
            tgt + _attention(lp["self_attn"], tgt, tgt, h, mask=tgt_mask),
            lp["ln1"])
        tgt = _layer_norm(
            tgt + _attention(lp["cross_attn"], tgt, memory, h), lp["ln2"])
        tgt = _layer_norm(tgt + _ff(lp, tgt), lp["ln3"])
    return _linear(_layer_norm(tgt, params["dec_norm"]), params["out_proj"])


def forward_T(params, param, latentT, latent_targetT, tgt_mask=None):
    """Batch-last layout of :func:`forward`: latentT (S_past, C, B),
    latent_targetT (S_fut, L, B) → (S_fut, L, B).  Same function; the port
    computes it batch-first and moves the axes."""
    out = forward(params, param, latentT.permute(2, 0, 1),
                  latent_targetT.permute(2, 0, 1), tgt_mask)
    return out.permute(1, 2, 0)
