"""Temporal latent predictor (port of ``dragposer_tpu/models/temporal.py``).

Seq2seq transformer: d_model 48, 4 heads, 3+3 post-LN encoder/decoder
layers, ReLU feed-forward 2048, sinusoidal positional encoding.  Encoder
tokens are latent(24) ⊕ accumulated displacement(3) ⊕ heights(6); decoder
tokens are latents.  The layer math is ``torch.nn.Transformer``'s (post-norm,
final LayerNorm on both stacks); parameters keep the JAX package's tree.

:func:`forward` is the rows layout, activations (B, S, D): the eval
forward, and with ``train=True`` the rows-layout training forward (JAX
``forward(train=True, fused_ff=True)``): counter-hash dropout at the JAX
package's sites and in its seed order, the feed-forwards through K3a/K3b
(``ops/ff_fused.ff_dropout_seeded``), attention as plain tensor code.
:func:`forward_T` with ``train=True`` is the lanes-layout training forward:
activations (S, D, B), the same sites, the feed-forwards through K3c/K3d
and, at dropout 0, the attention core through K4 (``ops/attn_fused``).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from dragposer_tpu_torch.ops import attn_fused, ff_fused, hash_dropout


def positional_encoding(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def linear(x, p):
    """Torch convention: y = x @ Wᵀ + b, ``p`` a ``{"w": (out, in), "b"}``
    dict."""
    return x @ p["w"].T + p["b"]


def _layer_norm(x, p, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def _attention(p, q_in, kv_in, n_heads: int, mask=None, rate: float = 0.0,
               seed: int = 0, train: bool = False):
    """Multi-head attention, torch packed-projection layout.
    q_in (..., Sq, D), kv_in (..., Sk, D), mask additive (Sq|1, Sk).  In
    training, dropout on the probabilities (torch MHA's site), hashed over
    their flat (..., H, Sq, Sk) positions."""
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
    attn = hash_dropout.dropout(torch.softmax(scores, dim=-1), rate, seed,
                                train)
    out = torch.einsum("...hqk,...khd->...qhd", attn, v).reshape(q_in.shape)
    return out @ p["out_w"].T + p["out_b"]


def _ff(lp, x):
    return linear(torch.relu(linear(x, lp["ff1"])), lp["ff2"])


def forward(params, param, latent, latent_target, tgt_mask=None, *,
            train: bool = False, seeds: Optional[Sequence[int]] = None):
    """latent (..., S_past, latent+3+H), latent_target (..., S_fut, latent)
    → (..., S_fut, latent).

    Eval mode by default.  With ``train`` it is JAX ``forward(train=True,
    fused_ff=True)``: dropout at every site in JAX's order, each site's
    mask indexed by the flat C-order position of its tensor, the
    feed-forwards through K3a/K3b with their site's seed.  ``seeds`` holds
    the 64 per-site seeds, consumed one per site, fused sites included (JAX
    draws threefry bits at the other sites: same distribution, other
    bits)."""
    if train and seeds is None:
        raise ValueError("the training forward needs its dropout seeds")
    d = param["features_transformer"]
    h = param["n_heads"]
    rate = param["dropout"] if train else 0.0
    max_len = len(param["past_frames"]) + len(param["future_frames"])
    pe = torch.as_tensor(positional_encoding(max_len, d), device=latent.device)
    nk = iter(seeds).__next__ if train else (lambda: 0)

    def drop(x, seed):
        return hash_dropout.dropout(x, rate, seed, train)

    def ff(lp, x, seed):
        if train:
            return ff_fused.ff_dropout_seeded(x, lp["ff1"], lp["ff2"], rate,
                                              seed)
        return _ff(lp, x)

    def attn(p, q_in, kv_in, mask=None):
        return _attention(p, q_in, kv_in, h, mask, rate, nk(), train)

    src = linear(drop(latent, nk()), params["in_proj_enc"])  # in_dropout
    tgt = linear(latent_target, params["in_proj_dec"])
    src = drop(src + pe[: latent.shape[-2]], nk())
    tgt = drop(tgt + pe[: latent_target.shape[-2]], nk())
    for lp in params["enc_layers"]:
        src = _layer_norm(src + drop(attn(lp["self_attn"], src, src), nk()),
                          lp["ln1"])
        src = _layer_norm(src + drop(ff(lp, src, nk()), nk()), lp["ln2"])
    memory = _layer_norm(src, params["enc_norm"])
    for lp in params["dec_layers"]:
        tgt = _layer_norm(
            tgt + drop(attn(lp["self_attn"], tgt, tgt, tgt_mask), nk()),
            lp["ln1"])
        tgt = _layer_norm(
            tgt + drop(attn(lp["cross_attn"], tgt, memory), nk()), lp["ln2"])
        tgt = _layer_norm(tgt + drop(ff(lp, tgt, nk()), nk()), lp["ln3"])
    return linear(_layer_norm(tgt, params["dec_norm"]), params["out_proj"])


def forward_T(params, param, latentT, latent_targetT, tgt_mask=None, *,
              train: bool = False, seeds: Optional[Sequence[int]] = None):
    """Batch-last layout of :func:`forward`: latentT (S_past, C, B),
    latent_targetT (S_fut, L, B) → (S_fut, L, B).

    In eval mode it is the same function as :func:`forward`, computed
    batch-first with the axes moved.  With ``train`` it computes in the
    lanes layout as JAX ``forward_T`` does with its TPU defaults
    (``fused_ff``, ``fused_attn``): dropout at every site, each site's mask
    indexed by the flat C-order position of its (S, D, B) (or
    (Sq, Sk, h, B)) tensor.  ``seeds`` holds the 64 per-site seeds (for
    example JAX's ``seeds_for(rng, 64)``), consumed in the JAX order, one
    per site, fused sites included."""
    if not train:
        out = forward(params, param, latentT.permute(2, 0, 1),
                      latent_targetT.permute(2, 0, 1), tgt_mask)
        return out.permute(1, 2, 0)
    if seeds is None:
        raise ValueError("the training forward needs its dropout seeds")
    return _forward_lanes(params, param, latentT, latent_targetT, tgt_mask,
                          iter(seeds))


# ---------------------------------------------------------------------------
# Lanes layout (S, D, B): the training forward
# ---------------------------------------------------------------------------

def _lin_T(x, p):
    """x (S, I, B) → (S, O, B)."""
    return torch.einsum("oi,sib->sob", p["w"], x) + p["b"][None, :, None]


def _ln_T(x, p, eps: float = 1e-5):
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"][None, :, None] \
        + p["b"][None, :, None]


def _attn_T(p, q_in, kv_in, n_heads: int, rate: float, seed: int,
            mask=None):
    """Attention on (S, D, B) activations.  At rate 0 the core is K4; the
    kernel has no dropout, and torch applies dropout to the probabilities,
    so at rate > 0 the core takes the plain path (the JAX package's rule,
    models/temporal.py _attn_T)."""
    d = q_in.shape[1]
    dh = d // n_heads
    wq, wk, wv = p["in_w"].split(d, dim=0)
    bq, bk, bv = p["in_b"].split(d, dim=0)

    def proj(x, w, b):
        y = torch.einsum("oi,sib->sob", w, x) + b[None, :, None]
        return y.reshape(x.shape[0], n_heads, dh, -1).contiguous()

    q, k, v = proj(q_in, wq, bq), proj(kv_in, wk, bk), proj(kv_in, wv, bv)
    if rate == 0.0:
        o = attn_fused.attn_core_lanes(q, k, v, mask)
    else:
        s = (q[:, None] * k[None, :]).sum(dim=3) / math.sqrt(dh)
        if mask is not None:
            s = s + mask[:, :, None, None]                 # (Sq, Sk, h, B)
        a = torch.softmax(s, dim=1)
        a = hash_dropout.dropout(a, rate, seed, True)      # torch MHA site
        o = (a[:, :, :, None] * v[None]).sum(dim=1)        # (Sq, h, dh, B)
    o = o.reshape(q_in.shape[0], d, -1)
    return torch.einsum("oi,sib->sob", p["out_w"], o) \
        + p["out_b"][None, :, None]


def _ff_T(lp, x, rate: float, seed: int):
    """Feed-forward on (S, D, B) activations through K3."""
    return ff_fused.ff_dropout_lanes(x.contiguous(), lp["ff1"], lp["ff2"],
                                     rate, seed)


def _forward_lanes(params, param, latentT, latent_targetT, tgt_mask,
                   seeds: Iterator[int]):
    d = param["features_transformer"]
    h = param["n_heads"]
    rate = param["dropout"]
    max_len = len(param["past_frames"]) + len(param["future_frames"])
    pe = torch.as_tensor(positional_encoding(max_len, d),
                         device=latentT.device)
    nk = lambda: next(seeds)  # noqa: E731

    def drop(x, seed):
        return hash_dropout.dropout(x, rate, seed, True)

    src = drop(latentT, nk())                          # in_dropout (enc only)
    src = _lin_T(src, params["in_proj_enc"])
    tgt = _lin_T(latent_targetT, params["in_proj_dec"])
    src = drop(src + pe[: src.shape[0], :, None], nk())
    tgt = drop(tgt + pe[: tgt.shape[0], :, None], nk())

    for lp in params["enc_layers"]:
        a = _attn_T(lp["self_attn"], src, src, h, rate, nk())
        src = _ln_T(src + drop(a, nk()), lp["ln1"])
        f = _ff_T(lp, src, rate, nk())
        src = _ln_T(src + drop(f, nk()), lp["ln2"])
    memory = _ln_T(src, params["enc_norm"])

    for lp in params["dec_layers"]:
        a = _attn_T(lp["self_attn"], tgt, tgt, h, rate, nk(), mask=tgt_mask)
        tgt = _ln_T(tgt + drop(a, nk()), lp["ln1"])
        a = _attn_T(lp["cross_attn"], tgt, memory, h, rate, nk())
        tgt = _ln_T(tgt + drop(a, nk()), lp["ln2"])
        f = _ff_T(lp, tgt, rate, nk())
        tgt = _ln_T(tgt + drop(f, nk()), lp["ln3"])
    out = _ln_T(tgt, params["dec_norm"])
    return _lin_T(out, params["out_proj"])


# ---------------------------------------------------------------------------
# Init, masks and the parameter tree
# ---------------------------------------------------------------------------

def causal_mask(size: int, device="cpu"):
    """(S, S) additive mask: 0 on/below the diagonal, -inf above."""
    tril = torch.tril(torch.ones((size, size), dtype=torch.bool,
                                 device=device))
    return torch.where(tril, 0.0, float("-inf")).to(torch.float32)


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * bound


def _xavier(gen, shape):
    fan_in, fan_out = shape[1], shape[0]
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def _init_attention(gen, d):
    return {"in_w": _xavier(gen, (3 * d, d)), "in_b": torch.zeros(3 * d),
            "out_w": _xavier(gen, (d, d)), "out_b": torch.zeros(d)}


def _init_linear_kaiming(gen, in_dim, out_dim):
    """FF linears inside nn.Transformer: xavier weight, U(±1/√fan_in) bias."""
    return {"w": _xavier(gen, (out_dim, in_dim)),
            "b": _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim))}


def _init_linear_torch(gen, in_dim, out_dim):
    """Plain ``nn.Linear`` default: U(±1/√fan_in) weight and bias (the outer
    projections live outside nn.Transformer's xavier pass)."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(gen, (out_dim, in_dim), bound),
            "b": _uniform(gen, (out_dim,), bound)}


def _init_ln(d):
    return {"g": torch.ones(d), "b": torch.zeros(d)}


def init_params(generator: torch.Generator, param, device="cpu"):
    """A fresh parameter tree (the JAX package's distributions, drawn from
    a CPU ``torch.Generator``), as leaf tensors on ``device`` that require
    gradients."""
    d = param["features_transformer"]
    ff = param["dim_feedforward"]
    latent = param["latent_dim"]
    extra = 3 + len(param["height_indices"])
    gen = generator

    def enc_layer():
        return {"self_attn": _init_attention(gen, d),
                "ff1": _init_linear_kaiming(gen, d, ff),
                "ff2": _init_linear_kaiming(gen, ff, d),
                "ln1": _init_ln(d), "ln2": _init_ln(d)}

    def dec_layer():
        return {"self_attn": _init_attention(gen, d),
                "cross_attn": _init_attention(gen, d),
                "ff1": _init_linear_kaiming(gen, d, ff),
                "ff2": _init_linear_kaiming(gen, ff, d),
                "ln1": _init_ln(d), "ln2": _init_ln(d), "ln3": _init_ln(d)}

    tree = {
        "in_proj_enc": _init_linear_torch(gen, latent + extra, d),
        "in_proj_dec": _init_linear_torch(gen, latent, d),
        "out_proj": _init_linear_torch(gen, d, latent),
        "enc_layers": [enc_layer() for _ in range(param["n_encoder_layers"])],
        "dec_layers": [dec_layer() for _ in range(param["n_decoder_layers"])],
        "enc_norm": _init_ln(d),
        "dec_norm": _init_ln(d),
    }
    return trainable(tree, device)


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in a fixed order, paths as in the checkpoint
    (``enc_layers/0/ff1/w``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def trainable(tree, device):
    """The same tree as float32 leaf tensors on ``device`` with
    ``requires_grad`` (numpy or tensor leaves in)."""
    if isinstance(tree, dict):
        return {k: trainable(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [trainable(v, device) for v in tree]
    t = torch.tensor(np.asarray(tree.detach().cpu() if torch.is_tensor(tree)
                                else tree), dtype=torch.float32)
    return t.to(device).requires_grad_(True)


def count_params(params) -> int:
    return sum(int(np.prod(t.shape)) for _, t in named_leaves(params))
