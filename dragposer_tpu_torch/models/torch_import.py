"""Import the reference's PyTorch checkpoints into the port's parameter
trees (port of ``dragposer_tpu/models/torch_import.py``).

Reads the reference's ``generator.pt`` / ``data.pt`` / ``temporal.pt``
(layouts documented at ``python/src/train.py:257-319`` of the reference)
with ``torch.load(map_location="cpu", weights_only=True)`` — tensor data
only, no pickled code — and maps the state-dict entries onto the port's
numpy trees, under the JAX package's names.  The checkpoint's stored
convolution masks and pool/unpool matrices are checked against the port's
topology-derived statics (``vae.build_statics``): masks exactly, pool
matrices to 1e-6, which cross-checks the whole topology pipeline.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from dragposer_tpu_torch.models import vae

N_LAYERS = vae.N_LAYERS


def _torch_load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().numpy(), dtype=np.float32)


def load_generator(model_dir: str, parents, param) -> Tuple[Dict, Dict, Dict]:
    """Returns ``(vae_params, means, stds)`` from ``generator.pt`` +
    ``data.pt``."""
    sd = _torch_load(os.path.join(model_dir, "generator.pt"))[
        "model_state_dict"]
    statics = vae.build_statics(parents, param)

    def get(name):
        return _np(sd[name])

    encoder = {"convs": [], "f_mu": None, "f_logvar": None}
    for l in range(N_LAYERS):
        pre = f"autoencoder.encoder.layers.{l}"
        encoder["convs"].append({"w": get(f"{pre}.0.weight"),
                                 "b": get(f"{pre}.0.bias")})
        np.testing.assert_array_equal(
            get(f"{pre}.0.mask"), statics.enc_masks[l],
            err_msg=f"encoder conv mask mismatch at layer {l}")
        np.testing.assert_allclose(
            get(f"{pre}.1.weight"), statics.enc_pools[l], atol=1e-6,
            err_msg=f"encoder pool matrix mismatch at layer {l}")
    encoder["f_mu"] = {"w": get("autoencoder.encoder.f_mu.weight"),
                       "b": get("autoencoder.encoder.f_mu.bias")}
    encoder["f_logvar"] = {"w": get("autoencoder.encoder.f_logvar.weight"),
                           "b": get("autoencoder.encoder.f_logvar.bias")}

    decoder = {"f_latent": {"w": get("autoencoder.decoder.f_latent.weight"),
                            "b": get("autoencoder.decoder.f_latent.bias")},
               "convs": []}
    for l in range(N_LAYERS):
        pre = f"autoencoder.decoder.layers.{l}"
        np.testing.assert_allclose(
            get(f"{pre}.0.weight"), statics.dec_unpools[l], atol=1e-6,
            err_msg=f"decoder unpool matrix mismatch at layer {l}")
        decoder["convs"].append({"w": get(f"{pre}.1.weight"),
                                 "b": get(f"{pre}.1.bias")})
        np.testing.assert_array_equal(
            get(f"{pre}.1.mask"), statics.dec_masks[l],
            err_msg=f"decoder conv mask mismatch at layer {l}")

    data = _torch_load(os.path.join(model_dir, "data.pt"))
    means = {k: _np(v) for k, v in data["means"].items()}
    stds = {k: _np(v) for k, v in data["stds"].items()}
    return {"encoder": encoder, "decoder": decoder}, means, stds


def load_temporal(model_dir: str, param) -> Tuple[Dict, np.ndarray,
                                                  np.ndarray]:
    """Returns ``(temporal_params, means_latent, stds_latent)`` from
    ``temporal.pt``."""
    ckpt = _torch_load(os.path.join(model_dir, "temporal.pt"))
    sd = ckpt["model_state_dict"]

    def get(name):
        return _np(sd[name])

    def lin(prefix):
        return {"w": get(f"{prefix}.weight"), "b": get(f"{prefix}.bias")}

    def attn(prefix):
        return {"in_w": get(f"{prefix}.in_proj_weight"),
                "in_b": get(f"{prefix}.in_proj_bias"),
                "out_w": get(f"{prefix}.out_proj.weight"),
                "out_b": get(f"{prefix}.out_proj.bias")}

    def ln(prefix):
        return {"g": get(f"{prefix}.weight"), "b": get(f"{prefix}.bias")}

    enc_layers = []
    for i in range(param["n_encoder_layers"]):
        pre = f"temporal.encoder.layers.{i}"
        enc_layers.append({
            "self_attn": attn(f"{pre}.self_attn"),
            "ff1": lin(f"{pre}.linear1"), "ff2": lin(f"{pre}.linear2"),
            "ln1": ln(f"{pre}.norm1"), "ln2": ln(f"{pre}.norm2")})
    dec_layers = []
    for i in range(param["n_decoder_layers"]):
        pre = f"temporal.decoder.layers.{i}"
        dec_layers.append({
            "self_attn": attn(f"{pre}.self_attn"),
            "cross_attn": attn(f"{pre}.multihead_attn"),
            "ff1": lin(f"{pre}.linear1"), "ff2": lin(f"{pre}.linear2"),
            "ln1": ln(f"{pre}.norm1"), "ln2": ln(f"{pre}.norm2"),
            "ln3": ln(f"{pre}.norm3")})
    params = {
        "in_proj_enc": lin("in_proj_encoder"),
        "in_proj_dec": lin("in_proj_decoder"),
        "out_proj": lin("out_proj"),
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
        "enc_norm": ln("temporal.encoder.norm"),
        "dec_norm": ln("temporal.decoder.norm"),
    }
    return params, _np(ckpt["means_latent"]), _np(ckpt["stds_latent"])
