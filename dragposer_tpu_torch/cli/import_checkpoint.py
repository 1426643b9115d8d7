"""Convert the reference's PyTorch checkpoints to the native format (port
of ``dragposer_tpu/cli/import_checkpoint.py``).

Usage::

    python -m dragposer_tpu_torch.cli.import_checkpoint <reference_model_dir>
        <output_model_dir> <reference_bvh_for_skeleton>

Writes ``generator.npz`` with its means and stds and ``parameters.json``
(and ``temporal.npz`` with the latent means and stds when ``temporal.pt``
exists), the files the JAX package's CLI writes.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.models import checkpoint, torch_import


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Import reference checkpoints")
    parser.add_argument("reference_dir", type=str)
    parser.add_argument("output_dir", type=str)
    parser.add_argument("skeleton_bvh", type=str,
                        help="any .bvh with the training skeleton")
    args = parser.parse_args(argv)

    bvh = BVH().load(args.skeleton_bvh)
    _, _, parents, _, _ = encoding.info_from_bvh(bvh)

    params, means, stds = torch_import.load_generator(
        args.reference_dir, parents, cfg.VAE_PARAM)
    os.makedirs(args.output_dir, exist_ok=True)
    checkpoint.save(os.path.join(args.output_dir, "generator.npz"), params,
                    extra={"means": means, "stds": stds})
    checkpoint.save_hparams(args.output_dir, cfg.VAE_PARAM)
    print(f"wrote {args.output_dir}/generator.npz")

    if os.path.exists(os.path.join(args.reference_dir, "temporal.pt")):
        tparams, ml, sl = torch_import.load_temporal(args.reference_dir,
                                                     cfg.TEMPORAL_PARAM)
        checkpoint.save(os.path.join(args.output_dir, "temporal.npz"),
                        tparams, extra={"means_latent": np.asarray(ml),
                                        "stds_latent": np.asarray(sl)})
        print(f"wrote {args.output_dir}/temporal.npz")
    else:
        print("no temporal.pt in the reference dir (train one with "
              "cli.train_temporal)")


if __name__ == "__main__":
    main()
