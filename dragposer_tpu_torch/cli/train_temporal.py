"""Train the temporal latent predictor on the GPU (port of
``dragposer_tpu/cli/train_temporal.py``).

Usage::

    python -m dragposer_tpu_torch.cli.train_temporal <data_path> <name>
        [--load] [--epochs N] [--models-root models] [--seed S]
        [--device cuda|cpu]

``<data_path>`` holds ``train/`` and ``eval/`` directories of .bvh clips;
the model directory ``<models-root>/model_<name>_<datadir>`` must hold the
generator (``generator.npz``) the latents come from.
"""

from __future__ import annotations

import argparse

from dragposer_tpu_torch.models import checkpoint
from dragposer_tpu_torch.train import temporal as train_temporal


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train Temporal Network")
    parser.add_argument("data_path", type=str)
    parser.add_argument("name", type=str)
    parser.add_argument("--load", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--models-root", type=str, default="models")
    parser.add_argument("--seed", type=int, default=None,
                        help="init-seed override (default: the recipe's "
                             "seed, 2222)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    model_dir = checkpoint.model_paths(args.name, args.data_path,
                                       root=args.models_root)
    return train_temporal.train(args.data_path, model_dir,
                                epochs=args.epochs, load=args.load,
                                seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
