"""Train the pose-generator VAE on the GPU (port of
``dragposer_tpu/cli/train_vae.py``).

Usage::

    python -m dragposer_tpu_torch.cli.train_vae <data_path> <name> [--fk]
        [--load] [--epochs N] [--models-root models] [--device cuda|cpu]

``<data_path>`` holds ``train/`` and ``eval/`` directories of .bvh clips;
the model lands in ``<models-root>/model_<name>_<datadir>/``.
"""

from __future__ import annotations

import argparse

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch.models import checkpoint
from dragposer_tpu_torch.train import vae as train_vae


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train Pose Generator VAE")
    parser.add_argument("data_path", type=str)
    parser.add_argument("name", type=str)
    parser.add_argument("--load", action="store_true",
                        help="resume from the saved checkpoint")
    parser.add_argument("--fk", action="store_true",
                        help="use the forward-kinematics loss term")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override the configured epoch count")
    parser.add_argument("--models-root", type=str, default="models")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    model_dir = checkpoint.model_paths(args.name, args.data_path,
                                       root=args.models_root)
    return train_vae.train(args.data_path, model_dir, cfg.VAE_PARAM,
                           use_fk=args.fk, epochs=args.epochs,
                           load=args.load, device=args.device)


if __name__ == "__main__":
    main()
