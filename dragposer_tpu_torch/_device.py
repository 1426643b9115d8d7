"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
With no GPU and no explicit ``cpu`` they raise: they never drop quietly to
the CPU.

TF32 is switched off here, for every CUDA run of the port.  The drag loss is
the numerically sensitive path: the JAX package keeps its decoder and FK
contractions at float32 ``HIGHEST`` (``docs/ARCHITECTURE.md`` §4 records
that one contraction's precision moved 4-tracker MPJPE from 0.45% to 1.44%
off the reference).  The plain float32 matmuls of the port (the folded
decoder and FK in ``drag/fast_iter.py``, the epilogue decode in
``drag/pipeline.py``, the VAE encoder, the plain twins of both kernels) all
run after :func:`resolve_device` has cleared both flags.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dragposer_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
