"""DragPoser on PyTorch and CUDA: the port of ``dragposer_tpu`` for one
NVIDIA H100.

The JAX package beside it stays the reference.  This package imports
``torch`` and never ``jax`` or ``dragposer_tpu``; its entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  Its two hand-written
kernels live in ``csrc/`` and are built with ``nvcc`` at first use
(``_build.py``).
"""
