"""Multi-device execution: meshes, sharded batched eval (port of
``dragposer_tpu/parallel``)."""
