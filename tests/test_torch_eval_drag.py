"""The port's batched evaluation entry point
(``cli/eval_drag.evaluate_batched``) against the JAX package's, on two
short seeded synthetic BVH files written to ``tmp_path``, on the CPU.

The two runs start from different random latents (each package draws its
own from its own generator), and the stop rule then sends them down
different but equally good trajectories, so MPJPE and MPEEPE agree within
20% relative or 1 cm absolute.
"""

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"


def test_evaluate_batched_matches_jax(tmp_path, capsys):
    from dragposer_tpu.cli import eval_drag as jev
    from dragposer_tpu.data import encoding as jenc
    from dragposer_tpu.io.bvh import BVH
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    files = chip_smoke.write_synthetic_clips(str(tmp_path), (14, 10), seed=7)
    first = BVH().load(files[0])
    _, _, parents, offsets, _ = jenc.info_from_bvh(first)
    je, jm, js = jev.build_engine(MODEL_DIR, parents,
                                  jev.resolve_config("6_trackers"),
                                  skeleton=JS.build(parents, offsets,
                                                    first.names))
    te, tm, ts = tev.build_engine(MODEL_DIR, parents,
                                  tev.resolve_config("6_trackers"),
                                  skeleton=TS.build(parents, offsets,
                                                    first.names),
                                  device="cpu")
    ref = jev.evaluate_batched(je, jm, js, je.skeleton, files,
                               save_dir=str(tmp_path / "jax"),
                               mesh_devices=1)
    got = tev.evaluate_batched(te, tm, ts, te.skeleton, files,
                               save_dir=str(tmp_path / "torch"))
    assert "frames/s" in capsys.readouterr().out
    for (mt, et), (mj, ej) in zip(got, ref):
        assert np.isfinite([mt, et]).all()
        assert abs(mt - mj) <= max(0.2 * mj, 0.01), (mt, mj)
        assert abs(et - ej) <= max(0.2 * ej, 0.01), (et, ej)
