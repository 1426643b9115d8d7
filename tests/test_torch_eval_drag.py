"""The port's batched evaluation entry point
(``cli/eval_drag.evaluate_batched``) against the JAX package's, on two
short seeded synthetic BVH files written to ``tmp_path``, on the CPU.

The two runs start from different random latents (each package draws its
own from its own generator), and the stop rule then sends them down
different but equally good trajectories, so MPJPE and MPEEPE agree within
20% relative or 1 cm absolute.
"""

import numpy as np
import pytest
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


def _config_json(tmp_path, **extra):
    """The 6-tracker config as a JSON file, with ``extra`` keys."""
    import json

    from dragposer_tpu_torch import config as cfg

    c = cfg.SIX_TRACKERS
    d = dict(mask=list(c.mask), weights=[list(w) for w in c.weights],
             enable_joint_adjustment=c.enable_joint_adjustment,
             joint_adjustment_indices=list(c.joint_adjustment_indices),
             joint_adjustment_weight=c.joint_adjustment_weight,
             lambda_temporal=c.lambda_temporal,
             temporal_future_window=c.temporal_future_window, **extra)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(d))
    return str(path)


@pytest.mark.parametrize("config", ["3_trackers", "restarts", "branch_every"])
def test_main_refuses_restarts_and_beam(tmp_path, config):
    """A config whose defaults ask for several starts (the JAX CLI's
    restarts and beam) is refused before any model or clip is read: the
    paths given do not exist."""
    from dragposer_tpu_torch.cli import eval_drag as tev

    if config == "restarts":
        config = _config_json(tmp_path, restarts=4)
    elif config == "branch_every":
        config = _config_json(tmp_path, branch_every=64)
    missing = str(tmp_path / "missing")
    with pytest.raises(NotImplementedError, match="not ported"):
        tev.main([missing, missing + ".bvh", "--config", config,
                  "--device", "cpu"])


@pytest.mark.parametrize("config", ["6_trackers", "json"])
def test_main_runs_single_start_configs(tmp_path, capsys, config):
    from dragposer_tpu_torch.cli import eval_drag as tev

    if config == "json":
        config = _config_json(tmp_path, restarts=1, branch_every=0)
    files = chip_smoke.write_synthetic_clips(str(tmp_path), (8,), seed=3)
    res = tev.main([MODEL_DIR, *files, "--config", config, "--device",
                    "cpu", "--save-dir", str(tmp_path / "out")])
    assert len(res) == 1 and np.isfinite(res[0]).all()
    assert "frames/s" in capsys.readouterr().out
