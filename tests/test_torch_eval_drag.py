"""The port's evaluation entry points (``cli/eval_drag``: ``main``,
``evaluate_file``, ``evaluate_batched``) and the metrics and export they
use, against the JAX package's, on short seeded synthetic BVH files written
to ``tmp_path``, on the CPU.

The two packages start from different random latents (each draws its own
from its own generator), and the stop rule then sends them down different
but equally good trajectories, so MPJPE and MPEEPE agree within 20%
relative or 1 cm absolute.  Jitter is held to 1e-5 relative and the
export with incremental root rotations to the tolerances of
``tests/test_torch_train_vae.py``'s export test.
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
def test_main_runs_restarts_and_beam(tmp_path, capsys, config):
    """A config whose defaults ask for several starts runs them, on one
    8-frame file: ``3_trackers`` (the 64-lane beam), a JSON config's
    ``restarts`` (restarts through the pipelined batch) and its
    ``branch_every`` with ``restarts`` (the beam, resampled)."""
    from dragposer_tpu_torch.cli import eval_drag as tev

    if config == "restarts":
        config = _config_json(tmp_path, restarts=4)
    elif config == "branch_every":
        config = _config_json(tmp_path, restarts=4, branch_every=4)
    files = chip_smoke.write_synthetic_clips(str(tmp_path), (8,), seed=3)
    res = tev.main([MODEL_DIR, *files, "--config", config, "--device",
                    "cpu", "--save-dir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "restarts: kept" in out or "hypotheses:" in out
    assert len(res) == 1 and np.isfinite(res[0]).all()


@pytest.mark.parametrize("config", ["6_trackers", "json"])
def test_main_runs_single_start_configs(tmp_path, capsys, config):
    """One file without ``--batch`` goes through ``evaluate_file`` (the
    anchor ``engine.run``), as in the JAX CLI."""
    from dragposer_tpu_torch.cli import eval_drag as tev

    if config == "json":
        config = _config_json(tmp_path, restarts=1, branch_every=0)
    files = chip_smoke.write_synthetic_clips(str(tmp_path), (8,), seed=3)
    res = tev.main([MODEL_DIR, *files, "--config", config, "--device",
                    "cpu", "--save-dir", str(tmp_path / "out")])
    assert len(res) == 1 and np.isfinite(res[0]).all()
    out = capsys.readouterr().out
    assert "Time:" in out and "Jitter" in out and "frames/s" not in out


@pytest.mark.parametrize("mode", ["per_file", "batch"])
def test_main_splits_per_file_and_batch(tmp_path, capsys, mode):
    """Two files: each through ``evaluate_file`` (it prints ``Time:``), or
    with ``--batch`` one pipelined batch (it prints ``frames/s``)."""
    from dragposer_tpu_torch.cli import eval_drag as tev

    files = chip_smoke.write_synthetic_clips(str(tmp_path), (8, 6), seed=4)
    extra = ["--batch"] if mode == "batch" else ["--verbose"]
    res = tev.main([MODEL_DIR, str(tmp_path), "--device", "cpu",
                    "--save-dir", str(tmp_path / "out"), *extra])
    out = capsys.readouterr().out
    assert len(res) == len(files) and np.isfinite(res).all()
    if mode == "batch":
        assert "frames/s" in out and "Time:" not in out
    else:
        assert out.count("Time:") == 2 and "frames/s" not in out
        assert out.count("Loss sqrt(Pos)") == 14   # --verbose: every frame


def test_evaluate_file_matches_jax(tmp_path, capsys):
    """``evaluate_file`` (one start, ``engine.run``) against JAX's on one
    12-frame file, statistically (see the module docstring)."""
    from dragposer_tpu.cli import eval_drag as jev
    from dragposer_tpu.data import encoding as jenc
    from dragposer_tpu.io.bvh import BVH
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    (path,) = chip_smoke.write_synthetic_clips(str(tmp_path), (12,), seed=6)
    first = BVH().load(path)
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
    mj, ej, _, nj = jev.evaluate_file(je, jm, js, je.skeleton, path,
                                      save_dir=str(tmp_path / "jax"))
    mt, et, secs, nt = tev.evaluate_file(te, tm, ts, te.skeleton, path,
                                         save_dir=str(tmp_path / "torch"))
    assert nt == nj == 12 and secs > 0
    assert np.isfinite([mt, et]).all()
    assert abs(mt - mj) <= max(0.2 * mj, 0.01), (mt, mj)
    assert abs(et - ej) <= max(0.2 * ej, 0.01), (et, ej)


def test_jitter_matches_jax(tmp_path):
    """Relative 1e-5: the third difference multiplies float32 FK rounding
    (~6e-8 m, which the two packages' FK orders differently) by fps³ =
    2.16e5, so the mean moves ~3e-6 relative between two correct float32
    evaluations (1.7e-6 measured)."""
    from dragposer_tpu import metrics as jmetrics
    from dragposer_tpu.io.bvh import BVH as JBVH
    from dragposer_tpu_torch import metrics as tmetrics
    from dragposer_tpu_torch.io.bvh import BVH as TBVH

    path = str(tmp_path / "clip.bvh")
    chip_smoke.synthetic_bvh(40, 8).save(path)
    for ds in (1, 2):
        ref = jmetrics.jitter(JBVH().load(path), downsample=ds)
        got = tmetrics.jitter(TBVH().load(path), downsample=ds)
        assert ref > 0
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_export_incremental_root_and_global_pos_matches_jax(tmp_path):
    """``result_to_bvh``'s default, root increments integrated from
    ``gt_rotations`` per ``correct_drift_frames`` block, with world root
    positions, against JAX's; and the drift reset's assert."""
    from dragposer_tpu import export as jexport
    from dragposer_tpu.io.bvh import BVH as JBVH
    from dragposer_tpu.ops.topology import Skeleton as JSkeleton
    from dragposer_tpu_torch import export as texport
    from dragposer_tpu_torch.io.bvh import BVH as TBVH
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.ops.topology import Skeleton as TSkeleton

    frames = 70
    path = str(tmp_path / "clip.bvh")
    chip_smoke.synthetic_bvh(frames, 5).save(path)
    jb, tb = JBVH().load(path), TBVH().load(path)
    _, means, stds = loading.load_generator(MODEL_DIR)
    rng = np.random.default_rng(5)

    def unit(q):
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    q = unit(rng.normal(size=(frames, 22, 4)))
    q[:, 0] = unit(np.array([1.0, 0, 0, 0]) + rng.normal(scale=0.02,
                                                           size=(frames, 4)))
    mean_q = means["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    std_q = stds["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    poses = ((q.reshape(frames, -1) - mean_q) / std_q).astype(np.float32)
    gt = unit(rng.normal(size=(frames, 4))).astype(np.float32)
    gpos = rng.normal(size=(frames, 3)).astype(np.float32)
    kw = dict(global_pos=gpos, correct_drift_frames=16, gt_rotations=gt)
    ref = jexport.result_to_bvh(poses, means, stds, jb,
                                JSkeleton.build(jb.parents, jb.offsets), **kw)
    tsk = TSkeleton.build(tb.parents, tb.offsets)
    got = texport.result_to_bvh(poses, means, stds, tb, tsk, **kw)
    np.testing.assert_allclose(got.rotations, ref.rotations, rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=1e-5)
    with pytest.raises(AssertionError, match="GT root rotations"):
        texport.result_to_bvh(poses, means, stds, tb, tsk, global_pos=gpos)
