"""The port on SMPL-H's 52-joint skeleton (the benchmark's ``smplh52_6trk``
configuration) against the benchmark's plain reference, on seeded weights
from the benchmark's writer (``benchmark/drivers/offline_rig.py``): the
pooled widths, the decoder and FK, the pipelined batch frame by frame
under the judge, the tracker mapped by joint name, and the engine taking
the rig's height joints.  One case, marked ``cuda``, holds K1's general
build on the tree against its plain twin; on the GPU machine::

    python -m pytest tests/test_torch_smplh52.py -q --noconftest -m cuda
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import offline_rig
from benchmark.reference import model as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "offline_smplh52_equal"


@pytest.fixture(scope="module")
def cell():
    return harness.cell(CELL)


@pytest.fixture(scope="module")
def config(cell):
    """The configuration with its seeded model written (once a process)."""
    return offline_rig.with_model(cell.config)


def _statics(config):
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import vae

    return vae.build_statics(offline_rig.parents(config), cfg.VAE_PARAM)


def _port_model(config):
    from dragposer_tpu_torch.models import loading, vae

    params, means, stds = loading.load_generator(config["model_dir"])
    folded = vae.fold_decoder(params["decoder"], _statics(config), "cpu")
    return folded, means, stds


def test_pooled_widths_of_the_port_and_the_reference(config):
    parents = offline_rig.parents(config)
    statics = _statics(config)
    enc = [m.shape[0] for m in statics.enc_masks] + [
        statics.enc_pools[-1].shape[0]]
    levels, _ = ref.pool_levels(parents, decoder=False)
    assert enc == [ref.ENC_CHANNELS * len(p) for p in levels] \
        == config["vae"]["encoder_widths"] == [416, 256, 216, 192]
    folded, _, _ = _port_model(config)
    vae = offline_rig.reference_vae(config, "cpu")
    port = [folded["ws"][0].shape[1]] + [w.shape[0] for w in folded["ws"]]
    mine = [vae.dec[0][0].shape[1]] + [w.shape[0] for w, _ in vae.dec]
    assert port == mine == config["vae"]["decoder_widths"] \
        == [24, 112, 132, 212]


def test_decode_and_fk_equal_the_reference(config):
    from dragposer_tpu_torch.models import vae as port_vae
    from dragposer_tpu_torch.ops import fk, topology

    folded, means, stds = _port_model(config)
    vae = offline_rig.reference_vae(config, "cpu")
    z = torch.as_tensor(np.random.default_rng(5).normal(size=(64, 24)),
                        dtype=torch.float32)
    pose_n, disp = port_vae.decode_folded_flat(
        folded, z, torch.as_tensor(means["dqs"]), torch.as_tensor(
            stds["dqs"]))
    ref_pose, ref_disp = vae.decode(z)
    assert torch.allclose(pose_n, ref_pose, rtol=0, atol=1e-5)
    assert torch.allclose(disp, ref_disp, rtol=0, atol=1e-5)

    offsets = offline_rig.bone_offsets(config, np.random.default_rng(6))
    parents = offline_rig.parents(config)
    q = vae.quats(ref_pose)
    root = torch.as_tensor(np.random.default_rng(7).normal(size=(64, 3)),
                           dtype=torch.float32)
    pos, world = fk.fk_root_space(q, root, topology.Skeleton.build(
        parents, offsets))
    ref_pos, ref_world = ref.fk(ref.Skeleton(parents, torch.as_tensor(
        offsets)), q, root)
    assert torch.allclose(pos, ref_pos, rtol=0, atol=1e-5)
    assert torch.allclose(world, ref_world, rtol=0, atol=1e-5)


def test_pipelined_batch_follows_the_reference(cell):
    """``run_batch_pipelined`` on the CPU (K1's plain twin, K2's), 4 lanes
    × 12 frames at sync_k 4, judged frame by frame as the cell judges
    the card (knife-edge frames left out of what follows Adam)."""
    torch.set_num_threads(2)
    small = dataclasses.replace(cell, traffic=dict(
        cell.traffic, lanes=4, min_frames=12, max_frames=12, pool_clips=2,
        pool_frames=48, check_lanes=4, sync_k=4))
    s = offline_rig.Setup(small.config, small.traffic, 2147483659, "cpu")
    assert s.departures == []
    states, out = s.one_pass()
    inp, got = offline_rig.offline_batch.sample(s, states, out, 2147483659)
    _, gaps = offline_rig.judged(small, inp, got, s.hyper, s.offsets, "cpu")
    limits = harness.load_json(ROOT, "benchmark", "limits", CELL + ".json")
    assert all(gaps[k] <= v for k, v in limits.items()), gaps
    assert gaps["stop_rule_break_share_all"] == 0, gaps
    assert gaps["frames_checked"] == 48


def test_tracker_mapped_by_joint_name(cell):
    """The published 6_trackers (the dancedb configuration's, on the
    example rig) carried to SMPL-H by joint name; finger joints untracked
    at the published untracked weight."""
    from benchmark import synth

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "dancedb_6trk.json")) as f:
        published = json.load(f)
    body = list(synth.JOINT_NAMES)
    names = cell.config["skeleton"]["names"]
    t = cell.config["tracker"]
    tracked = {body[j] for j, m in enumerate(published["tracker"]["mask"])
               if m}
    assert t["mask"] == [int(n in tracked) for n in names]
    assert t["weights"] == [published["tracker"]["weights"][body.index(n)]
                            if n in body else [1.0, 0.01] for n in names]
    assert set(np.nonzero(t["mask"])[0]) == {0, 3, 7, 13, 17, 36}
    assert cell.config["height_indices"] == [
        names.index(body[j]) for j in published["height_indices"]] \
        == [0, 4, 8, 13, 17, 36]
    assert {k: v for k, v in t.items() if k not in ("mask", "weights")} \
        == {k: v for k, v in published["tracker"].items()
            if k not in ("mask", "weights")}


def test_engine_takes_the_rig_tracker_and_height_joints(config):
    """``build_engine`` on a model directory of another rig: a 52-entry
    tracker from a configuration's dict and the rig's height joints."""
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.cli import eval_drag
    from dragposer_tpu_torch.ops import topology

    parents = offline_rig.parents(config)
    offsets = offline_rig.bone_offsets(config, np.random.default_rng(1))
    tracker = cfg.TrackerConfig.from_dict(config["tracker"])
    assert tracker.name == "6_trackers" and len(tracker.mask) == 52
    engine, _, _ = eval_drag.build_engine(
        config["model_dir"], parents, tracker,
        skeleton=topology.Skeleton.build(parents, offsets),
        height_indices=config["height_indices"], device="cpu")
    assert engine.hyper.height_indices == (0, 4, 8, 13, 17, 36)
    assert engine.hyper.joint_adjustment == (0, 0)
    with pytest.raises(ValueError, match="52 mask entries"):
        cfg.TrackerConfig.from_dict(dict(config["tracker"],
                                         weights=config["tracker"][
                                             "weights"][:22]))


@pytest.mark.cuda
@pytest.mark.parametrize("sync_k", [1, 24])
def test_k1_general_build_on_the_tree_matches_plain(config, sync_k):
    """One block of K1's general build on the 52-joint tree (two words a
    topology mask) against its plain twin on the card, the general
    build's first-step knife lanes exempt (``chip_smoke.k1_agreement``);
    at sync_k = 1 its TF32 control must fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels have no CPU mode)")
    import chip_smoke
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.cli import eval_drag
    from dragposer_tpu_torch.ops import topology

    parents = offline_rig.parents(config)
    engine, _, _ = eval_drag.build_engine(
        config["model_dir"], parents,
        cfg.TrackerConfig.from_dict(config["tracker"]),
        skeleton=topology.Skeleton.build(parents, offline_rig.bone_offsets(
            config, np.random.default_rng(1))),
        height_indices=config["height_indices"])
    B = 1000
    r = chip_smoke.check_k1(engine, B, sync_k, timed=False,
                            control=sync_k == 1,
                            knife=chip_smoke.k1_knife_lanes(engine, B))
    assert r["build"] == "general" and r["ok"], r
    assert r.get("tf32_control_refused", True), r
