"""The traffic generators at a tiny size: seeded, the same work on every
seed, inputs as the program's own encoder makes them."""

import numpy as np
import torch

from benchmark import synth
from benchmark.drivers import common, offline_batch, session
from benchmark.harness import cell
from benchmark.reference.model import Skeleton, qmul


def test_every_seed_gets_the_same_lengths_in_its_own_order():
    t = cell("offline_6trk_mixed").traffic
    a = offline_batch.lane_lengths(t, np.random.default_rng(1), 960)
    b = offline_batch.lane_lengths(t, np.random.default_rng(2), 960)
    assert (np.sort(a) == np.sort(b)).all() and (a != b).any()
    assert len(a) == t["lanes"] and a.max() == 960
    # AMASS: 11,265 motions over 2,420.86 minutes, the longest subset's
    # mean 66.65 s; the lanes keep the mean's share of the longest
    motions = sum(x[1] for x in t["subsets"])
    minutes = sum(x[2] for x in t["subsets"])
    assert motions == 11265 and abs(minutes - 2420.86) < 1e-6
    assert abs(a.mean() / a.max() - (minutes / motions) / (41.1 / 37)) < 0.01
    # each subset's share of the lanes is its share of the motions
    tc = (a == 960).sum()
    assert abs(tc - 37 / 11265 * t["lanes"]) < 1
    e = offline_batch.lane_lengths(dict(t, lengths="equal", min_frames=240),
                                   np.random.default_rng(1))
    assert (e == 240).all()


def test_clips_are_seeded_smooth_and_unit():
    c = cell("offline_6trk_mixed")
    vae = common.reference_vae(c.config, "cpu")
    one = synth.clips(vae, np.random.default_rng(7), 2, 40, "cpu")
    two = synth.clips(vae, np.random.default_rng(7), 2, 40, "cpu")
    for a, b in zip(one, two):
        assert torch.equal(a.rootspace, b.rootspace)
        norms = torch.linalg.norm(a.rootspace, dim=-1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
        step = (a.root_pos[1:] - a.root_pos[:-1]).norm(dim=-1)
        assert step.max() < 0.03    # under 1.8 m/s at 60 fps


def test_features_encode_root_turn_and_step():
    c = cell("offline_6trk_mixed")
    vae = common.reference_vae(c.config, "cpu")
    rng = np.random.default_rng(3)
    off = synth.skeleton_offsets(rng)
    sk = Skeleton(synth.PARENTS, torch.as_tensor(off))
    clip = synth.clips(vae, rng, 1, 30, "cpu")[0]
    f = synth.features(clip, sk, c.config["height_indices"])
    dq = f.dqs.unflatten(-1, (-1, 8))
    turn = dq[1:, 0, :4]
    again = qmul(f.global_rot[:-1], turn)
    assert torch.allclose(again.abs(), f.global_rot[1:].abs(), atol=1e-5)
    assert torch.equal(dq[:, 0, 7], torch.zeros(30))
    assert f.heights.shape == (30, len(c.config["height_indices"]))


def test_session_checks_every_slot_alike():
    records = [({"current_index": torch.tensor(i % 16)},) for i in range(160)]
    rows = session.pick_frames(records, 96, seed=5)
    assert len(rows) == 96 and len(set(rows.tolist())) == 96
    assert np.bincount(rows % 16).tolist() == [6] * 16
