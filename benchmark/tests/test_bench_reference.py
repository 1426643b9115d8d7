"""The plain reference held against itself: run in the program's place at
the configuration's precision, the judge reads it as correct, to rounding."""

import numpy as np
import torch

from benchmark.drivers import common, offline_batch, session
from benchmark.harness import load_json, ROOT
from benchmark.reference import control, judge


def _offline_inputs(c):
    s = offline_batch.Setup(c.config, c.traffic, 424242, "cpu")
    states, out = s.one_pass()
    inp, _ = offline_batch.sample(s, states, out, 424242)
    return s, inp


def test_decoder_folds_to_the_published_widths(small):
    c = small("offline_6trk_mixed")
    vae = common.reference_vae(c.config, "cpu")
    widths = [vae.dec[0][0].shape[1]] + [w.shape[0] for w, _ in vae.dec]
    assert widths == c.config["vae"]["decoder_widths"]


def test_offline_reference_against_itself(small):
    c = small("offline_4trk_equal")
    s, inp = _offline_inputs(c)
    frame = common.reference_frame(c.config, s.hyper, s.offsets, "cpu")
    got = control.offline(frame, inp)
    gaps = judge.follow_offline(frame, inp, got)
    # rounding only: the judge batches its rollouts and steps otherwise
    lim = load_json(ROOT, "benchmark", "limits", c.name + ".json")
    assert all(gaps[k] < v / 10 for k, v in lim.items()), gaps
    assert gaps["stop_rule_break_share_all"] == 0


def test_session_reference_against_itself(small):
    c = small("session_4trk")
    s = session.Session(c.config, c.traffic, 0.2, "cpu")
    for i in range(c.traffic["warmup_frames"]):
        s.send(i)
    start, first = s.state(), c.traffic["warmup_frames"]
    frame = common.reference_frame(c.config, s.hyper, s.offsets, "cpu")

    def targets(k, root):
        if k >= 40:
            return None
        return (s.pos[first + k, s.ee] - root.numpy()[None],
                s.rot[first + k, s.ee])

    played = control.session(frame, start, targets)
    rows = np.arange(40)
    gaps = judge.follow_session(frame, *session.stack(
        played, rows, torch.as_tensor(s.ee), "cpu"))
    s.close()
    lim = load_json(ROOT, "benchmark", "limits", "session_4trk.json")
    # rounding only: the judge batches the frames, the session runs one
    assert all(gaps[k] < v / 10 for k, v in lim.items()), gaps
