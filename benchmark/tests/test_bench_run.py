"""A run end to end on the CPU at a tiny size, the look for a chip
skipped: its result line, its refusal without a GPU, and the faults that
the judge has to refuse."""

import contextlib
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from conftest import ROOT

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def run_cell(c, seconds=0.2):
    driver = harness.driver(c.traffic["kind"])
    out = driver.run(c, 20260417, seconds, False, "cpu", time.time())
    return harness.result_line(c, out, False)


def test_without_a_gpu_no_result_and_a_failing_exit():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "session_4trk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_result_line(small):
    line = run_cell(small("offline_6trk_mixed"))
    assert set(line) == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    json.dumps(line)


@contextlib.contextmanager
def patched(module, name, wrap):
    old = getattr(module, name)
    setattr(module, name, wrap(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def step_unchanged(run):
    """K1 counts its steps but leaves the latent where it was."""
    def k1(ctx, kctx, hyper, sync_k, opt, *rest):
        out = run(ctx, kctx, hyper, sync_k, opt, *rest)
        return out._replace(latent=opt.latent)
    return k1


def quarter_of_lanes(run):
    """K1 leaves the latent of one lane in four of each launch where it
    was (one warp's lanes of a tile, say)."""
    def k1(ctx, kctx, hyper, sync_k, opt, *rest):
        out = run(ctx, kctx, hyper, sync_k, opt, *rest)
        hit = torch.arange(out.latent.shape[0]) % 4 == 0
        return out._replace(latent=torch.where(
            hit.to(out.latent.device)[:, None], opt.latent, out.latent))
    return k1


def half_left_out(run):
    """The second half of the lanes never runs."""
    def pipelined(self, states, dqs, gp, gr, sync_k=24, lengths=None,
                  fast=None):
        lengths = self.tensor(lengths, torch.int32).clone()
        lengths[lengths.shape[0] // 2:] = 0
        return run(self, states, dqs, gp, gr, sync_k, lengths, fast)
    return pipelined


def answer_altered(run):
    """K2's prediction altered where it is produced."""
    def k2(packed, tparam, enc, dec, mask):
        return run(packed, tparam, enc, dec, mask) + 0.05
    return k2


def offline_faults():
    from dragposer_tpu_torch.drag import engine, iter_kernel
    from dragposer_tpu_torch.ops import temporal_fused

    return {"step_unchanged": (iter_kernel, "run_block_fused",
                               step_unchanged),
            "quarter_of_lanes": (iter_kernel, "run_block_fused",
                                 quarter_of_lanes),
            "half_left_out": (engine.DragEngine, "run_batch_pipelined",
                              half_left_out),
            "answer_altered": (temporal_fused, "forward", answer_altered)}


@pytest.mark.parametrize("fault", ["step_unchanged", "quarter_of_lanes",
                                   "half_left_out", "answer_altered"])
def test_offline_faults_are_refused(small, fault):
    module, name, wrap = offline_faults()[fault]
    with patched(module, name, wrap):
        line = run_cell(small("offline_6trk_mixed"))
    assert line["correct"] is False, line["compared"]


def session_state_unchanged(run):
    def step(self, state, tpos, trot):
        _, local, gp = run(self, state, tpos, trot)
        return state, local, gp
    return step


def session_reply_altered(run):
    def drag_pose(handle, ee_pos, ee_rot, n_ee):
        import numpy as np
        out = np.frombuffer(run(handle, ee_pos, ee_rot, n_ee), "<f4").copy()
        out[:4] = out[:4] * 0.99 + 0.01
        return out.tobytes()
    return drag_pose


@pytest.mark.parametrize("fault", [None, "state_unchanged", "reply_altered"])
def test_session_faults_are_refused(small, fault):
    from dragposer_tpu_torch.drag import engine
    from dragposer_tpu_torch.runtime import capi

    faults = {"state_unchanged": (engine.DragEngine, "step_realtime",
                                  session_state_unchanged),
              "reply_altered": (capi, "drag_pose", session_reply_altered)}
    c = small("session_4trk")
    ctx = patched(*faults[fault]) if fault else contextlib.nullcontext()
    with ctx:
        line = run_cell(c, seconds=1.0)
    assert line["correct"] is (fault is None), line["compared"]


@pytest.mark.cuda
def test_control_is_refused_on_the_card(small):
    """The control (the reference in the program's place, TF32 products)
    at a size a test can hold; the cell-size readings come from
    ``benchmark/calibrate.py --control`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from benchmark.drivers import common, offline_batch
    from benchmark.reference import control, judge

    c = small("offline_4trk_equal")
    c.traffic.update(lanes=256, min_frames=48, max_frames=48, check_lanes=8)
    s = offline_batch.Setup(c.config, c.traffic, 7, "cuda")
    states, out = s.one_pass()
    inp, _ = offline_batch.sample(s, states, out, 7)
    frame = common.reference_frame(c.config, s.hyper, s.offsets, "cuda")
    with control.tf32():
        got = control.offline(frame, inp)
    gaps = judge.follow_offline(frame, inp, got)
    lim = harness.load_json(ROOT, "benchmark", "limits", c.name + ".json")
    assert any(gaps[k] > v for k, v in lim.items()), gaps
