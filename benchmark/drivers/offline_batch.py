"""Offline evaluation of a corpus in one padded batch, pass after pass.

The program's batch path, as ``cli/eval_drag.evaluate_batched`` runs it: an
engine from ``build_engine``; each pass encodes every lane's first frame
(``init_state``), runs ``DragEngine.run_batch_pipelined`` with the lanes'
lengths and copies the outputs to the host.  Lanes are padded to the longest
by repeating their last frame.

Traffic parameters: ``lanes``; ``lengths`` ("subsets", a published
corpus's ``subsets`` scaled to the configuration's
``corpus_longest_frames``, or "equal", ``min_frames``); ``pool_clips`` synthetic
clips of ``pool_frames`` frames, each lane a clip at an offset, all drawn
from ``motion_seed``; ``sync_k``; ``optimizer``; ``check_lanes``;
``trace_passes``.  The run's seed sets the rig's bone lengths, the order of
the lanes, the first latents' draw and the lanes the judge reads: every
seed gets the same set of lanes, so the work is the same from seed to
seed.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import synth
from benchmark.drivers import common
from benchmark import harness
from benchmark.harness import ROOT, Outcome
from benchmark.profiling import span, traced
from benchmark.reference import judge
from benchmark.reference.model import Skeleton


def lane_lengths(traffic: dict, rng: np.random.Generator,
                 longest: int = 0) -> np.ndarray:
    """The lanes' lengths in frames, in an order drawn from ``rng``.

    "equal": every lane ``min_frames``.  "subsets": a published corpus's
    subsets, each ``[name, motions, minutes]``: the lanes are shared out
    among them by their counts of motions, each lane at its subset's mean
    duration, and the durations are scaled so that the longest subset's is
    ``longest`` frames (the law's shape, and so the padding's share, kept)."""
    B = traffic["lanes"]
    if traffic["lengths"] == "equal":
        return np.full(B, traffic["min_frames"], dtype=np.int64)
    motions = np.array([x[1] for x in traffic["subsets"]], dtype=float)
    seconds = np.array([60.0 * x[2] / x[1] for x in traffic["subsets"]])
    frames = np.maximum(1, np.round(seconds * longest / seconds.max()))
    share = motions / motions.sum() * B
    n = np.floor(share).astype(np.int64)
    n[np.argsort(n - share)[:B - int(n.sum())]] += 1   # largest remainders
    return rng.permutation(np.repeat(frames, n).astype(np.int64))


class Setup:
    """The engine and the inputs of one seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dragposer_tpu_torch import config as cfg
        from dragposer_tpu_torch.cli import eval_drag
        from dragposer_tpu_torch.ops import topology

        self.config, self.traffic, self.device = config, traffic, device
        rng = np.random.default_rng(seed)
        self.offsets = synth.skeleton_offsets(rng)
        opt = traffic["optimizer"]
        self.hyper = common.hyper(config, opt, adjustment=True)
        t = config["tracker"]
        tracker = cfg.TrackerConfig(
            mask=tuple(t["mask"]), weights=tuple(map(tuple, t["weights"])),
            enable_joint_adjustment=t["enable_joint_adjustment"],
            joint_adjustment_indices=tuple(t["joint_adjustment_indices"]),
            joint_adjustment_weight=t["joint_adjustment_weight"],
            lambda_temporal=t["lambda_temporal"],
            temporal_future_window=t["temporal_future_window"],
            name=t["name"])
        skeleton = topology.Skeleton.build(synth.PARENTS, self.offsets,
                                           synth.JOINT_NAMES)
        self.engine, _, _ = eval_drag.build_engine(
            f"{ROOT}/{config['model_dir']}", synth.PARENTS, tracker,
            skeleton=skeleton, max_iter=opt["max_iter"],
            learning_rate=opt["learning_rate"], device=device)
        self.departures = common.departures(self.engine.hyper, self.hyper)
        self.make_inputs(seed, rng)

    def make_inputs(self, seed: int, rng: np.random.Generator) -> None:
        tr, dev = self.traffic, self.device
        vae = common.reference_vae(self.config, dev)
        skeleton = Skeleton(synth.PARENTS, torch.as_tensor(self.offsets,
                                                           device=dev))
        B = tr["lanes"]
        # the lanes' motion comes from the mix: every seed gets the same
        # clips, lengths and offsets, in its own order of lanes, on its rig
        motion = np.random.default_rng(tr["motion_seed"])
        lengths = lane_lengths(tr, motion,
                               self.config.get("corpus_longest_frames", 0))
        clip = motion.integers(0, tr["pool_clips"], size=B)
        start = motion.integers(0, tr["pool_frames"] - lengths + 1)
        order = rng.permutation(B)
        lengths, clip, start = lengths[order], clip[order], start[order]
        T = int(lengths.max())
        feats = [synth.features(c, skeleton, self.config["height_indices"])
                 for c in synth.clips(vae, motion, tr["pool_clips"],
                                      tr["pool_frames"], dev)]
        dqs = (torch.stack([f.dqs for f in feats]) - vae.mean_dqs) \
            / vae.std_dqs
        # a lane starts as a motion file does: no root turn, no step
        first = torch.zeros_like(dqs[0, 0]).unflatten(-1, (-1, 8))
        first[0, 0] = 1.0
        first = (first.flatten() - vae.mean_dqs) / vae.std_dqs
        frame = torch.as_tensor(
            start[:, None] + np.minimum(np.arange(T)[None], lengths[:, None]
                                        - 1), device=dev)
        c = torch.as_tensor(clip, device=dev)[:, None]
        self.dqs = dqs[c, frame]
        self.dqs[:, 0, :8] = first[:8]
        self.global_pos = torch.stack([f.global_pos for f in feats])[c, frame]
        self.global_rot = torch.stack([f.global_rot for f in feats])[c, frame]
        self.heights0 = torch.stack([f.heights for f in feats])[
            c[:, 0], frame[:, 0]]
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.noise = torch.randn((B, vae.dec[0][0].shape[1]), generator=gen,
                                 device=dev)
        self.lengths = lengths
        self.lengths_t = torch.as_tensor(lengths, device=dev)

    def one_pass(self, frames: int | None = None):
        """One pass over the batch (its first ``frames`` frames only, for a
        warm-up): (the initial states, the outputs on the host)."""
        e = self.engine
        lengths = self.lengths_t if frames is None else \
            torch.clamp(self.lengths_t, max=frames)
        with span("init_state"):
            states = e.init_state(torch.Generator(device=self.device),
                                  self.dqs[:, 0][:, :, None],
                                  self.global_pos[:, 0], self.global_rot[:, 0],
                                  self.heights0, noise=self.noise)
        with span("run_batch_pipelined"):
            _, out = e.run_batch_pipelined(
                states, self.dqs, self.global_pos, self.global_rot,
                sync_k=self.traffic["sync_k"], lengths=lengths)
        with span("to_host"):
            from dragposer_tpu_torch.drag.engine import to_host
            return states, to_host(out)


def sample(setup: Setup, states, out, seed: int) -> tuple:
    """The inputs and the program's outputs of the lanes the judge reads:
    a sample drawn from the seed, the longest lane among them."""
    tr, dev = setup.traffic, setup.device
    rng = np.random.default_rng([seed, 1])
    longest = int(np.argmax(setup.lengths))
    rest = rng.choice(np.delete(np.arange(tr["lanes"]), longest),
                      size=tr["check_lanes"] - 1, replace=False)
    lanes = np.concatenate(([longest], rest))
    T = int(setup.lengths[lanes].max())
    sel = torch.as_tensor(lanes, device=dev)
    inp = dict(dqs=setup.dqs[sel, :T], global_pos=setup.global_pos[sel, :T],
               global_rot=setup.global_rot[sel, :T],
               heights0=setup.heights0[sel], noise=setup.noise[sel],
               lengths=setup.lengths_t[sel])
    t = lambda a: torch.as_tensor(np.asarray(a)[lanes, :T], device=dev)  # noqa: E731
    got = dict(latent=t(out.latent), global_pos=t(out.global_pos),
               pose=t(out.pose), iterations=t(out.iterations),
               initial_latent=states.latent[sel].clone())
    return inp, got


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    marks = [("start", t_start), ("interpreter", harness.IMPORTED)]
    setup = Setup(cell.config, cell.traffic, seed, device)
    marks.append(("torch, engine and inputs", time.time()))
    setup.one_pass(frames=8)          # builds and loads K1 and K2: set-up
    common.sync(device)
    marks.append(("warm-up", time.time()))
    print("set-up (s): " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
        file=sys.stderr)
    launches = common.Launches()
    rec = dict(cell=cell, config=cell.config, traffic=cell.traffic)
    attempted = passes = 0
    ends = []
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    while True:
        if trace:
            # the traced passes are the window: nothing reads the rest
            with launches.recording(spans=True), traced() as tr_:
                with span("pass"):
                    states, out = setup.one_pass()
            rec.setdefault("traces", []).append(tr_)
            rec.setdefault("traced_outputs", []).append(out)
        else:
            states, out = setup.one_pass()
        passes += 1
        attempted += int(setup.lengths.sum())
        ends.append(time.perf_counter())
        if trace and passes == cell.traffic["trace_passes"]:
            break
        if not trace and time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    print("seconds a pass: " + ", ".join(
        f"{b - a:.3f}" for a, b in zip([t0] + ends, ends)), file=sys.stderr)
    metrics = {"frames_per_s": attempted / window, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    rec.update(launches=launches, lengths=setup.lengths, passes=passes,
               window_s=window, outputs=out)
    inp, got = sample(setup, states, out, seed)
    departures, h, offsets = setup.departures, setup.hyper, setup.offsets
    del setup, states
    _, gaps = judged(cell, inp, got, h, offsets, device)
    out_ = Outcome(attempted=attempted, failed=0, metrics=metrics,
                   recording=rec,
                   checks=harness.checks(cell.name, gaps, departures))
    out_.device = {"memory_peak_bytes": int(peak)}
    if trace:
        tr0 = rec["traces"][0]
        out_.device.update(busy_s=tr0.busy_s(), window_s=tr0.wall_s)
        out_.breakdown = {"device_ops": tr0.top_ops(),
                          "idle_gaps": tr0.idle_gaps()}
    print("judge: " + ", ".join(f"{k} {v}" for k, v in gaps.items()),
          flush=True)
    return out_


def judged(cell, inp: dict, got: dict, hyper, offsets, device) -> tuple:
    """(the reference frame, the judge's numbers) for the sampled lanes,
    built once the program's state is freed."""
    if device != "cpu":
        torch.cuda.empty_cache()
    frame = common.reference_frame(cell.config, hyper, offsets, device)
    return frame, judge.follow_offline(frame, inp, got)


def unchanged(got: dict, where) -> dict:
    """The program's outputs with the Adam step of the frames ``where``
    (lanes × frames) returning its state unchanged: their stored latent is
    the frame before's."""
    lat = got["latent"]
    before = torch.cat((got["initial_latent"][:, None], lat[:, :-1]), 1)
    return dict(got, latent=torch.where(where[..., None], before, lat))


FAULTS = {
    # a fault in one lane of four (one warp's lanes of a tile, say)
    "quarter_of_lanes": lambda got, inp: unchanged(
        got, (torch.arange(got["latent"].shape[0], device=got["latent"]
                           .device) % 4 == 0)[:, None]
        .expand(got["latent"].shape[:2])),
    # a fault in the late blocks of a pass, where only the long lanes live
    "ragged_tail": lambda got, inp: unchanged(
        got, torch.arange(got["latent"].shape[1], device=got["latent"]
                          .device)[None].expand(got["latent"].shape[:2])
        >= int(0.75 * int(inp["lengths"].max()))),
}


def calibrate(cell, seed: int, seconds: float, control: bool,
              device="cuda") -> dict:
    """The judge's numbers for ``seed`` on the card: the program's after
    one pass over the cell's batch; with ``control``, the program's outputs
    with the :data:`FAULTS` planted, and the reference's with TF32 products
    on the same lanes at the cell's lengths."""
    from benchmark.reference import control as ctl

    s = Setup(cell.config, cell.traffic, seed, device)
    s.one_pass(frames=8)
    states, out = s.one_pass()
    inp, got = sample(s, states, out, seed)
    h, offsets = s.hyper, s.offsets
    del s, states, out
    t0 = time.perf_counter()
    frame, program = judged(cell, inp, got, h, offsets, device)
    res = {"program": program, "judge_s": time.perf_counter() - t0}
    for name, fault in (FAULTS.items() if control else ()):
        res["fault_" + name] = judge.follow_offline(frame, inp,
                                                    fault(got, inp))
    if control:
        with ctl.tf32():
            played = ctl.offline(frame, inp)
        res["control"] = judge.follow_offline(frame, inp, played)
    return res
