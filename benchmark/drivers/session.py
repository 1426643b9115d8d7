"""One VR client's session through the program's flat C-ABI bridge
(``runtime/capi``), in a closed loop paced at the client's frame rate.

Set-up follows the reference DLL's order: ``init``, the rig from a BVH file
(written under ``TMPDIR``), ``load_models``, the configuration's mask and
weights, ``set_lambdas``, ``set_optim_params``, then ``init_drag_model`` at
the clip's first root pose.  Frame i is due at ``i / fps`` after the window
opens and is sent when it is due or when the previous reply arrives,
whichever is later; its latency runs from send to reply.  A frame's targets
are the tracked joints' world positions less the root position of the last
reply, and their world rotations.

Traffic parameters: ``fps``, ``warmup_frames``, ``optimizer`` (the realtime
budget), ``motion_seed`` (the clip's motion and the rig's bone lengths: the
same for every seed, so every seed's window does the same work; a seed's run
differs by the frames the judge reads), ``check_frames``, ``trace_frames``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
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

STATE = ("latent", "global_pos", "global_rot", "latent_buffer",
         "displacement_buffer", "heights_buffer", "target_buffer",
         "current_index")


class Session:
    def __init__(self, config: dict, traffic: dict, seconds: float, device):
        from dragposer_tpu_torch.runtime import capi

        self.capi, self.traffic, self.device = capi, traffic, device
        # the rig sets how long Adam runs a frame: the mix's, not the seed's
        self.offsets = synth.skeleton_offsets(
            np.random.default_rng([traffic["motion_seed"], 1]))
        opt = traffic["optimizer"]
        self.hyper = common.hyper(config, opt, adjustment=False)
        t = config["tracker"]
        self.mask = np.asarray(t["mask"], np.float32)
        self.ee = np.nonzero(self.mask)[0]
        frames = (traffic["warmup_frames"] + int(np.ceil(traffic["fps"]
                                                         * seconds)) + 60)
        skeleton = Skeleton(synth.PARENTS, torch.as_tensor(self.offsets,
                                                           device=device))
        # the motion comes from the mix, as the rig does
        clip = synth.clips(common.reference_vae(config, device),
                           np.random.default_rng(traffic["motion_seed"]), 1,
                           frames, device)[0]
        pos, rot = synth.trackers(clip, skeleton)
        self.pos = pos.cpu().numpy().astype(np.float32)
        self.rot = rot.cpu().numpy().astype(np.float32)

        fd, bvh = tempfile.mkstemp(suffix=".bvh")
        os.close(fd)
        try:
            synth.write_bvh(bvh, self.offsets)
            self.h = capi.init(device)
            capi.set_reference_skeleton(self.h, bvh)
        finally:
            os.remove(bvh)
        capi.load_models(self.h, os.path.join(ROOT, config["model_dir"]))
        capi.set_mask_and_weights(
            self.h, self.mask.astype("<f4").tobytes(),
            np.asarray(t["weights"], "<f4").tobytes())
        capi.set_lambdas(self.h, config["lambda_rot"], t["lambda_temporal"],
                         t["temporal_future_window"])
        capi.set_optim_params(self.h, opt["stop_eps_pos"],
                              opt["stop_eps_rot"], opt["max_iter"],
                              opt["learning_rate"])
        gp, gr = self.pos[0, 0], self.rot[0, 0]
        capi.init_drag_model(self.h, *map(float, gp), *map(float, gr))
        self.session = capi.get_session(self.h)
        self.departures = common.departures(self.session._engine.hyper,
                                            self.hyper)
        self.root = gp.copy()
        self.frame = 0

    def targets(self, i: int):
        return (self.pos[i, self.ee] - self.root[None]), self.rot[i, self.ee]

    def state(self) -> dict:
        """The program's session state (its tensors, not copies)."""
        st = self.session._state
        return {k: getattr(st, k) for k in STATE}

    def send(self, i: int):
        """Frame ``i``: (the state before it, targets, local quaternions
        (J, 4), root position (3,), the state after it)."""
        before = self.state()
        p, r = self.targets(i)
        reply = np.frombuffer(self.capi.drag_pose(
            self.h, p.astype("<f4").tobytes(), r.astype("<f4").tobytes(),
            len(self.ee)), dtype="<f4")
        J = len(self.mask)
        local, root = reply[:4 * J].reshape(J, 4), reply[4 * J:]
        self.root = root.copy()
        return before, (p, r), local, root, self.state()

    def close(self):
        self.capi.destroy(self.h)


def play(s: Session, seconds: float, trace_frames: int = 0) -> dict:
    """The window: frames in a closed loop paced at the mix's rate, from
    the frame after the warm-up, for ``seconds``; the first
    ``trace_frames`` of them under the profiler."""
    tr = s.traffic
    records, latency, k2_moved = [], [], []
    traces = []
    period = 1.0 / tr["fps"]
    i = tr["warmup_frames"]
    profiler = contextlib.ExitStack()
    if trace_frames:
        # the profiler starts before the window opens: its start-up is slow
        traces.append(profiler.enter_context(traced()))
    t0 = time.perf_counter()
    last_reply = t0
    while True:
        n = len(latency)
        due = t0 + n * period
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        sent = max(due, last_reply)
        k2_before = k2_launches() if trace_frames else 0
        with span("frame"):
            records.append(s.send(i))
        last_reply = time.perf_counter()
        latency.append(last_reply - sent)
        if trace_frames:
            k2_moved.append(k2_launches() > k2_before)
        if n + 1 == trace_frames:
            # reading the trace takes seconds: the window waits for it
            paused = time.perf_counter()
            profiler.close()
            paused = time.perf_counter() - paused
            t0, last_reply = t0 + paused, last_reply + paused
        i += 1
        if last_reply - t0 >= seconds:
            break
    profiler.close()
    return dict(records=records, latency_ms=np.asarray(latency) * 1e3,
                k2_moved=np.asarray(k2_moved, bool), traces=traces,
                traced_frames=min(trace_frames, len(latency)))


def start(cell, seconds: float, device) -> Session:
    """The cell's session, warmed up."""
    s = Session(cell.config, cell.traffic, seconds, device)
    for i in range(cell.traffic["warmup_frames"]):
        s.send(i)
    common.sync(device)
    return s


def judged(cell, s: Session, records, seed: int, device) -> dict:
    """The judge's numbers for the frames the seed draws from ``records``,
    once the session is closed and freed."""
    rows = pick_frames(records, cell.traffic["check_frames"], seed)
    h, offsets, ee = s.hyper, s.offsets, torch.as_tensor(s.ee)
    s.close()
    if device != "cpu":
        torch.cuda.empty_cache()
    frame = common.reference_frame(cell.config, h, offsets, device)
    return judge.follow_session(frame, *stack(records, rows, ee, device))


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    tr = cell.traffic
    s = start(cell, seconds, device)
    setup_s = time.time() - t_start
    print(f"set-up (s): interpreter {harness.IMPORTED - t_start:.3f}, "
          f"torch, session and warm-up {time.time() - harness.IMPORTED:.3f}",
          file=sys.stderr)
    rec = play(s, seconds, tr["trace_frames"] if trace else 0)
    lat_ms = rec["latency_ms"]
    quarters = [float(np.median(q)) for q in np.array_split(lat_ms, 4)]
    print("frame latency p50 by quarter of the window (ms): "
          + ", ".join(f"{q:.2f}" for q in quarters)
          + f"; p95 {np.percentile(lat_ms, 95):.2f}", file=sys.stderr)
    metrics = {"frame_latency_p50_ms": float(np.percentile(lat_ms, 50)),
               "frame_latency_p95_ms": float(np.percentile(lat_ms, 95)),
               "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    rec["cell"] = cell
    departures = s.departures
    gaps = judged(cell, s, rec.pop("records"), seed, device)
    del s
    print("judge: " + ", ".join(f"{k} {v}" for k, v in gaps.items()),
          flush=True)
    out = Outcome(attempted=len(lat_ms), failed=0, metrics=metrics,
                  recording=rec,
                  checks=harness.checks(cell.name, gaps, departures))
    out.device = {"memory_peak_bytes": int(peak)}
    if trace:
        t_ = rec["traces"][0]
        out.device.update(busy_s=t_.busy_s(), window_s=t_.wall_s)
        out.breakdown = {"device_ops": t_.top_ops(), "idle_gaps": t_.idle_gaps()}
    return out


def calibrate(cell, seed: int, seconds: float, control: bool,
              device="cuda") -> dict:
    """The judge's numbers for ``seed`` on the card: the program's over a
    window of ``seconds``; with ``control``, those of a fault confined to
    one slot of the window (the program's latent left where the frame found
    it in every frame of slot 5), and the reference's with TF32 products,
    playing the same frames from the program's state after the warm-up."""
    from benchmark.reference import control as ctl

    s = start(cell, seconds, device)
    first_state = {k: v.clone() for k, v in s.state().items()}
    records = play(s, seconds)["records"]
    pos, rot, ee, first = s.pos, s.rot, s.ee, cell.traffic["warmup_frames"]
    rows = pick_frames(records, cell.traffic["check_frames"], seed)
    eet = torch.as_tensor(ee)
    frame = common.reference_frame(cell.config, s.hyper, s.offsets, device)
    res = {"program": judged(cell, s, records, seed, device),
           "frames": len(records)}
    del s
    if control:
        slot = [int(r[0]["current_index"]) == 5 for r in records]
        broken = [r[:4] + ({**r[4], "latent": r[0]["latent"]},) if b else r
                  for r, b in zip(records, slot)]
        res["fault_one_slot"] = judge.follow_session(
            frame, *stack(broken, rows, eet, device))
    if control:
        def targets(k, root):
            if k >= len(records):
                return None
            return (pos[first + k, ee] - root.cpu().numpy()[None],
                    rot[first + k, ee])

        with ctl.tf32():
            played = ctl.session(frame, first_state, targets)
        res["control"] = judge.follow_session(
            frame, *stack(played, rows, eet, device))
    return res


def k2_launches() -> int:
    """K2's launches and its plain twin's calls in this process (the
    program's counters)."""
    from dragposer_tpu_torch import _build

    n = _build.kernel_launches()
    return n.get("K2", 0) + n.get("K2_plain", 0)


def pick_frames(records, n: int, seed: int) -> np.ndarray:
    """``n`` frames of the window drawn from the seed, as many from each
    slot of the window (``current_index``; the rollout runs at slot 0) as
    there are frames enough."""
    rng = np.random.default_rng([seed, 2])
    slot = np.array([int(r[0]["current_index"]) for r in records])
    slots = np.unique(slot)
    each = max(1, n // len(slots))
    pick = [rng.choice(np.nonzero(slot == x)[0],
                       min(each, int((slot == x).sum())), replace=False)
            for x in slots]
    return np.sort(np.concatenate(pick))


def stack(records, rows, ee, device):
    """The judge's batch: state before, dense targets (the tracked joints'
    rows; identity elsewhere, as the session fills them), and what came
    back, one row per checked frame."""
    J = len(synth.PARENTS)
    before = {k: torch.stack([records[i][0][k] for i in rows])
              for k in STATE}
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    pos = torch.zeros((len(rows), J, 3), device=device)
    rot = torch.zeros((len(rows), J, 4), device=device)
    rot[..., 0] = 1.0
    for n_, i in enumerate(rows):
        p, r = records[i][1]
        pos[n_, ee], rot[n_, ee] = t(p), t(r)
    after = {"local": torch.stack([t(records[i][2]) for i in rows]),
             "root": torch.stack([t(records[i][3]) for i in rows]),
             "latent": torch.stack([records[i][4]["latent"] for i in rows]),
             "target_buffer": torch.stack([records[i][4]["target_buffer"]
                                           for i in rows])}
    return before, {"pos": pos, "rot": rot}, after
