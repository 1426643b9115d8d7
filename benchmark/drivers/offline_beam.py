"""Offline evaluation of many files through the hypothesis beam, pass after
pass.

The program's beam, as ``cli/eval_drag.evaluate_batched`` runs it for a
configuration that asks for one (``restarts`` > 1 and ``branch_every`` >
0): an engine from ``build_engine``; each pass
``hypotheses.run_hypotheses_batched`` over every file's R lanes, chunk by
chunk through the pipelined path, ending with each file's winning lineage
on the host.  The configuration's ``search`` holds the beam's settings:
``restarts``, ``branch_every``, ``survivors``, ``branch_sigma``.

Traffic parameters: ``files`` (each a lane of ``offline_batch``'s inputs:
``lengths``, ``min_frames``, ``pool_clips``, ``pool_frames``,
``motion_seed``); ``sync_k``; ``optimizer``; ``check_files`` (files whose
beam the judge checks, their winners followed) and ``check_lanes``
(lineages drawn across the beam, followed too); ``trace_passes``.  The
run's seed sets the rig's bone lengths, the files' order, the beam's
generator (its first latents' and its re-seeding draws) and the judge's
sample.  ``frames_per_s`` counts each file's frames once, whatever the
beam's width: what the user receives.  The recording keeps the lanes'
lengths (F·R) and ``common.Launches``, as ``offline_batch``'s does, but
its traced outputs are the F winners: ``iterations_per_frame`` cannot read
it (the beam keeps no dropped lane's outputs), so the log gives K1's
lane-steps a real lane-frame instead.
"""

from __future__ import annotations

import contextlib
import inspect
import sys
import time

import numpy as np
import torch

from benchmark import harness, profiling
from benchmark.drivers import common, offline_batch
from benchmark.harness import Outcome
from benchmark.profiling import span
from benchmark.reference import beam


def pipelined_beam():
    """The program's ``run_hypotheses_batched``, refused where it does not
    take ``sync_k`` (its chunks then run on the anchor, for minutes a
    pass)."""
    from dragposer_tpu_torch.drag import hypotheses

    fn = hypotheses.run_hypotheses_batched
    if "sync_k" not in inspect.signature(fn).parameters:
        raise TypeError("run_hypotheses_batched takes no sync_k: this "
                        "program's beam is not the pipelined one")
    return fn


def read_events(prof, trace: profiling.Trace) -> None:
    """``prof``'s events into ``trace`` as ``profiling.traced`` puts them
    (µs from the trace's start; host events, and the device's without its
    annotations), read from the profiler's raw records: its ``events()``
    builds every event's tree in Python, ~110 s for a beam pass (H100
    host), whose blocks outnumber a corpus pass's."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    for e in result.events():
        if _filter_name(e.name()) or getattr(e, "is_hidden_event",
                                             lambda: False)():
            continue
        item = ((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
                _rewrite_name(name=e.name(), with_wildcard=True))
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                trace.device.append(item)
        else:
            trace.host.append(item)


@contextlib.contextmanager
def traced():
    """``profiling.traced``, its events read by :func:`read_events`."""
    from torch.profiler import ProfilerActivity, profile

    trace = profiling.Trace()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield trace
        torch.cuda.synchronize()
        trace.wall_s = time.perf_counter() - t0
    read_events(prof, trace)


class Setup(offline_batch.Setup):
    """``offline_batch.Setup`` with a lane a file; the beam's settings
    from the configuration's ``search``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, dict(traffic, lanes=traffic["files"]), seed,
                         device)
        self.seed, self.search = seed, config["search"]
        self.run_beam = pipelined_beam()

    def draws(self) -> tuple:
        """The beam's draws from the seed, as its generator makes them:
        the first latents' noise and one re-seeding draw a chunk but the
        last, each (F·R, L)."""
        R, L = self.search["restarts"], self.noise.shape[1]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        shape = (self.traffic["files"] * R, L)
        n = -(-int(self.lengths.max()) // self.search["branch_every"])
        return [torch.randn(shape, generator=gen, device=self.device)
                for _ in range(n)]

    def one_pass(self, frames: int | None = None):
        """One pass over the files (their first ``frames`` frames only, for
        a warm-up): (winners on the host, cumulative losses, chunks)."""
        s = self.search
        lengths = self.lengths_t if frames is None else \
            torch.clamp(self.lengths_t, max=frames)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        with span("run_hypotheses_batched"):
            return self.run_beam(
                self.engine, gen, s["restarts"], self.dqs, self.global_pos,
                self.global_rot, self.heights0, self.dqs[:, 0][:, :, None],
                lengths=lengths, branch_every=s["branch_every"],
                sigma=s["branch_sigma"], survivors=s["survivors"],
                sync_k=self.traffic["sync_k"], return_chunks=True)


def sample(setup: Setup, result, seed: int) -> tuple:
    """The judge's sample, drawn from the seed: the files whose beam it
    checks, and the lineages it follows ((file, last lane): those files'
    winners, then lanes across the beam); both in the record's files."""
    tr, R = setup.traffic, setup.search["restarts"]
    _, cum, _ = result
    rng = np.random.default_rng([seed, 1])
    check = rng.choice(tr["files"], size=tr["check_files"], replace=False)
    winners = check * R + cum[check].argmin(axis=1)
    lanes = rng.choice(np.setdiff1d(np.arange(tr["files"] * R), winners),
                       size=tr["check_lanes"], replace=False)
    follow = np.concatenate((winners, lanes))
    files = np.unique(np.concatenate((check, follow // R)))
    at = {int(f): i for i, f in enumerate(files)}
    return ([at[int(f)] for f in check],
            [(at[int(x // R)], int(x % R)) for x in follow], files)


def record(setup: Setup, result, files) -> dict:
    """What the judge reads of a pass (:mod:`benchmark.reference.beam`),
    for the files ``files``: their inputs, the beam's draws, and per chunk
    their lanes' fit losses and parent tables, and the outputs and states
    of the lanes it kept (``kept``; NaN, or -1, at a lane it dropped)."""
    won, cum, chunks = result
    R, dev = setup.search["restarts"], setup.device
    Fr = len(files)
    f = torch.as_tensor(files, device=dev)
    idx = (f[:, None] * R + torch.arange(R, device=dev)).reshape(-1)
    lanes = lambda x: x[idx].unflatten(0, (Fr, R))  # noqa: E731

    def leaves(c, tree) -> dict:
        row = c.row[idx]
        gone = row < 0
        out = {}
        for k, v in tree._asdict().items():
            x = v[row.clamp(min=0)]
            fill = float("nan") if x.is_floating_point() else -1
            out[k] = torch.where(gone.view(-1, *[1] * (x.dim() - 1)), fill,
                                 x).unflatten(0, (Fr, R))
        return out

    draws = setup.draws()
    return dict(
        dqs=setup.dqs[f], global_pos=setup.global_pos[f],
        global_rot=setup.global_rot[f], heights0=setup.heights0[f],
        lengths=setup.lengths_t[f], noise=lanes(draws[0]),
        eps=[lanes(e) for e in draws[1:]],
        chunks=[dict(lo=c.lo, hi=c.hi, kept=lanes(c.row >= 0),
                     out=leaves(c, c.out), score=lanes(c.score),
                     parent=lanes(c.parent) % R, start=leaves(c, c.start),
                     end=leaves(c, c.end))
                for c in chunks],
        cum=cum[files],
        emitted={k: torch.as_tensor(v[files], device=dev)
                 for k, v in won._asdict().items()})


def steps_per_frame(setup: Setup, launches, passes: int) -> float:
    """K1's lane-steps a real lane-frame over every lane of ``passes``
    recorded passes (the beam keeps no dropped lane's outputs to count
    them by)."""
    frames = int(setup.lengths.sum()) * setup.search["restarts"] * passes
    return launches.k1_totals()[0] / max(frames, 1)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    marks = [("start", t_start), ("interpreter", harness.IMPORTED)]
    pipelined_beam()
    setup = Setup(cell.config, cell.traffic, seed, device)
    marks.append(("torch, engine and inputs", time.time()))
    setup.one_pass(frames=8)          # builds K1 and K2, the block graph
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
            # no harness span around each K1 and K2 launch: a pass holds
            # thousands, and the breakdown's idle gaps scan back over
            # them, gap by gap (~150 s a traced pass, H100 host)
            with launches.recording(), traced() as tr_:
                with span("pass"):
                    result = setup.one_pass()
            rec.setdefault("traces", []).append(tr_)
            rec.setdefault("traced_outputs", []).append(result[0])
        else:
            result = setup.one_pass()
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
    if trace:
        print(f"K1 lane-steps a real lane-frame: "
              f"{steps_per_frame(setup, launches, passes):.4f}",
              file=sys.stderr)
    metrics = {"frames_per_s": attempted / window, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    R = setup.search["restarts"]
    rec.update(launches=launches, lengths=np.repeat(setup.lengths, R),
               passes=passes, window_s=window, outputs=result[0])
    check, follow, files = sample(setup, result, seed)
    kept = record(setup, result, files)
    departures, h, offsets = setup.departures, setup.hyper, setup.offsets
    search = setup.search
    del setup, result
    gaps = judged(cell, kept, check, follow, search, h, offsets, device)[1]
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


def judged(cell, kept: dict, check, follow, search, hyper, offsets,
           device) -> tuple:
    """(the reference frame, the judge's numbers), built once the
    program's state is freed."""
    if device != "cpu":
        torch.cuda.empty_cache()
    frame = common.reference_frame(cell.config, hyper, offsets, device)
    return frame, beam.follow_beam(frame, kept, check, follow,
                                   search["branch_sigma"],
                                   min(search["survivors"],
                                       search["restarts"]))


def _swap_winner(kept: dict, check, K: int) -> dict:
    """The first checked file's emitted frames replaced by its lineage of
    greatest (program) loss."""
    f = check[0]
    dev = kept["dqs"].device
    worst = torch.as_tensor([int(np.argmax(kept["cum"][f]))], device=dev)
    fs = torch.as_tensor([f], device=dev)
    got = beam._along(kept, fs, beam.lineage(kept, fs, worst),
                      len(kept["chunks"]))
    emitted = {k: v.clone() for k, v in kept["emitted"].items()}
    for k in emitted:
        emitted[k][f] = got[k][0].to(emitted[k].dtype)
    return dict(kept, emitted=emitted)


def _drop_move(kept: dict, check, K: int) -> dict:
    """Each re-seeded lane's start latent its parent's end latent: the
    ``σ · stds_latent · ε`` move dropped."""
    chunks = [dict(c) for c in kept["chunks"]]
    for c, nxt in zip(chunks, chunks[1:]):
        lat = c["end"]["latent"].gather(1, c["parent"][..., None].expand(
            -1, -1, c["end"]["latent"].shape[-1]))
        nxt["start"] = dict(nxt["start"], latent=lat)
    return dict(kept, chunks=chunks)


def _reverse_selection(kept: dict, check, K: int) -> dict:
    """Each resampling point's survivors the K lineages of greatest
    (program) cumulative loss, in place of the K least."""
    chunks = [dict(c) for c in kept["chunks"]]
    lengths = kept["lengths"]
    cum = 0.0
    for c in chunks[:-1]:
        n = (lengths - c["lo"]).clamp(0, c["hi"] - c["lo"])
        cum = cum + c["score"] * (n / lengths.clamp(min=1)).double()[:, None]
        R = cum.shape[1]
        order = cum.argsort(dim=1, descending=True)
        c["parent"] = order[:, torch.arange(R, device=order.device) % K]
        cum = cum.gather(1, c["parent"])
    return dict(kept, chunks=chunks)


FAULTS = {"swapped_winner": _swap_winner, "dropped_move": _drop_move,
          "reversed_selection": _reverse_selection}


def calibrate(cell, seed: int, seconds: float, control: bool,
              device="cuda") -> dict:
    """The judge's numbers for ``seed``: the program's after one pass over
    the cell's files; with ``control``, with faults planted in what the
    program kept (a quarter of the followed lineages' frames unmoved, a
    file's winner swapped for its worst lineage, the re-seeding move
    dropped, the worst lineages kept), and the reference's with TF32
    products in the program's place: the followed lineages run by it as
    plain chains, and the chunk scores read by it."""
    from benchmark.reference import control as ctl

    s = Setup(cell.config, cell.traffic, seed, device)
    s.one_pass(frames=8)
    result = s.one_pass()
    check, follow, files = sample(s, result, seed)
    kept = record(s, result, files)
    h, offsets, search = s.hyper, s.offsets, s.search
    del s, result
    t0 = time.perf_counter()
    frame, program = judged(cell, kept, check, follow, search, h, offsets,
                            device)
    res = {"program": program, "judge_s": time.perf_counter() - t0}
    if not control:
        return res
    sigma = search["branch_sigma"]
    K = min(search["survivors"], search["restarts"])
    dev = kept["dqs"].device
    f = torch.as_tensor([x[0] for x in follow], device=dev)
    last = torch.as_tensor([x[1] for x in follow], device=dev)
    inp, got, jump = beam.follow_lineages(frame, kept, f, last, sigma, K)
    res["fault_quarter_of_lanes"] = beam.follow_jumping(
        frame, inp, offline_batch.FAULTS["quarter_of_lanes"](got, inp), jump)
    for name, fault in FAULTS.items():
        res["fault_" + name] = beam.check_beam(frame, fault(kept, check, K),
                                               check, sigma, K)
    with ctl.tf32():
        played = ctl.offline(frame, inp)
        scores = beam.chunk_scores(frame, kept, check)
    res["control"] = beam.follow_jumping(frame, inp, played,
                                         torch.zeros_like(jump))
    chunks = [dict(c, score=c["score"].clone()) for c in kept["chunks"]]
    for c, s_ in zip(chunks, scores):
        c["score"][check] = torch.where(c["kept"][check],
                                        s_.to(c["score"].dtype),
                                        c["score"][check])
    res["control"].update(beam.check_beam(frame, dict(kept, chunks=chunks),
                                          check, sigma, K))
    return res
