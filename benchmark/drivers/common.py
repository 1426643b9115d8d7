"""What the drivers share: the reference frame of a configuration, and the
record of the kernels' launches that the per-layer metrics read."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from benchmark import synth
from benchmark.harness import ROOT
from benchmark.reference.drag import Frame, Hyper
from benchmark.reference.model import (Skeleton, Transformer, Vae,
                                       file_sha256, load_npz)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def model_files(config: dict) -> dict:
    """The model's weight files, each checked against the digest the
    configuration states."""
    files = {}
    for name, digest in config["weights_sha256"].items():
        path = os.path.join(ROOT, config["model_dir"], name)
        if file_sha256(path) != digest:
            raise ValueError(f"{path} is not the file the configuration "
                             "states")
        files[name] = path
    return files


def hyper(config: dict, optimizer: dict, adjustment: bool) -> Hyper:
    t, tr = config["tracker"], config["temporal"]
    ee = [j for j, m in enumerate(t["mask"]) if m]
    adj = None
    if adjustment and t["enable_joint_adjustment"]:
        joint, slot = t["joint_adjustment_indices"]
        adj = (int(joint), ee[int(slot)])
    return Hyper(
        mask=tuple(float(m) for m in t["mask"]),
        weights=tuple(tuple(w) for w in t["weights"]),
        lambda_rot=float(config["lambda_rot"]),
        lambda_temporal=float(t["lambda_temporal"]),
        window=int(t["temporal_future_window"]),
        sample_step=int(tr["sample_step"]),
        past_frames=tuple(tr["past_frames"]),
        height_indices=tuple(config["height_indices"]),
        adjustment=adj, adjustment_weight=float(t["joint_adjustment_weight"]),
        max_iter=int(optimizer["max_iter"]),
        eps_pos=float(optimizer["stop_eps_pos"]),
        eps_rot=float(optimizer["stop_eps_rot"]),
        min_incr=float(optimizer["min_loss_incr"]),
        lr=float(optimizer["learning_rate"]))


def reference_vae(config: dict, device) -> Vae:
    return Vae(load_npz(model_files(config)["generator.npz"]), synth.PARENTS,
               int(config["vae"]["neighbor_distance"]), device)


def reference_frame(config: dict, h: Hyper, offsets, device) -> Frame:
    files = model_files(config)
    tr = config["temporal"]
    return Frame(reference_vae(config, device),
                 Transformer(load_npz(files["temporal.npz"]),
                             int(tr["n_heads"]), int(tr["positional_rows"]),
                             device),
                 Skeleton(synth.PARENTS, torch.as_tensor(offsets,
                                                          device=device)), h)


def departures(engine_hyper, h: Hyper) -> list:
    """Where the program's drag settings differ from the configuration."""
    stated = dict(max_iter=h.max_iter, stop_eps_pos=h.eps_pos,
                  stop_eps_rot=h.eps_rot, min_loss_incr=h.min_incr,
                  learning_rate=h.lr, lambda_rot=h.lambda_rot,
                  lambda_temporal=h.lambda_temporal,
                  temporal_future_window=h.window,
                  sample_step=h.sample_step,
                  past_frames=tuple(h.past_frames),
                  height_indices=tuple(h.height_indices),
                  joint_adjustment=h.adjustment)
    if h.adjustment is not None:
        stated["joint_adjustment_weight"] = h.adjustment_weight
    out = []
    for k, v in stated.items():
        got = getattr(engine_hyper, k)
        if isinstance(v, tuple) and got is not None:
            got = tuple(got)
        if got != v and not (isinstance(v, float) and np.isclose(got, v,
                                                                 rtol=1e-6)):
            out.append(f"{k}: {got!r}, stated {v!r}")
    return out


class Launches:
    """While inside, records every launch of K1 (the lanes' steps taken, on
    the device, no sync) and of K2 (lanes, encoder and decoder rows), by
    wrapping the two module functions the program calls them through."""

    def __init__(self):
        self.k1_steps, self.k2_calls = [], []

    @contextlib.contextmanager
    def recording(self, spans: bool = False):
        from dragposer_tpu_torch.drag import iter_kernel
        from dragposer_tpu_torch.ops import temporal_fused

        from benchmark.profiling import span

        run, forward = iter_kernel.run_block_fused, temporal_fused.forward
        quiet = contextlib.nullcontext

        def k1(ctx, kctx, hyper, sync_k, opt, *rest):
            with (span("K1") if spans else quiet()):
                out = run(ctx, kctx, hyper, sync_k, opt, *rest)
            self.k1_steps.append(out.t - opt.t)
            return out

        def k2(packed, tparam, enc, dec, mask):
            self.k2_calls.append((int(enc.shape[0]), int(enc.shape[1]),
                                  int(dec.shape[1])))
            with (span("K2") if spans else quiet()):
                return forward(packed, tparam, enc, dec, mask)

        iter_kernel.run_block_fused, temporal_fused.forward = k1, k2
        try:
            yield self
        finally:
            iter_kernel.run_block_fused, temporal_fused.forward = run, forward

    def k1_totals(self) -> tuple:
        """(lane-steps taken, lanes × the longest lane's steps) summed over
        the K1 launches."""
        if not self.k1_steps:
            return 0, 0
        s = torch.stack([x.long() for x in self.k1_steps])
        return int(s.sum()), int(s.amax(1).sum()) * s.shape[1]
