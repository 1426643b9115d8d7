"""Offline evaluation on a rig and a model of the configuration's own:
``offline_batch``'s passes, judge and recording on another skeleton.

The configuration names the skeleton (``skeleton``: joint names, parents,
offsets), the VAE's and the transformer's published hyperparameters, and
``weights_seed``: no trained model exists for the rig, so its weights are
drawn here in plain NumPy, with the distributions of the port's
``vae.init_params`` and ``temporal.init_params``, into a model directory of
this run (``build/bench_models/``, in the example model's ``.npz`` key
layout).  The dual-quaternion statistics come from the example model by
joint name (a joint the example lacks takes its ``stats_joint``'s row), the
displacement's and the latent's as they are.  The program loads that
directory with its normal loader (``eval_drag.build_engine``); the
reference reads the same files, by their digests.

Traffic parameters: those of ``offline_batch``.  The run's seed sets the
order of the lanes, the first latents' draw and the lanes the judge reads.
The rig's bone lengths (each bone ×(1 + 0.05 N(0, 1))) come from the mix's
``motion_seed``, as the motion does, and the weights are the
configuration's: the work is the same from seed to seed (bone lengths
drawn from the seed move a pass's count of Adam steps, and so its time).
"""

from __future__ import annotations

import atexit
import collections
import os
import shutil
import sys
import tempfile
import types

import numpy as np
import torch

from benchmark import program_trace, synth
from benchmark.drivers import common, offline_batch
from benchmark.harness import ROOT
from benchmark.reference import judge
from benchmark.reference.model import (DEC_CHANNELS, ENC_CHANNELS,
                                       POOL_LEVELS, Skeleton, Transformer,
                                       Vae, file_sha256, load_npz,
                                       neighbourhoods, pool_levels)
from benchmark.reference.drag import Frame

MODELS = os.path.join(ROOT, "build", "bench_models")


def parents(config: dict) -> np.ndarray:
    return np.asarray(config["skeleton"]["parents"], dtype=np.int64)


def bone_offsets(config: dict, rng: np.random.Generator) -> np.ndarray:
    """The rig's offsets with seeded bone lengths (±5%), to the 6 decimals
    a BVH file keeps (as ``synth.skeleton_offsets``)."""
    base = np.asarray(config["skeleton"]["offsets"], dtype=np.float64)
    off = np.round(base * (1.0 + 0.05 * rng.normal(size=(len(base), 1))), 6)
    off[0] = 0.0
    return off.astype(np.float32)


def _conv(rng, hoods, cpj: int) -> tuple:
    """A skeleton convolution of kernel 1: each joint's rows U(±1/√fan_in)
    on its neighbourhood's columns, nought elsewhere; its bias alike."""
    n = len(hoods)
    w = np.zeros((n * cpj, n * cpj, 1), np.float32)
    b = np.zeros(n * cpj, np.float32)
    for i, hood in enumerate(hoods):
        cols = (np.asarray(hood)[:, None] * cpj + np.arange(cpj)).ravel()
        bound = 1.0 / np.sqrt(len(cols))
        rows = slice(i * cpj, (i + 1) * cpj)
        w[rows, cols, 0] = rng.uniform(-bound, bound, (cpj, len(cols)))
        b[rows] = rng.uniform(-bound, bound, cpj)
    return w, b


def _xavier(rng, n_in: int, n_out: int) -> np.ndarray:
    edge = np.sqrt(6.0 / (n_in + n_out))
    return rng.uniform(-edge, edge, (n_out, n_in)).astype(np.float32)


def _linear(rng, n_in: int, n_out: int, weight: str = "uniform") -> tuple:
    """``nn.Linear``'s U(±1/√fan_in) bias, and its weight ("uniform"),
    xavier's ("xavier") or nought ("zero")."""
    bound = 1.0 / np.sqrt(n_in)
    if weight == "xavier":
        w = _xavier(rng, n_in, n_out)
    elif weight == "zero":
        w = np.zeros((n_out, n_in), np.float32)
    else:
        w = rng.uniform(-bound, bound, (n_out, n_in)).astype(np.float32)
    return w, rng.uniform(-bound, bound, n_out).astype(np.float32)


def generator_arrays(config: dict, rng: np.random.Generator) -> dict:
    """``generator.npz``'s parameters for the rig: the encoder's and the
    decoder's skeleton convolutions on the pooled levels' neighbourhoods,
    ``f_mu``, ``f_logvar`` (its weight nought, as at init), ``f_latent``."""
    p, v = parents(config), config["vae"]
    radius, latent = int(v["neighbor_distance"]), int(v["latent_dim"])
    enc_levels, _ = pool_levels(p, decoder=False)
    dec_levels, _ = pool_levels(p, decoder=True)
    out = {}

    def put(prefix, wb):
        out[prefix + "/w"], out[prefix + "/b"] = wb

    for l in range(POOL_LEVELS):
        put(f"params/encoder/convs/{l}", _conv(
            rng, neighbourhoods(enc_levels[l], radius, False), ENC_CHANNELS))
    pooled = ENC_CHANNELS * len(enc_levels[-1])
    put("params/encoder/f_mu", _linear(rng, pooled, latent))
    put("params/encoder/f_logvar", _linear(rng, pooled, latent, "zero"))
    put("params/decoder/f_latent",
        _linear(rng, latent, DEC_CHANNELS * len(dec_levels[-1])))
    for l in range(POOL_LEVELS):
        put(f"params/decoder/convs/{l}", _conv(
            rng, neighbourhoods(dec_levels[POOL_LEVELS - 1 - l], radius,
                                True), DEC_CHANNELS))
    return out


def temporal_arrays(config: dict, rng: np.random.Generator) -> dict:
    """``temporal.npz``'s parameters: ``nn.Transformer`` (post-norm) with
    its xavier weights and nought attention biases, the outer projections
    as ``nn.Linear``, the layer norms at one and nought."""
    t = config["temporal"]
    d, ff = int(t["d_model"]), int(t["dim_feedforward"])
    latent = int(config["vae"]["latent_dim"])
    out = {}

    def put(prefix, wb):
        out[prefix + "/w"], out[prefix + "/b"] = wb

    def attention(prefix):
        out[prefix + "/in_w"] = _xavier(rng, d, 3 * d)
        out[prefix + "/in_b"] = np.zeros(3 * d, np.float32)
        out[prefix + "/out_w"] = _xavier(rng, d, d)
        out[prefix + "/out_b"] = np.zeros(d, np.float32)

    def norm(prefix):
        out[prefix + "/g"] = np.ones(d, np.float32)
        out[prefix + "/b"] = np.zeros(d, np.float32)

    put("params/in_proj_enc",
        _linear(rng, latent + 3 + len(config["height_indices"]), d))
    put("params/in_proj_dec", _linear(rng, latent, d))
    put("params/out_proj", _linear(rng, d, latent))
    for kind, n, attns, norms in (
            ("enc", t["n_encoder_layers"], ("self_attn",), 2),
            ("dec", t["n_decoder_layers"], ("self_attn", "cross_attn"), 3)):
        for i in range(int(n)):
            prefix = f"params/{kind}_layers/{i}"
            for a in attns:
                attention(f"{prefix}/{a}")
            put(prefix + "/ff1", _linear(rng, d, ff, "xavier"))
            put(prefix + "/ff2", _linear(rng, ff, d, "xavier"))
            for k in range(norms):
                norm(f"{prefix}/ln{k + 1}")
    norm("params/enc_norm")
    norm("params/dec_norm")
    return out


def _example(config: dict, part: str) -> dict:
    src = config["statistics_from"]
    path = os.path.join(ROOT, src[part])
    if file_sha256(path) != src[part + "_sha256"]:
        raise ValueError(f"{path} is not the file the configuration states")
    return load_npz(path)


def statistics(config: dict) -> dict:
    """``generator.npz``'s ``extra/``: each joint's dual-quaternion mean
    and std the example model's row of the same name, or of its
    ``stats_joint``; the displacement's the example's."""
    ex = _example(config, "generator")
    sk = config["skeleton"]
    rows = [list(synth.JOINT_NAMES).index(sk["stats_joint"].get(n, n))
            for n in sk["names"]]
    out = {f"extra/{k}/displacement": ex[f"extra/{k}/displacement"]
           for k in ("means", "stds")}
    for k in ("means", "stds"):
        out[f"extra/{k}/dqs"] = ex[f"extra/{k}/dqs"].reshape(-1, 8)[
            rows].reshape(-1)
    return out


def write_model(config: dict, directory: str) -> dict:
    """The rig's model drawn from ``weights_seed`` into ``directory``:
    {file name: path}."""
    rng = np.random.default_rng(int(config["weights_seed"]))
    ex = _example(config, "temporal")
    arrays = {
        "generator.npz": {**generator_arrays(config, rng),
                          **statistics(config)},
        "temporal.npz": {**temporal_arrays(config, rng),
                         "extra/means_latent": ex["extra/means_latent"],
                         "extra/stds_latent": ex["extra/stds_latent"]}}
    paths = {}
    for name, flat in arrays.items():
        paths[name] = os.path.join(directory, name)
        np.savez(paths[name], **flat)
    return paths


_MODELS: dict = {}


def with_model(config: dict) -> dict:
    """The configuration with ``model_dir`` and ``weights_sha256`` of its
    model, written once a process into a directory of its own under
    ``build/bench_models/`` (removed at exit), as ``common.model_files``
    reads a configuration."""
    key = (config["name"], int(config["weights_seed"]))
    if key not in _MODELS:
        os.makedirs(MODELS, exist_ok=True)
        directory = tempfile.mkdtemp(prefix=f"{config['name']}-", dir=MODELS)
        atexit.register(shutil.rmtree, directory, True)
        paths = write_model(config, directory)
        _MODELS[key] = {"model_dir": directory, "weights_sha256": {
            n: file_sha256(p) for n, p in paths.items()}}
    return dict(config, **_MODELS[key])


def reference_vae(config: dict, device) -> Vae:
    return Vae(load_npz(common.model_files(config)["generator.npz"]),
               parents(config), int(config["vae"]["neighbor_distance"]),
               device)


def reference_frame(config: dict, h, offsets, device) -> Frame:
    files = common.model_files(config)
    tr = config["temporal"]
    return Frame(reference_vae(config, device),
                 Transformer(load_npz(files["temporal.npz"]),
                             int(tr["n_heads"]), int(tr["positional_rows"]),
                             device),
                 Skeleton(parents(config), torch.as_tensor(offsets,
                                                           device=device)), h)


class Setup(offline_batch.Setup):
    """``offline_batch.Setup`` on the configuration's rig and model: the
    engine from ``build_engine`` on the model's directory with the
    configuration's tracker and height joints, the rig's bone lengths from
    the mix, and the inputs drawn as there."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dragposer_tpu_torch import config as cfg
        from dragposer_tpu_torch.cli import eval_drag
        from dragposer_tpu_torch.ops import topology

        config = with_model(config)
        self.config, self.traffic, self.device = config, traffic, device
        self.parents = parents(config)
        self.offsets = bone_offsets(config, np.random.default_rng(
            (traffic["motion_seed"], 1)))
        opt = traffic["optimizer"]
        self.hyper = common.hyper(config, opt, adjustment=True)
        skeleton = topology.Skeleton.build(self.parents, self.offsets,
                                           config["skeleton"]["names"])
        self.engine, _, _ = eval_drag.build_engine(
            config["model_dir"], self.parents,
            cfg.TrackerConfig.from_dict(config["tracker"]),
            skeleton=skeleton, max_iter=opt["max_iter"],
            learning_rate=opt["learning_rate"],
            height_indices=config["height_indices"], device=device)
        self.departures = common.departures(self.engine.hyper, self.hyper)
        self.make_inputs(seed, np.random.default_rng(seed))

    def make_inputs(self, seed: int, rng: np.random.Generator) -> None:
        """``offline_batch.Setup.make_inputs`` with the rig's parents (that
        one reads the example rig's)."""
        tr, dev = self.traffic, self.device
        vae = reference_vae(self.config, dev)
        skeleton = Skeleton(self.parents, torch.as_tensor(self.offsets,
                                                          device=dev))
        B = tr["lanes"]
        motion = np.random.default_rng(tr["motion_seed"])
        lengths = offline_batch.lane_lengths(
            tr, motion, self.config.get("corpus_longest_frames", 0))
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


def judged(cell, inp: dict, got: dict, hyper, offsets, device) -> tuple:
    """``offline_batch.judged`` on the rig's reference."""
    if device != "cpu":
        torch.cuda.empty_cache()
    frame = reference_frame(with_model(cell.config), hyper, offsets, device)
    return frame, judge.follow_offline(frame, inp, got)


def _rebound(fn):
    """``offline_batch``'s function ``fn`` with this module's ``Setup`` and
    ``judged`` in place of its own: the same passes, recording and judge."""
    names = dict(vars(offline_batch), Setup=Setup, judged=judged)
    return types.FunctionType(fn.__code__, names, fn.__name__,
                              fn.__defaults__)


_run = _rebound(offline_batch.run)
calibrate = _rebound(offline_batch.calibrate)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    """``offline_batch.run`` on the rig; a traced run also prints which of
    K1's builds its launches took (the program's launch records)."""
    out = _run(cell, seed, seconds, trace, device, t_start)
    if trace:
        layouts = collections.Counter(
            r.get("layout", "?") for r in program_trace.launch_log(
                "K1_general"))
        print(f"K1 launches: narrow {len(program_trace.launch_log('K1'))}, "
              f"general {dict(layouts)}", file=sys.stderr)
    return out
