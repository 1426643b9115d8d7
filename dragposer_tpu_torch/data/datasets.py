"""Datasets: windowed training data and evaluation sequences (port of
``dragposer_tpu/data/datasets.py``; numpy only).

Window semantics mirror ``python/src/motion_data.py``:

* VAE windows: length ``window_size`` every ``window_step``, kept while
  ``end < frames`` (the final frame never starts a window); a sample is a
  *pair of consecutive windows* (for the drag-consistency loss), and pairs
  run over the concatenated cross-file window list exactly like the
  reference's ``__getitem__`` (``motion_data.py:201-208``).
* temporal windows: length 120 every 16, kept while ``end + sample_step <
  frames``; past/future frame subsets, accumulated displacements and heights
  attached (``motion_data.py:79-101``).

Windows are stored as stacked host arrays; the trainer stages them on the
device once (``train/temporal.stage_dataset``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.ops.topology import Skeleton


# ---------------------------------------------------------------------------
# VAE training data
# ---------------------------------------------------------------------------

@dataclass
class VAETrainData:
    dqs: np.ndarray           # (N, window, J*8) normalized
    displacement: np.ndarray  # (N, window, 3) normalized
    offsets: np.ndarray       # (J, 3)
    means: Dict[str, np.ndarray]
    stds: Dict[str, np.ndarray]

    @property
    def n_pairs(self) -> int:
        return self.dqs.shape[0] - 1


def build_vae_dataset(motions: List[encoding.EncodedMotion], param,
                      means=None, stds=None) -> VAETrainData:
    if means is None:
        stats = encoding.RunningStats()
        for m in motions:
            stats.add(m)
        means, stds = stats.finalize()

    ws, step = param["window_size"], param["window_step"]
    dqs_windows, disp_windows = [], []
    for m in motions:
        n = encoding.normalize(m, means, stds)
        frames = n.dqs.shape[0]
        for start in range(0, frames, step):
            if start + ws < frames:
                dqs_windows.append(n.dqs[start : start + ws])
                disp_windows.append(n.displacement[start : start + ws])
    return VAETrainData(
        dqs=np.stack(dqs_windows).astype(np.float32),
        displacement=np.stack(disp_windows).astype(np.float32),
        offsets=motions[0].offsets,
        means=means,
        stds=stds,
    )


# ---------------------------------------------------------------------------
# Temporal training data
# ---------------------------------------------------------------------------

@dataclass
class TemporalTrainData:
    dqs_past: np.ndarray        # (N, P, J*8) normalized
    dqs_future: np.ndarray      # (N, Fut, J*8) normalized
    disp_past: np.ndarray       # (N, P, 3) normalized
    disp_future: np.ndarray     # (N, Fut, 3) normalized
    disp_past_acc: np.ndarray   # (N, P, 3) denormalized accumulated
    heights: np.ndarray         # (N, P, H) raw heights
    offsets: np.ndarray


def build_temporal_dataset(motions: List[encoding.EncodedMotion], param,
                           means, stds) -> TemporalTrainData:
    ws, step = param["window_size"], param["window_step"]
    sample_step = param["sample_step"]
    past = np.asarray(param["past_frames"])
    future = np.asarray(param["future_frames"])

    rows = {k: [] for k in
            ("dqs_past", "dqs_future", "disp_past", "disp_future",
             "disp_past_acc", "heights")}
    for m in motions:
        n = encoding.normalize(m, means, stds)
        frames = n.dqs.shape[0]
        for start in range(0, frames, step):
            end = start + ws
            if end + sample_step >= frames:
                continue
            dq_w = n.dqs[start:end]
            disp_w = n.displacement[start : end + sample_step]
            # accumulated displacement stays RAW (the reference never
            # normalizes displacement_past_acc, motion_data.py:82-98)
            raw_w = m.displacement[start : end + sample_step]
            acc = np.stack(
                [raw_w[i : i + sample_step].sum(axis=0) for i in past]
            )
            rows["dqs_past"].append(dq_w[past])
            rows["dqs_future"].append(dq_w[future])
            rows["disp_past"].append(disp_w[past])
            rows["disp_future"].append(disp_w[future])
            rows["disp_past_acc"].append(acc)
            rows["heights"].append(m.heights[start:end][past])
    return TemporalTrainData(
        **{k: np.stack(v).astype(np.float32) for k, v in rows.items()},
        offsets=motions[0].offsets,
    )


# ---------------------------------------------------------------------------
# Directory loading
# ---------------------------------------------------------------------------

def load_motion_dir(
    directory: str,
    param,
    *,
    height_indices=None,
    sample_step=None,
    keep_bvh: bool = False,
) -> Tuple[List[encoding.EncodedMotion], Skeleton, List[Tuple[BVH, str]]]:
    """Encode every .bvh in a directory; asserts a shared skeleton."""
    motions, bvhs = [], []
    skeleton = None
    ref_parents = None
    for filename in sorted(os.listdir(directory)):
        if not filename.endswith(".bvh"):
            continue
        bvh = BVH().load(os.path.join(directory, filename))
        rots, pos, parents, offsets, _ = encoding.info_from_bvh(bvh)
        if ref_parents is None:
            ref_parents = parents
            skeleton = Skeleton.build(parents, offsets, bvh.names)
        assert np.array_equal(ref_parents, parents), (
            f"{filename}: skeleton differs from the first file"
        )
        motions.append(
            encoding.encode_motion(
                offsets, pos[:, 0, :], rots, skeleton,
                downsample=param["downsample"],
                height_indices=height_indices,
                sample_step=sample_step,
            )
        )
        if keep_bvh:
            bvhs.append((bvh, filename))
    if skeleton is None:
        raise ValueError(f"no .bvh files in {directory}")
    return motions, skeleton, bvhs


# ---------------------------------------------------------------------------
# Preprocessing cache (reference: train_data[_temporal].pt, motion_data.py:178-199)
# ---------------------------------------------------------------------------

def cache_path(data_dir: str, temporal: bool) -> str:
    name = "train_data_temporal.npz" if temporal else "train_data.npz"
    return os.path.join(data_dir, name)


def try_load_cache(path: str) -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_cache(path: str, arrays: Dict[str, np.ndarray]) -> None:
    try:
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError as e:  # read-only data dirs: skip caching
        print(f"preprocessing cache not written ({e})")


def load_or_build_vae_dataset(motions, param, data_dir: str,
                              means=None, stds=None) -> VAETrainData:
    """Windowed-dataset cache, as the reference's train_data.pt
    (``motion_data.py:178-199``); stats are recomputed when not forced."""
    path = cache_path(data_dir, temporal=False)
    cached = try_load_cache(path) if means is None else None
    if cached is not None:
        return VAETrainData(
            dqs=cached["dqs"], displacement=cached["displacement"],
            offsets=cached["offsets"],
            means={"dqs": cached["means_dqs"],
                   "displacement": cached["means_displacement"]},
            stds={"dqs": cached["stds_dqs"],
                  "displacement": cached["stds_displacement"]},
        )
    data = build_vae_dataset(motions, param, means, stds)
    if means is None:
        save_cache(path, {
            "dqs": data.dqs, "displacement": data.displacement,
            "offsets": data.offsets,
            "means_dqs": data.means["dqs"],
            "means_displacement": data.means["displacement"],
            "stds_dqs": data.stds["dqs"],
            "stds_displacement": data.stds["displacement"],
        })
    return data


def load_or_build_temporal_dataset(motions, param, means, stds,
                                   data_dir: str) -> TemporalTrainData:
    path = cache_path(data_dir, temporal=True)
    cached = try_load_cache(path)
    if cached is not None:
        return TemporalTrainData(**cached)
    data = build_temporal_dataset(motions, param, means, stds)
    save_cache(path, {
        "dqs_past": data.dqs_past, "dqs_future": data.dqs_future,
        "disp_past": data.disp_past, "disp_future": data.disp_future,
        "disp_past_acc": data.disp_past_acc, "heights": data.heights,
        "offsets": data.offsets,
    })
    return data
