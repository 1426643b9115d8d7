"""Small cells for the benchmark's CPU tests: the same drivers and judge at
a few lanes and frames, on the CPU (the port's plain twins of its
kernels)."""

import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "offline_batch": dict(lanes=12, min_frames=10, max_frames=28,
                          pool_clips=3, pool_frames=64, check_lanes=3),
    "session": dict(warmup_frames=18, check_frames=12),
}


def small_cell(name: str):
    from benchmark import harness

    c = harness.cell(name)
    traffic = dict(c.traffic, **SMALL[c.traffic["kind"]])
    if traffic.get("lengths") == "equal":
        traffic.update(min_frames=20, max_frames=20)
    config = dict(c.config)
    if "corpus_longest_frames" in config:
        config["corpus_longest_frames"] = 28
    return dataclasses.replace(c, traffic=traffic, config=config)


@pytest.fixture
def small():
    import torch

    torch.set_num_threads(2)
    return small_cell
