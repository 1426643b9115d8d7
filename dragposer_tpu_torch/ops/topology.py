"""Skeleton topology precompute (host-side NumPy, all static).

The port's own copy of ``dragposer_tpu/ops/topology.py``.  Everything here
runs once at model-build time and produces static constants (masks, pooling
matrices, ancestor matrices, level schedules) consumed by the device code.
Semantics must match the reference topology functions exactly because the pretrained checkpoint's convolution masks and pool shapes
depend on them (reference: ``python/src/skeleton.py:133-362``).  Golden values
for the 22-joint AMASS skeleton are locked in ``tests/test_topology.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Graph distances & neighborhoods
# ---------------------------------------------------------------------------

def distance_matrix(parents: Sequence[int]) -> np.ndarray:
    """All-pairs joint distance over the skeleton tree (BFS per node)."""
    n = len(parents)
    adj: List[List[int]] = [[] for _ in range(n)]
    for j in range(1, n):
        p = int(parents[j])
        if p != j:
            adj[j].append(p)
            adj[p].append(j)
    dist = np.full((n, n), np.inf)
    for src in range(n):
        dist[src, src] = 0
        frontier = [src]
        d = 0
        seen = {src}
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        dist[src, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def neighbor_lists(
    parents: Sequence[int], max_dist: int, add_displacement: bool = True
) -> List[List[int]]:
    """Per-joint lists of joints within ``max_dist`` graph hops (ascending).

    When ``add_displacement`` is set, a pseudo-joint (index ``n_joints``) is
    appended that shares the root's neighborhood: it is added to the list of
    every joint in the root's neighborhood, and its own list is the root's
    neighborhood plus itself (reference ``skeleton.py:341-362``).
    """
    dist = distance_matrix(parents)
    n = len(parents)
    lists = [[j for j in range(n) if dist[i, j] <= max_dist] for i in range(n)]
    if add_displacement:
        disp = n
        root_hood = list(lists[0])
        for i in root_hood:
            lists[i].append(disp)
        lists.append(root_hood + [disp])
    return lists


def _degrees(parents: Sequence[int]) -> np.ndarray:
    """Number of joints at graph distance exactly 1 (parent + children)."""
    dist = distance_matrix(parents)
    return (dist == 1).sum(axis=1)


# ---------------------------------------------------------------------------
# Pooling (joint-collapse) schedule
# ---------------------------------------------------------------------------

def _collapse_joints(parents: Sequence[int]) -> List[int]:
    """Joints to merge into neighbors at one pooling level.

    Depth-first from the root (visiting the highest-index neighbor first, to
    match the reference's stack traversal); a joint is collapsed iff it is not
    the root, its parent was not collapsed, and it is not a leaf.  The
    displacement pseudo-joint participates in the adjacency but is never
    collapsed (reference ``skeleton.py:248-269``).
    """
    n = len(parents)
    degrees = _degrees(parents)
    direct = neighbor_lists(parents, 1, add_displacement=True)
    collapsed: List[int] = []
    visited = set()
    stack: List[Tuple[int, int]] = [(0, -1)]
    while stack:
        cur, par = stack.pop()
        if cur == n:  # displacement pseudo-joint: skip
            continue
        visited.add(cur)
        if par != -1 and par not in collapsed and degrees[cur] > 1:
            collapsed.append(cur)
        stack.extend(
            (nb, cur) for nb in direct[cur] if nb != cur and nb not in visited
        )
    return collapsed


def pooling_schedule(
    parents: Sequence[int], add_displacement: bool = True
) -> Tuple[List[List[int]], List[int]]:
    """One level of skeleton pooling.

    Returns ``(pooling_list, new_parents)``: entry *i* of ``pooling_list``
    holds the old-joint indices merged into new joint *i* (the surviving joint
    first); collapsed joints are appended to the entry of each of their direct
    tree neighbors.  When ``add_displacement`` is set a final entry averaging
    over *all* old joints is appended (the displacement channel's pool).
    Reference: ``skeleton.py:133-175``.
    """
    n = len(parents)
    collapsed = set(_collapse_joints(parents))
    direct = neighbor_lists(parents, 1, add_displacement=True)

    pooling: List[List[int]] = []
    old_to_new = {}
    new_to_old = {}
    for j in range(n):
        if j not in collapsed:
            old_to_new[j] = len(pooling)
            new_to_old[len(pooling)] = j
            pooling.append([j])
    for j in range(n):
        if j in collapsed:
            for nb in direct[j]:
                if nb != j and nb != n:  # not itself, not displacement
                    pooling[old_to_new[nb]].append(j)

    new_parents = []
    for i in range(len(pooling)):
        anc = int(parents[new_to_old[i]])
        while anc not in old_to_new:
            anc = int(parents[anc])
        new_parents.append(old_to_new[anc])

    if add_displacement:
        pooling.append(list(range(n)))

    return pooling, new_parents


# ---------------------------------------------------------------------------
# Static matrices consumed by the networks
# ---------------------------------------------------------------------------

def expand_neighbors(neighbors: List[List[int]], channels: int) -> List[List[int]]:
    """Joint-level neighbor lists → channel-level column indices."""
    return [
        [k * channels + c for k in hood for c in range(channels)]
        for hood in neighbors
    ]


def conv_mask(
    neighbors: List[List[int]], in_channels: int, out_channels: int, kernel: int
) -> np.ndarray:
    """Binary mask (out, in, kernel) restricting a dense conv to the skeleton graph."""
    n = len(neighbors)
    mask = np.zeros((n * out_channels, n * in_channels, kernel), dtype=np.float32)
    for i, hood in enumerate(expand_neighbors(neighbors, in_channels)):
        mask[i * out_channels : (i + 1) * out_channels, hood, :] = 1.0
    return mask


def pool_matrix(pooling: List[List[int]], n_old: int, channels: int) -> np.ndarray:
    """Averaging pool matrix (n_new*channels, n_old*channels)."""
    n_new = len(pooling)
    w = np.zeros((n_new * channels, n_old * channels), dtype=np.float32)
    for i, merged in enumerate(pooling):
        for j in merged:
            for c in range(channels):
                w[i * channels + c, j * channels + c] = 1.0 / len(merged)
    return w


def unpool_matrix(pooling: List[List[int]], channels: int) -> np.ndarray:
    """Expansion matrix (n_out*channels, n_in*channels); n_out = |∪ merged| + 1.

    The +1 appends the displacement pseudo-joint row block (reference
    ``skeleton.py:213-245``); joints appearing in several pooling entries
    accumulate their copies.
    """
    covered = {j for merged in pooling for j in merged}
    n_out = len(covered) + 1
    n_in = len(pooling)
    w = np.zeros((n_out * channels, n_in * channels), dtype=np.float32)
    for i, merged in enumerate(pooling):
        for j in merged:
            for c in range(channels):
                w[j * channels + c, i * channels + c] += 1.0
    return w


# ---------------------------------------------------------------------------
# FK static structure
# ---------------------------------------------------------------------------

def depth_levels(parents: Sequence[int]) -> List[np.ndarray]:
    """Joints grouped by tree depth (level 0 = root); static FK schedule."""
    n = len(parents)
    depth = np.zeros(n, dtype=np.int64)
    for j in range(1, n):
        depth[j] = depth[int(parents[j])] + 1
    return [np.nonzero(depth == d)[0] for d in range(int(depth.max()) + 1)]


def ancestor_matrix(parents: Sequence[int]) -> np.ndarray:
    """A[j, a] = 1 iff ``a`` lies on the root→j path, root excluded, self included.

    Row 0 (the root) is all zeros.  Positions then follow from the fully
    parallel form ``pos = root_pos + A @ contrib`` where
    ``contrib[a] = R_world[parent[a]] · offset[a]`` — the parallel
    replacement for the reference's sequential FK chain
    (``python/src/utils.py:109-149``).
    """
    n = len(parents)
    a = np.zeros((n, n), dtype=np.float32)
    for j in range(1, n):
        k = j
        while k != 0:
            a[j, k] = 1.0
            k = int(parents[k])
    return a


@dataclass(frozen=True)
class Skeleton:
    """Static skeleton description shared by all compiled programs."""

    parents: np.ndarray           # (J,) int, parents[0] == 0
    offsets: np.ndarray           # (J, 3) float32, offsets[0] == 0
    names: Tuple[str, ...] = ()
    levels: List[np.ndarray] = field(default_factory=list)
    ancestors: np.ndarray = None  # (J, J) float32
    # FK's constants as tensors, by (device, dtype) (``ops/fk.py``)
    tensors: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)

    @staticmethod
    def build(parents, offsets, names=()) -> "Skeleton":
        parents = np.asarray(parents, dtype=np.int64).copy()
        parents[0] = 0
        offsets = np.asarray(offsets, dtype=np.float32).copy()
        offsets[0] = 0.0
        return Skeleton(
            parents=parents,
            offsets=offsets,
            names=tuple(names),
            levels=depth_levels(parents),
            ancestors=ancestor_matrix(parents),
        )

    @property
    def n_joints(self) -> int:
        return len(self.parents)
