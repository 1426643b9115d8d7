"""Plain reference of the DragPoser networks, read from the model's ``.npz``.

Written from the published description (UPC-ViRVIG/DragPoser: the
skeleton-aware pose VAE, root-space forward kinematics, the seq2seq temporal
transformer) in plain PyTorch and NumPy.  It imports nothing of the program:
the skeleton topology (neighbourhoods, joint pooling, masks, pool and unpool
matrices), the folded decoder, the encoder and the transformer are worked out
here again from the raw weights.

Quaternions are ``[w, x, y, z]``; a pose is *root-space*: slot 0 is the root's
rotation, slot j > 0 the product of the local rotations from the root's child
down to joint j.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

LEAKY_SLOPE = 0.2
ENC_CHANNELS = 8     # encoder channels per joint (a dual quaternion)
DEC_CHANNELS = 4     # decoder channels per joint (a quaternion)
POOL_LEVELS = 3


def file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


# ---------------------------------------------------------------------------
# Skeleton topology
# ---------------------------------------------------------------------------

def hop_distances(parents: Sequence[int]) -> np.ndarray:
    """Graph distance between every two joints of the tree."""
    n = len(parents)
    d = np.full((n, n), np.inf)
    adjacent = [set() for _ in range(n)]
    for j in range(1, n):
        adjacent[j].add(int(parents[j]))
        adjacent[int(parents[j])].add(j)
    for s in range(n):
        d[s, s] = 0
        frontier, hops = [s], 0
        while frontier:
            hops += 1
            frontier = [v for u in frontier for v in adjacent[u]
                        if d[s, v] == np.inf]
            for v in frontier:
                d[s, v] = hops
    return d


def neighbourhoods(parents, radius: int, displacement: bool) -> List[List[int]]:
    """Joints within ``radius`` hops of each joint, ascending.  With
    ``displacement``, a pseudo-joint ``n`` shares the root's neighbourhood:
    it joins the list of every joint there, and its own list is the root's
    plus itself."""
    d = hop_distances(parents)
    n = len(parents)
    hoods = [[j for j in range(n) if d[i, j] <= radius] for i in range(n)]
    if displacement:
        root = list(hoods[0])
        for i in root:
            hoods[i].append(n)
        hoods.append(root + [n])
    return hoods


def pool_once(parents, displacement: bool):
    """One level of joint pooling: a depth-first walk from the root, the
    last-listed neighbour first, merges every non-root joint that has more
    than one neighbour and whose parent in the walk was not merged.  Returns
    (groups of old joints per new joint, the new parents); with
    ``displacement`` a last group averages every old joint."""
    n = len(parents)
    d = hop_distances(parents)
    degree = (d == 1).sum(axis=1)
    direct = neighbourhoods(parents, 1, True)
    merged, seen, stack = [], set(), [(0, -1)]
    while stack:
        joint, came_from = stack.pop()
        if joint == n:
            continue
        seen.add(joint)
        if came_from != -1 and came_from not in merged and degree[joint] > 1:
            merged.append(joint)
        stack.extend((v, joint) for v in direct[joint]
                     if v != joint and v not in seen)
    kept = [j for j in range(n) if j not in merged]
    new_index = {j: i for i, j in enumerate(kept)}
    groups = [[j] for j in kept]
    for j in range(n):
        if j in merged:
            for v in direct[j]:
                if v not in (j, n):
                    groups[new_index[v]].append(j)
    new_parents = []
    for j in kept:
        a = int(parents[j])
        while a not in new_index:
            a = int(parents[a])
        new_parents.append(new_index[a])
    if displacement:
        groups.append(list(range(n)))
    return groups, new_parents


def pool_levels(parents, decoder: bool):
    """Parents of every level and the pooling groups between levels.  The
    decoder's levels carry the displacement pseudo-joint on all but the
    last pooling."""
    levels, groups = [list(parents)], []
    for l in range(POOL_LEVELS):
        g, p = pool_once(levels[-1], decoder and l != POOL_LEVELS - 1)
        groups.append(g)
        levels.append(p)
    return levels, groups


def conv_mask(hoods, c_in: int, c_out: int) -> np.ndarray:
    m = np.zeros((len(hoods) * c_out, len(hoods) * c_in))
    for i, hood in enumerate(hoods):
        for k in hood:
            m[i * c_out:(i + 1) * c_out, k * c_in:(k + 1) * c_in] = 1.0
    return m


def pool_matrix(groups, n_old: int, c: int) -> np.ndarray:
    m = np.zeros((len(groups) * c, n_old * c))
    for i, g in enumerate(groups):
        for j in g:
            m[i * c + np.arange(c), j * c + np.arange(c)] = 1.0 / len(g)
    return m


def unpool_matrix(groups, c: int) -> np.ndarray:
    n_out = len({j for g in groups for j in g}) + 1
    m = np.zeros((n_out * c, len(groups) * c))
    for i, g in enumerate(groups):
        for j in g:
            m[j * c + np.arange(c), i * c + np.arange(c)] += 1.0
    return m


# ---------------------------------------------------------------------------
# Quaternions and forward kinematics
# ---------------------------------------------------------------------------

def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack((aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw), dim=-1)


def qconj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qinv(q):
    return qconj(q) / (q * q).sum(-1, keepdim=True)


def qrotate(q, v):
    """Rotate vectors ``v`` by unit quaternions ``q``."""
    qv = q[..., 1:].expand(v.shape)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + q[..., :1] * t + torch.linalg.cross(qv, t, dim=-1)


def qmatrix(q):
    """Rotation matrix (acting on column vectors) of unit quaternions."""
    w, x, y, z = q.unbind(-1)
    return torch.stack((
        torch.stack((1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)), -1),
        torch.stack((2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)), -1),
        torch.stack((2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)), -1)), -2)


@dataclass
class Skeleton:
    parents: np.ndarray     # (J,), parents[0] == 0
    offsets: torch.Tensor   # (J, 3) on the device, offsets[0] == 0

    def __post_init__(self):
        n, dev = len(self.parents), self.offsets.device
        parent_of = np.eye(n)[self.parents]
        chain = np.zeros((n, n))     # chain[j, a]: a on the path root → j
        for j in range(1, n):
            a = j
            while a != 0:
                chain[j, a] = 1.0
                a = int(self.parents[a])
        self.parent_of = torch.as_tensor(parent_of, dtype=torch.float32,
                                         device=dev)
        self.chain = torch.as_tensor(chain, dtype=torch.float32, device=dev)

    @property
    def n_joints(self) -> int:
        return len(self.parents)


def fk(skeleton: Skeleton, rootspace, root_pos):
    """Root-space pose (..., J, 4) whose slot 0 is the root's world rotation,
    root position (..., 3) → (positions (..., J, 3), world rotations).  A
    joint's position is the root's plus, over the bones on its chain, each
    bone's offset turned by its parent's world rotation."""
    root = rootspace[..., :1, :]
    world = torch.cat((root, qmul(root, rootspace[..., 1:, :])), dim=-2)
    bones = qrotate(skeleton.parent_of @ world,
                    skeleton.offsets.expand(world.shape[:-1] + (3,)))
    return root_pos[..., None, :] + skeleton.chain @ bones, world


def to_local(skeleton: Skeleton, rootspace):
    """Root-space → parent-local rotations (the root and its children keep
    theirs)."""
    local = qmul(qinv(skeleton.parent_of @ rootspace), rootspace)
    keep = torch.as_tensor(skeleton.parents == 0,
                           device=rootspace.device)[:, None]
    return torch.where(keep, rootspace, local)


# ---------------------------------------------------------------------------
# The pose VAE
# ---------------------------------------------------------------------------

def leaky(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


class Vae:
    """The encoder (for a window of one frame) and the decoder folded into
    three dense layers, both from ``generator.npz``, in float32 on
    ``device``.  The folding is done in float64."""

    def __init__(self, npz: Dict[str, np.ndarray], parents, radius: int,
                 device):
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                        dtype=torch.float32, device=device)
        enc_levels, enc_groups = pool_levels(parents, decoder=False)
        dec_levels, dec_groups = pool_levels(parents, decoder=True)
        self.enc = []
        for l in range(POOL_LEVELS):
            hoods = neighbourhoods(enc_levels[l], radius, False)
            w = npz[f"params/encoder/convs/{l}/w"][:, :, 0]
            mask = conv_mask(hoods, ENC_CHANNELS, ENC_CHANNELS)
            pool = pool_matrix(enc_groups[l], len(enc_levels[l]),
                               ENC_CHANNELS)
            self.enc.append((f32(w * mask), f32(npz[
                f"params/encoder/convs/{l}/b"]), f32(pool)))
        self.mu = (f32(npz["params/encoder/f_mu/w"]),
                   f32(npz["params/encoder/f_mu/b"]))
        self.logvar = (f32(npz["params/encoder/f_logvar/w"]),
                       f32(npz["params/encoder/f_logvar/b"]))
        w = np.asarray(npz["params/decoder/f_latent/w"], np.float64)
        b = np.asarray(npz["params/decoder/f_latent/b"], np.float64)
        self.dec = []
        for l in range(POOL_LEVELS):
            level = POOL_LEVELS - 1 - l
            hoods = neighbourhoods(dec_levels[level], radius, True)
            conv = (npz[f"params/decoder/convs/{l}/w"][:, :, 0]
                    * conv_mask(hoods, DEC_CHANNELS, DEC_CHANNELS))
            layer = conv @ unpool_matrix(dec_groups[level], DEC_CHANNELS)
            bias = np.asarray(npz[f"params/decoder/convs/{l}/b"], np.float64)
            if l == 0:
                w, b = layer @ w, layer @ b + bias
            else:
                w, b = layer, bias
            self.dec.append((f32(w), f32(b)))
        mean = np.asarray(npz["extra/means/dqs"]).reshape(-1, 8)
        std = np.asarray(npz["extra/stds/dqs"]).reshape(-1, 8)
        self.mean_dqs = f32(npz["extra/means/dqs"])
        self.std_dqs = f32(npz["extra/stds/dqs"])
        self.mean_q = f32(mean[:, :4].reshape(-1))
        self.std_q = f32(std[:, :4].reshape(-1))
        self.mean_disp = f32(npz["extra/means/displacement"])
        self.std_disp = f32(npz["extra/stds/displacement"])

    def encode(self, dqs_norm):
        """Normalized dual quaternions (B, J*8) of one frame → (mu, logvar)."""
        h = dqs_norm
        for w, b, pool in self.enc:
            h = leaky((h @ w.T + b) @ pool.T)
        return h @ self.mu[0].T + self.mu[1], h @ self.logvar[0].T \
            + self.logvar[1]

    def decode(self, z):
        """Latents (..., L) → (normalized pose (..., J*4) whose quaternions
        are unit once de-normalized, normalized root displacement (..., 3))."""
        h = z
        for l, (w, b) in enumerate(self.dec):
            h = h @ w.T + b
            if l < POOL_LEVELS - 1:
                h = leaky(h)
        q = (h[..., :-DEC_CHANNELS] * self.std_q + self.mean_q)
        q = q.unflatten(-1, (-1, 4))
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        pose_n = (q.flatten(-2) - self.mean_q) / self.std_q
        return pose_n, h[..., -DEC_CHANNELS:-1]

    def quats(self, pose_n):
        """Normalized pose (..., J*4) → quaternions (..., J, 4)."""
        return (pose_n * self.std_q + self.mean_q).unflatten(-1, (-1, 4))


# ---------------------------------------------------------------------------
# The temporal transformer (post-norm, as torch.nn.Transformer; eval mode)
# ---------------------------------------------------------------------------

def positional_encoding(rows: int, dim: int) -> np.ndarray:
    pos = np.arange(rows, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((rows, dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class Transformer:
    def __init__(self, npz: Dict[str, np.ndarray], heads: int, pe_rows: int,
                 device):
        self.p = {k[len("params/"):]: torch.as_tensor(
            v, dtype=torch.float32, device=device)
            for k, v in npz.items() if k.startswith("params/")}
        self.mean = torch.as_tensor(npz["extra/means_latent"],
                                    dtype=torch.float32, device=device)
        self.std = torch.as_tensor(npz["extra/stds_latent"],
                                   dtype=torch.float32, device=device)
        self.heads = heads
        self.d = self.p["in_proj_enc/b"].shape[0]
        self.pe = torch.as_tensor(positional_encoding(pe_rows, self.d),
                                  dtype=torch.float32, device=device)
        self.n_enc = sum(1 for k in self.p if k.endswith("ln1/g")
                         and k.startswith("enc_layers"))
        self.n_dec = sum(1 for k in self.p if k.endswith("ln1/g")
                         and k.startswith("dec_layers"))

    def _lin(self, x, name):
        return x @ self.p[name + "/w"].T + self.p[name + "/b"]

    def _norm(self, x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.p[name + "/g"] \
            + self.p[name + "/b"]

    def _attend(self, x, kv, name, mask=None):
        d, h = self.d, self.heads
        wq, wk, wv = self.p[name + "/in_w"].split(d)
        bq, bk, bv = self.p[name + "/in_b"].split(d)
        split = lambda t: t.unflatten(-1, (h, d // h)).transpose(-3, -2)  # noqa: E731
        q, k, v = split(x @ wq.T + bq), split(kv @ wk.T + bk), \
            split(kv @ wv.T + bv)
        s = q @ k.transpose(-1, -2) / math.sqrt(d // h)
        if mask is not None:
            s = s + mask
        o = (torch.softmax(s, dim=-1) @ v).transpose(-3, -2).flatten(-2)
        return o @ self.p[name + "/out_w"].T + self.p[name + "/out_b"]

    def _ff(self, x, name):
        return self._lin(torch.relu(self._lin(x, name + "/ff1")),
                         name + "/ff2")

    def __call__(self, enc_in, dec_in, mask):
        """enc_in (B, S_enc, 33), dec_in (B, S_dec, L), additive mask
        (S_dec | 1, S_dec) → (B, S_dec, L)."""
        src = self._lin(enc_in, "in_proj_enc") + self.pe[:enc_in.shape[1]]
        tgt = self._lin(dec_in, "in_proj_dec") + self.pe[:dec_in.shape[1]]
        for i in range(self.n_enc):
            n = f"enc_layers/{i}"
            src = self._norm(src + self._attend(src, src, n + "/self_attn"),
                             n + "/ln1")
            src = self._norm(src + self._ff(src, n), n + "/ln2")
        memory = self._norm(src, "enc_norm")
        for i in range(self.n_dec):
            n = f"dec_layers/{i}"
            tgt = self._norm(tgt + self._attend(tgt, tgt, n + "/self_attn",
                                                mask), n + "/ln1")
            tgt = self._norm(tgt + self._attend(tgt, memory,
                                                n + "/cross_attn"),
                             n + "/ln2")
            tgt = self._norm(tgt + self._ff(tgt, n), n + "/ln3")
        return self._lin(self._norm(tgt, "dec_norm"), "out_proj")
