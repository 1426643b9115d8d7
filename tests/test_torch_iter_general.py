"""K1's general build on the host (``csrc/iter_block.cu``, ``Resident``,
``Streamed4``, ``Streamed2`` and ``Streamed1``): the whole-weight packing
its products read and split in registers, and the layout the wrapper
picks for a batch.

A CUDA kernel cannot run here, so the kernel's reads of a whole-weight
block (``load_w``: a float2 forward, two floats transposed, at
``pair_position``) are emulated lane by lane and split as the kernel
splits them (``split``: hi = TF32 round, lo = TF32 round of the rest);
they must give the narrow build's split fragments bit for bit, so the
general build's products are the sums its earlier design formed.  The
layout's shared-memory sizes are held to the sizes the general build's
earlier single layout (a team a block, weights in device memory) launched
with on the card (the profiler's trace, one H100, B = 8192).
"""

import pytest
import torch

import chip_smoke

LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4
H100 = (132, 232448, 233472)   # SMs, shared memory a block, an SM
# [3]'s shapes (J, L, H1, H2) and the limit shape
SHAPES = {"example_latent48": (22, 48, 40, 60),
          "chain33_latent24": (33, 24, 40, 72),
          "chain64_latent24": (64, 24, 72, 136),
          "chain128_latent128": (128, 128, 136, 264)}


def _weights(O, I, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((O, I), generator=g) * 0.3


def _split(x):
    from dragposer_tpu_torch.ops.temporal_fused import split_tf32

    return split_tf32(x)


def _load_w(P, k, n, transposed):
    """The kernel's ``load_w`` on a ``pack_weights`` block: forward, the
    float2 at the lane's pair of block (n, k); transposed, W[8k + 2t][8n +
    g] and W[8k + 2t + 1][8n + g] of block (k, n).  → (32, 2)."""
    from dragposer_tpu_torch.drag.iter_kernel import pair_position

    if not transposed:
        return P[n, k, pair_position(LANE)]
    blk = P[k, n]
    e = G & 1
    return torch.stack([blk[pair_position(8 * T + (G >> 1)), e],
                        blk[pair_position(8 * T + 4 + (G >> 1)), e]], -1)


def _load_b(P, k, n, transposed):
    """The narrow build's ``load_b`` / ``load_bt`` on a ``pack_fragments``
    block → (hi (32, 2), lo (32, 2))."""
    from dragposer_tpu_torch.drag.iter_kernel import fragment_position

    if not transposed:
        w = P[n, k, fragment_position(LANE)]
        return w[:, [0, 2]], w[:, [1, 3]]
    e = (G & 1) * 2
    f0 = (8 * T + (G >> 1)) ^ (2 * T)
    f1 = (8 * T + 4 + (G >> 1)) ^ (2 * T)
    blk = P[k, n]
    return (torch.stack([blk[f0, e], blk[f1, e]], dim=-1),
            torch.stack([blk[f0, e + 1], blk[f1, e + 1]], dim=-1))


@pytest.mark.parametrize("shape", [(40, 24), (72, 40), (135, 72), (13, 7)])
def test_whole_weights_split_to_the_split_fragments(shape):
    """Every block read forward and transposed through ``pack_weights``
    and split in registers gives ``pack_fragments``' hi and lo bit for bit;
    unsplit it is the weight itself, zero in the padding, and hi + lo is
    the weight to 2⁻²²."""
    from dragposer_tpu_torch.drag.iter_kernel import (pack_fragments,
                                                      pack_weights)

    w = _weights(*shape)
    P, F = pack_weights(w), pack_fragments(w)
    nt, ks = P.shape[:2]
    assert P.shape == (nt, ks, 32, 2) and F.shape[:2] == (nt, ks)
    Wp = torch.zeros((8 * nt, 8 * ks))
    Wp[: shape[0], : shape[1]] = w
    for transposed in (False, True):
        for a in range(nt):
            for c in range(ks):
                k, n = (a, c) if transposed else (c, a)
                got = _load_w(P, k, n, transposed)
                rows, cols = ((8 * k + 2 * T, 8 * n + G) if transposed
                              else (8 * n + G, 8 * k + 2 * T))
                step = (1, 0) if transposed else (0, 1)
                want = torch.stack([Wp[rows, cols],
                                    Wp[rows + step[0], cols + step[1]]], -1)
                assert torch.equal(got, want)
                hi, lo = _split(got)
                bh, bl = _load_b(F, k, n, transposed)
                assert torch.equal(hi, bh) and torch.equal(lo, bl)
                err = (hi.double() + lo.double() - want.double()).abs()
                assert (err <= 2.0 ** -22 * want.double().abs()).all()


def test_whole_weight_reads_are_free_of_bank_conflicts():
    """A block is 64 floats: the forward float2 reads (16 lanes a
    128-byte wavefront) and each of the two transposed float reads (32
    lanes) hit distinct banks."""
    from dragposer_tpu_torch.drag.iter_kernel import pair_position

    pos = pair_position(LANE)
    assert sorted(pos.tolist()) == list(range(32))
    for h in range(2):
        assert len(set((pos[16 * h: 16 * h + 16] % 16).tolist())) == 16
    for first in (8 * T + (G >> 1), 8 * T + 4 + (G >> 1)):
        word = 2 * pair_position(first) + (G & 1)
        assert len(set((word % 32).tolist())) == 32


@pytest.mark.parametrize("name,want", [
    ("example_latent48", ("resident", 4, 1, 227440)),
    ("chain33_latent24", ("streamed4", 1, 4, 56784)),
    ("chain64_latent24", ("streamed2", 1, 2, 99840)),
    ("chain128_latent128", ("streamed1", 1, 1, 224512))])
def test_general_layout_at_b8192(name, want):
    """[3]'s shapes and the limit shape at B = 8192 on an H100: the
    weights resident at latent 48 (four teams beside 42.5 KB of whole
    weights, one block an SM: 528 team slots for 512 tiles); streamed on
    the chains, where resident weights would leave fewer teams an SM (the
    33-joint chain: 3 against 4) or do not fit, built for the 4, 2 or 1
    blocks an SM that shared memory holds; every block within the 227 KB
    a block may opt in to."""
    from dragposer_tpu_torch.drag import iter_kernel as ik

    layout = ik.general_layout(*SHAPES[name], 8192, *H100)
    assert tuple(layout) == want
    assert layout.smem_bytes <= H100[1]
    assert (layout.smem_bytes + ik.RESERVED_SMEM) * layout.blocks_per_sm \
        <= H100[2]


@pytest.mark.parametrize("name,smem", [
    ("example_latent48", 47856), ("chain33_latent24", 56784),
    ("chain64_latent24", 99840), ("chain128_latent128", 224512)])
def test_streamed_smem_is_what_the_card_launched(name, smem):
    """The constants and one team's scratch (``smem_floats``) are the
    shared memory the general build's earlier single layout (a team a
    block, weights in device memory) launched with on the card, as its
    profiler trace recorded (``chip_smoke.k1_launch_config``): the host
    mirrors ``make_layout``."""
    from dragposer_tpu_torch.drag import iter_kernel as ik

    _, consts, team = ik.smem_floats(*SHAPES[name], 64)
    assert 4 * (-(-consts // 4) * 4 + team) == smem
    for layout in ("streamed4", "streamed2", "streamed1"):
        assert ik.general_layout(*SHAPES[name], 8192, *H100,
                                 prefer=layout).smem_bytes == smem


def test_general_layout_follows_the_batch_and_preference():
    """A batch of one or two tiles takes the resident weights with a team
    a block; ``prefer`` takes the other layout where it fits (the 33-joint
    chain resident: three teams beside 54.5 KB of weights) and the rule's
    where it does not (the 64-joint chain's 190 KB)."""
    from dragposer_tpu_torch.drag import iter_kernel as ik

    small = ik.general_layout(*SHAPES["chain64_latent24"], 17, *H100)
    assert small.name == "streamed2"   # 190 KB of weights leave no room
    small = ik.general_layout(*SHAPES["chain33_latent24"], 17, *H100)
    assert (small.name, small.teams) == ("resident", 1)
    forced = ik.general_layout(*SHAPES["chain33_latent24"], 8192, *H100,
                               prefer="resident")
    assert (forced.name, forced.teams, forced.blocks_per_sm) == (
        "resident", 3, 1)
    assert ik.general_layout(*SHAPES["chain64_latent24"], 8192, *H100,
                             prefer="resident").name == "streamed2"
    four = ik.general_layout(*SHAPES["chain64_latent24"], 8192, *H100,
                             prefer="streamed4")
    assert (four.name, four.blocks_per_sm) == ("streamed4", 2)
    half = ik.general_layout(*SHAPES["example_latent48"], 132 * 16 * 2,
                             *H100)
    assert (half.name, half.teams) == ("resident", 2)


@pytest.mark.parametrize("J,L,H", [(128, 128, 272), (128, 8, 8), (33, 128, 8),
                                   (23, 33, 272)])
def test_general_layout_fits_up_to_the_limits(J, L, H):
    """Every size up to the limits has a layout within a block's shared
    memory (the streamed layout's single team at worst)."""
    from dragposer_tpu_torch.drag import iter_kernel as ik

    layout = ik.general_layout(J, L, H, H, 8192, *H100)
    assert layout.teams >= 1 and layout.smem_bytes <= H100[1]


@pytest.mark.parametrize("n_joints,latent,whole", [(22, 24, False),
                                                   (22, 48, True),
                                                   (33, 24, True)])
def test_kernel_context_packs_for_its_build(n_joints, latent, whole):
    """``make_kernel_context`` packs the weights for the build the sizes
    take: split fragments for the narrow build, whole weights for the
    general one; ``run_block_fused`` on the CPU refuses the other
    packing."""
    from dragposer_tpu_torch.drag import iter_kernel as ik

    engine = chip_smoke.wide_engine(n_joints, latent, device="cpu")[0]
    args = chip_smoke.k1_inputs(engine, 4)
    kctx = args[1]
    pack = ik.pack_weights if whole else ik.pack_fragments
    want = torch.cat([pack(w).reshape(-1)
                      for w in (kctx.W1, kctx.W2, kctx.W3)])
    assert torch.equal(kctx.frags, want)
    other = ik.pack_fragments if whole else ik.pack_weights
    wrong = kctx._replace(frags=torch.cat(
        [other(w).reshape(-1) for w in (kctx.W1, kctx.W2, kctx.W3)]))
    with pytest.raises(ValueError, match="frags must be"):
        ik.run_block_fused(args[0], wrong, engine.hyper, 1, *args[2:])


def test_entries_name_the_layouts():
    """Each C entry of K1 by kernel: the narrow build's names unchanged,
    the general build's by layout."""
    from dragposer_tpu_torch.drag import iter_kernel as ik

    assert ik._entry("iter_block", "narrow") == "iter_block"
    assert ik._entry("iter_block_tf32", "resident") == \
        "iter_block_resident_tf32"
    assert ik._entry("iter_block_timed", "streamed2") == \
        "iter_block_streamed2_timed"
    assert set(ik.LAYOUT_COUNTS) == set(ik.LAYOUTS)
