"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (and so counts no pass) where
``torch.cuda.is_available()`` is false — decided inside the fixture, never
at import.  On a GPU machine run them with::

    python -m pytest tests/test_torch_cuda.py -q

They repeat, at small sizes, what ``chip_smoke.py`` checks at the main
paths' sizes, with its tolerances (``chip_smoke.K1_TOL`` ... ``K4_TOL``):
K1 (carry and aux, its TF32 control, lanes that take no step, no plain
code), K2, K3a/K3b (rows) and K3c/K3d (lanes) with the forward's and the
backward's TF32 controls, the backward's ReLU gates against the forward's
and both kernels' tensor-core instructions, K4a/K4b, and one training step of each layout on the card
against the CPU; phase [15]'s anchor checks: ``engine.run`` on the
card against the CPU (K2 alone) and ``run_batch`` against the pipelined
path (K1 + K2); K2 at the realtime rollouts' lengths (16 and 30 decoder
steps) and phases [16]-[17] at small sizes: a ``RealtimeSession`` and a
``RealtimeBatch`` frame on the card against the CPU; K1's general build
on chain and latent-48 models (up to its limits: 128 joints, latent 128),
its two layouts equal bit for bit, and its refusal past them, and phases
[19]-[21] at small sizes.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels have no CPU mode)")
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = chip_smoke.load_clip(40, chip_smoke.SEED)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    sk = Skeleton.build(parents, offsets, bvh.names)
    gpu, means, stds = build_engine(chip_smoke.MODEL_DIR, parents,
                                    resolve_config("6_trackers"),
                                    skeleton=sk)
    cpu, _, _ = build_engine(chip_smoke.MODEL_DIR, parents,
                             resolve_config("6_trackers"), skeleton=sk,
                             device="cpu")
    return gpu, cpu, bvh, means, stds


# K1 tiles 16 lanes, 4 warps a tile: B = 1, 15 and 17 leave a lone or
# ragged tile, 37 several tiles and a ragged one, 4096 many blocks of
# several tiles.
@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("sync_k", [1, 24])
@pytest.mark.parametrize("B", [1, 15, 17, 37, 4096])
def test_k1_kernel_matches_plain(engines, B, sync_k, per_lane):
    r = chip_smoke.check_k1(engines[0], B, sync_k, per_lane=per_lane,
                            timed=False)
    assert r["ok"] and r["t_mismatch"] <= B // 1000, r


def test_k1_tolerance_refuses_tf32_control(engines):
    r = chip_smoke.check_k1(engines[0], 512, 1, timed=False, control=True)
    assert r["tf32_control_refused"] and r["ok"], r


def test_k1_lanes_without_steps_keep_their_inputs(engines):
    """Inactive lanes and lanes whose stop rule already holds take no step:
    their carry comes back bit for bit, their aux is the forward at their
    decoded latent."""
    from dragposer_tpu_torch.drag import fast_iter, iter_kernel

    engine = engines[0]
    B = 53
    ctx, kctx, opt, active, state, tposT, trotT, tlat = \
        chip_smoke.k1_inputs(engine, B)
    dev = opt.latent.device
    done = torch.arange(B, device=dev) % 7 == 2
    dec0 = opt.latent + 0.05 * torch.randn(opt.latent.shape, device=dev,
                                           generator=torch.Generator(
                                               device=dev).manual_seed(3))
    opt = opt._replace(
        decoded_latent=dec0.contiguous(),
        loss_pos=torch.where(done, 0.0, opt.loss_pos).contiguous(),
        loss_rot=torch.where(done, 0.0, opt.loss_rot).contiguous())
    still = done | ~active
    got = iter_kernel.run_block_fused(ctx, kctx, engine.hyper, 5, opt,
                                      active, state, tposT, trotT, tlat)
    assert int((got.t - opt.t)[~still].min()) >= 1
    for name in chip_smoke.K1_OPT + ("t",):
        assert torch.equal(getattr(got, name)[still],
                           getattr(opt, name)[still]), name
    ref = fast_iter.aux_at(ctx, engine.hyper, dec0.T, state.global_rot.T,
                           tposT, trotT, tlat.T)
    pose_std = kctx.sq.T.reshape(-1)   # as chip_smoke.k1_agreement
    for name in chip_smoke.K1_AUX:
        a, b = getattr(got.aux, name)[still], getattr(ref, name)[still]
        if name == "pose":
            a, b = a * pose_std, b * pose_std
        assert bool(((a - b).abs() <= chip_smoke.K1_TOL["atol_per_step"]
                     + chip_smoke.K1_TOL["rtol"] * b.abs()).all()), name


def test_k1_runs_no_plain_code(engines):
    from dragposer_tpu_torch.drag import fast_iter, iter_kernel

    engine = engines[0]
    args = chip_smoke.k1_inputs(engine, 64)
    fast_iter.COUNTS.reset()
    iter_kernel.run_block_fused(args[0], args[1], engine.hyper, 4, *args[2:])
    torch.cuda.synchronize()
    assert (fast_iter.COUNTS.kernel, fast_iter.COUNTS.plain,
            fast_iter.COUNTS.aux) == (1, 0, 0)


@pytest.mark.parametrize("s_dec,kind", [(1, "row"), (5, "row"),
                                        (5, "square")])
def test_k2_kernel_matches_plain(engines, s_dec, kind):
    r = chip_smoke.check_k2(engines[0], 37, s_dec, kind, timed=False,
                            library=True)
    assert r["ok"], r
    assert r["library_err"] < 1e-3, r


# K2's lane grouping: G = lanes_per_block(S_enc, S_dec) lanes per block
# (9 at S = 14, 8 at 16), so B = 1, G - 1 and G + 1 leave a ragged or lone
# block; 37 is several blocks and a ragged one.
@pytest.mark.parametrize("b", ["1", "G-1", "G+1", "37"])
@pytest.mark.parametrize("s_dec,kind", [(1, "row"), (5, "square"),
                                        (16, "row")])
def test_k2_lane_grouping_matches_plain(engines, b, s_dec, kind):
    from dragposer_tpu_torch.ops import temporal_fused

    G = temporal_fused.lanes_per_block(14, s_dec)
    B = {"1": 1, "G-1": G - 1, "G+1": G + 1, "37": 37}[b]
    r = chip_smoke.check_k2(engines[0], B, s_dec, kind, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("s_dec,kind", [(1, "row"), (16, "square")])
def test_k2_longest_encoder_matches_plain(engines, s_dec, kind):
    r = chip_smoke.check_k2(engines[0], 37, s_dec, kind, timed=False,
                            s_enc=16)
    assert r["ok"], r


def test_k2_lanes_per_block_matches_kernel(engines):
    from dragposer_tpu_torch.ops import temporal_fused

    lib = temporal_fused._library()
    for s_enc in range(1, 17):
        for s_dec in range(1, 17):
            assert lib.temporal_forward_lanes_per_block(s_enc, s_dec) == \
                temporal_fused.lanes_per_block(s_enc, s_dec)


def test_k2_tolerance_refuses_tf32_control(engines):
    r = chip_smoke.check_k2(engines[0], 512, 5, "row", timed=False,
                            control=True)
    assert r["tf32_control_refused"] and r["ok"], r


def test_main_path_card_matches_cpu(engines):
    gpu, cpu, bvh, means, stds = engines
    r = chip_smoke.check_against_cpu(gpu, cpu, bvh, means, stds)
    assert r["lockstep_ok"] and r["stop_rule_ok"], r


def test_windowed_path_card_matches_cpu(engines):
    """4 trackers (window 16): K2 rolls out the sub-batch of lanes at a
    window boundary, card against CPU at one Adam step a frame."""
    r = chip_smoke.check_windowed_against_cpu("4_trackers", engines[2])
    assert r["ok"], r


def test_k2_rejects_bad_input(engines):
    from dragposer_tpu_torch.ops import temporal_fused

    packed = engines[0].model.temporal
    enc = torch.zeros(2, 14, 33, device="cuda", dtype=torch.float64)
    dec = torch.zeros(2, 1, 24, device="cuda")
    mask = torch.zeros(1, 1, device="cuda")
    with pytest.raises(ValueError):
        temporal_fused.forward(packed, None, enc, dec, mask)


@pytest.mark.parametrize("s,b,rate", [(3, 130, 0.1), (2, 300, 0.1),
                                      (2, 300, 0.0), (1, 17, 0.1)])
def test_k3_kernels_match_plain(engines, s, b, rate):
    r = chip_smoke.check_k3(s, b, rate, timed=False)
    assert r["ok"], r


# M = s·b rows: 390 and 600 span ragged 256-row TPU tiles and 64-row CUDA
# tiles; 17 is one partial tile; 7,680 splits the hidden over a cluster
@pytest.mark.parametrize("s,b,rate", [(3, 130, 0.1), (2, 300, 0.1),
                                      (2, 300, 0.0), (1, 17, 0.1),
                                      (15, 512, 0.1)])
def test_k3_rows_kernels_match_plain(engines, s, b, rate):
    r = chip_smoke.check_k3(s, b, rate, timed=False, layout="rows")
    assert r["ok"], r


@pytest.mark.parametrize("layout", ["lanes", "rows"])
@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_k3_backward_gate_is_the_forwards(engines, layout, rate):
    r = chip_smoke.k3_gate_probe(layout, rate, n=8)
    assert r["ok"] and r["gates_open"] > 0, r


@pytest.mark.parametrize("name", ["ff_rows", "ff_lanes"])
def test_k3_backward_runs_on_the_tensor_cores(engines, name):
    """Both FF kernels of each library, the forward and the backward, hold
    tensor-core instructions."""
    assert chip_smoke.sass_mma_count(name, "ff_bwd_kernel") > 0
    assert chip_smoke.sass_mma_count(name, "ff_fwd_kernel") > 0


# K4 blocks take 8 lanes: B = 37 and 130 leave a ragged group and move
# single floats, 36 a half group of 16-byte loads, 1 one lane; the masks
# are the trainer's (none, causal), a scattered non-causal one and a fully
# masked query row, whose outputs must be NaN where the twin's are
@pytest.mark.parametrize("sq,sk,b,mask", [(14, 14, 37, "zero"),
                                          (15, 14, 130, "zero"),
                                          (15, 15, 64, "causal"),
                                          (1, 15, 8, "zero"),
                                          (15, 15, 64, "dead_row"),
                                          (15, 15, 36, "scattered"),
                                          (15, 14, 130, "scattered"),
                                          (15, 15, 1, "causal"),
                                          (1, 15, 37, "causal"),
                                          (15, 15, 4096, "causal")])
def test_k4_kernels_match_plain(engines, sq, sk, b, mask):
    library = sq > 1 and mask != "dead_row"
    r = chip_smoke.check_k4(sq, sk, b, mask, timed=False, library=library)
    assert r["ok"], r
    if library:
        assert r["library_err"] < 1e-4, r


def test_k4_timed_build_reports_every_phase(engines):
    from dragposer_tpu_torch.ops import attn_fused

    q, k, v, g = (torch.randn(15, 4, 12, 64, device="cuda") for _ in range(4))
    mask = chip_smoke.k4_mask("causal", 15, 15).cuda()
    before = (attn_fused.COUNTS_FWD.kernel, attn_fused.COUNTS_BWD.kernel)
    r = attn_fused.phase_cycles(q, k, v, mask, g)
    assert list(r["forward"]) == list(attn_fused.FWD_PHASES), r
    assert list(r["backward"]) == list(attn_fused.BWD_PHASES), r
    for phases in r.values():
        for ph in ("stage", "compute", "phase1"):
            if ph in phases:
                assert 0 < phases[ph]["mean"] <= phases[ph]["max"], r
    assert (attn_fused.COUNTS_FWD.kernel,
            attn_fused.COUNTS_BWD.kernel) == before


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_training_step_card_matches_cpu(engines, tmp_path, rate):
    data = tmp_path / "data" / "train"
    data.mkdir(parents=True)
    chip_smoke.write_synthetic_clips(str(data), (300, 300), 3)
    r = chip_smoke.train_step_card_vs_cpu(str(tmp_path / "data"), rate, B=8)
    assert r["ok"], r


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_rows_training_step_card_matches_cpu(engines, tmp_path, rate):
    data = tmp_path / "data" / "train"
    data.mkdir(parents=True)
    chip_smoke.write_synthetic_clips(str(data), (300, 300), 3)
    r = chip_smoke.train_step_card_vs_cpu(str(tmp_path / "data"), rate, B=8,
                                          layout="rows")
    assert r["ok"], r


def test_k3_k4_reject_bad_input(engines):
    from dragposer_tpu_torch.ops import attn_fused, ff_fused

    x = torch.zeros(2, 48, 8, device="cuda")
    w1 = torch.zeros(2048, 48, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError):
        ff_fused.ff_dropout_lanes(x, {"w": w1, "b": torch.zeros(2048)},
                                  {"w": torch.zeros(48, 2048), "b":
                                   torch.zeros(48)}, 0.1, 1)
    with pytest.raises(ValueError):
        ff_fused.ff_dropout_seeded(torch.zeros(8, 40, device="cuda"),
                                   {"w": torch.zeros(2048, 48, device="cuda"),
                                    "b": torch.zeros(2048, device="cuda")},
                                   {"w": torch.zeros(48, 2048, device="cuda"),
                                    "b": torch.zeros(48, device="cuda")},
                                   0.1, 1)
    q = torch.zeros(3, 4, 12, 8, device="cuda")
    with pytest.raises(ValueError):
        attn_fused.attn_core_lanes(q, q.cpu(), q)


@pytest.mark.parametrize("config", ["6_trackers", "4_trackers"])
def test_anchor_card_matches_cpu(engines, config):
    r = chip_smoke.anchor_card_vs_cpu(config, engines[2], T=20)
    assert r["ok"], r


def test_anchor_matches_pipelined_path(engines):
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    gpu, _, _, means, stds = engines
    bvh = chip_smoke.load_clip(chip_smoke.T_MAIN, chip_smoke.SEED)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    r = chip_smoke.anchor_vs_pipeline(
        gpu, bvh, means, stds, Skeleton.build(parents, offsets, bvh.names))
    assert r["ok"], r


# K2 at the realtime rollouts' lengths: 16 decoder steps (window 60) in the
# 16-step build, 30 (window 119, the positional encoding's rows) in the
# 32-step build; B = 37 leaves a ragged block at G = 8 and at G = 4.
@pytest.mark.parametrize("s_dec,kind", [(16, "row"), (30, "row"),
                                        (30, "square")])
def test_k2_long_rollouts_match_plain(engines, s_dec, kind):
    r = chip_smoke.check_k2(engines[0], 37, s_dec, kind, timed=False)
    assert r["ok"], r


def test_k2_builds_cover_the_positional_encoding(engines):
    from dragposer_tpu_torch.ops import temporal_fused

    lib = temporal_fused._library()
    assert lib.temporal_forward_max_sequence() == temporal_fused.SMAX
    assert temporal_fused.max_sequence(engines[0].model.temporal) == 30
    for s in range(1, 31):
        assert lib.temporal_forward_lanes_per_block(14, s) == \
            temporal_fused.lanes_per_block(14, s)


def test_realtime_session_card_matches_cpu(engines):
    r = chip_smoke.realtime_session_phase(
        chip_smoke.clip_path(chip_smoke.SEED), engines[2], frames=4)
    assert r["ok"], r


def test_realtime_batch_frame_card_matches_cpu(engines):
    r = chip_smoke.realtime_batch_phase(
        chip_smoke.clip_path(chip_smoke.SEED), engines[2], n=16, frames=4)
    assert r["ok"], r


# K1's general build (models past the narrow build's J ≤ 32, L ≤ 32,
# hidden ≤ 64): small batches of the chain and latent-48 models, with the
# general build's first-step knife lanes (chip_smoke.k1_agreement).
@pytest.mark.parametrize("n_joints,latent", [(33, 24), (64, 24), (22, 48),
                                             (128, 128)])
@pytest.mark.parametrize("B", [17, 1000])
def test_k1_general_build_matches_plain(engines, n_joints, latent, B):
    from dragposer_tpu_torch.drag import iter_kernel

    engine = chip_smoke.wide_engine(n_joints, latent)[0]
    knife = chip_smoke.k1_knife_lanes(engine, B)
    before = iter_kernel.GENERAL_COUNTS.kernel
    for sync_k in (1, 24):
        r = chip_smoke.check_k1(engine, B, sync_k, timed=False,
                                control=sync_k == 1 and B == 1000,
                                knife=knife)
        assert r["build"] == "general" and r["ok"], r
        assert r.get("tf32_control_refused", True), r
    assert iter_kernel.GENERAL_COUNTS.kernel > before


def test_k1_general_build_refuses_past_its_limits(engines):
    engine = chip_smoke.wide_engine(130, 24)[0]
    args = chip_smoke.k1_inputs(engine, 4)
    from dragposer_tpu_torch.drag import iter_kernel

    with pytest.raises(ValueError, match="general build"):
        iter_kernel.run_block_fused(args[0], args[1], engine.hyper, 1,
                                    *args[2:])


@pytest.mark.parametrize("n_joints,latent", [(33, 24), (22, 48)])
def test_k1_general_layouts_agree_bit_for_bit(engines, n_joints, latent):
    """The general build's layouts (weights resident in shared memory, or
    streamed from device memory in each register class) form the same
    sums: their carries and aux are equal bit for bit."""
    from dragposer_tpu_torch.drag import iter_kernel

    engine = chip_smoke.wide_engine(n_joints, latent)[0]
    args = chip_smoke.k1_inputs(engine, 1000)
    outs = {}
    for name in iter_kernel.LAYOUTS:
        with chip_smoke.k1_layout(name):
            assert iter_kernel.launch_build(args[1], args[2]) == name
            outs[name] = iter_kernel.run_block_fused(
                args[0], args[1], engine.hyper, 24, *args[2:])
    a = outs["resident"]
    for b in outs.values():
        for n in chip_smoke.K1_OPT:
            assert torch.equal(getattr(a, n), getattr(b, n)), n
        for n in chip_smoke.K1_AUX:
            assert torch.equal(getattr(a.aux, n), getattr(b.aux, n)), n


def test_chain_path_card_matches_cpu(engines):
    """Phase [19]'s chain path at a small size: the pipelined path on the
    33-joint chain on the general build, and the card against the CPU at
    one step a frame."""
    r = chip_smoke.chain_path(B=64, T=24)
    assert r["ok"], r


def test_wide_path_card_matches_cpu(engines):
    """Phase [19] at a small size: the pipelined path at latent 48 on the
    general build, and the card against the CPU at one step a frame."""
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = engines[2]
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    r = chip_smoke.wide_path(bvh, parents, Skeleton.build(
        parents, offsets, bvh.names), B=64, T=24)
    assert r["ok"], r


def test_eval_mesh_one_is_the_plain_run(engines, tmp_path):
    r = chip_smoke.mesh_cli_runs(str(tmp_path))
    assert r["ok"], r


def test_pt_model_dir_runs_on_the_card(engines, tmp_path):
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = engines[2]
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    r = chip_smoke.pt_round_trip(bvh, parents, Skeleton.build(
        parents, offsets, bvh.names), work_dir=str(tmp_path))
    assert r["ok"], r
