"""How far a float32-sized change in K2's output moves the main path's
latents, on the CPU (plain twins): the margin under the lockstep tolerance
of ``chip_smoke.check_against_cpu`` (latent atol 1e-4).

K2's outputs are multiplied by (1 + s·N(0, 1)) call by call, a stand-in
for another float32 evaluation order (the kernel's 3xTF32 products,
cuBLAS).  With one Adam step a frame, the check's lockstep, the latents
move by a small share of the tolerance.  With five, the second and later
steps divide small, cancelling gradients by their running scale, and a
1e-7 change moves the latents by a large share of it within 24 frames.

K2's products in one TF32 pass (its plain twin with ``matmul_tf32``) move
the latents past the one-step tolerance, and at five steps by a hundred
times what 3xTF32 (``matmul_3xtf32``) moves them: both lockstep gates
refuse a single-pass TF32 kernel.
"""

import contextlib

import pytest
import torch

import chip_smoke

B, T = 8, 24


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.ops.topology import Skeleton

    path = str(tmp_path_factory.mktemp("lockstep") / "clip.bvh")
    chip_smoke.synthetic_bvh(T, chip_smoke.SEED).save(path)
    bvh = BVH().load(path)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    sk = Skeleton.build(parents, offsets, bvh.names)
    engine, means, stds = build_engine(chip_smoke.MODEL_DIR, parents,
                                       resolve_config("6_trackers"),
                                       skeleton=sk, device="cpu")
    return engine, chip_smoke.lane_batch(engine, bvh, means, stds, B, T)


@contextlib.contextmanager
def _k2_scaled(scale, seed):
    from dragposer_tpu_torch.ops import temporal_fused

    forward = temporal_fused.forward
    gen = torch.Generator().manual_seed(seed)

    def scaled(*args):
        y = forward(*args)
        return y * (1 + scale * torch.randn(y.shape, generator=gen))

    temporal_fused.forward = scaled
    try:
        yield
    finally:
        temporal_fused.forward = forward


def _latents(lanes, max_iter, scale=0.0, seed=0, mm=None):
    engine, args = lanes
    saved = engine.hyper
    engine.hyper = saved._replace(**dict(chip_smoke.KNIFE_FREE,
                                         max_iter=max_iter))
    k2 = (_k2_scaled(scale, seed) if mm is None
          else chip_smoke.k2_plain(mm))
    try:
        with k2:
            _, out = engine.run_batch_pipelined(*args,
                                                sync_k=chip_smoke.SYNC_K)
    finally:
        engine.hyper = saved
    return out.latent


def _moved(lanes, max_iter, scale):
    base = _latents(lanes, max_iter)
    return max(float((_latents(lanes, max_iter, scale, seed) - base).abs()
                     .max()) for seed in (0, 1))


@pytest.mark.parametrize("scale", [1e-7, 1e-5])
def test_one_step_lockstep_has_margin(lanes, scale):
    """One step a frame: a 1e-7 or 1e-5 relative change in K2's output
    moves the latents by under a tenth of the tolerance."""
    assert _moved(lanes, 1, scale) < 1e-5


def test_five_steps_lockstep_is_rounding_bound(lanes):
    """Five steps a frame: a 1e-7 relative change alone moves the latents
    by over a tenth of the tolerance."""
    assert _moved(lanes, 5, 1e-7) > 1e-5


def _moved_by(lanes, max_iter, mm):
    return float((_latents(lanes, max_iter, mm=mm)
                  - _latents(lanes, max_iter)).abs().max())


def test_one_step_lockstep_refuses_tf32(lanes):
    """One step a frame: 3xTF32 products in K2 move the latents by under a
    tenth of the tolerance, a single TF32 pass by more than all of it."""
    from dragposer_tpu_torch.ops import temporal_fused

    assert _moved_by(lanes, 1, temporal_fused.matmul_3xtf32) < 1e-5
    assert _moved_by(lanes, 1, temporal_fused.matmul_tf32) > 1e-4


def test_five_steps_tf32_far_past_rounding(lanes):
    """Five steps a frame: a single TF32 pass in K2 moves the latents by
    over a hundred times what 3xTF32 products move them."""
    from dragposer_tpu_torch.ops import temporal_fused

    assert _moved_by(lanes, 5, temporal_fused.matmul_tf32) > 100 * \
        _moved_by(lanes, 5, temporal_fused.matmul_3xtf32)
