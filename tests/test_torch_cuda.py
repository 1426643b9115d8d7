"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (and so counts no pass) where
``torch.cuda.is_available()`` is false — decided inside the fixture, never
at import.  On a GPU machine run them with::

    python -m pytest tests/test_torch_cuda.py -q

They repeat, at small sizes, what ``chip_smoke.py`` checks at the main
path's sizes, with its tolerances (``chip_smoke.K1_TOL`` / ``K2_TOL``).
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


@pytest.mark.parametrize("sync_k,per_lane", [(1, False), (8, False),
                                             (8, True)])
def test_k1_kernel_matches_plain(engines, sync_k, per_lane):
    r = chip_smoke.check_k1(engines[0], 257, sync_k, per_lane=per_lane,
                            timed=False)
    assert r["ok"] and r["t_mismatch"] == 0, r


@pytest.mark.parametrize("s_dec,kind", [(1, "row"), (5, "row"),
                                        (5, "square")])
def test_k2_kernel_matches_plain(engines, s_dec, kind):
    r = chip_smoke.check_k2(engines[0], 37, s_dec, kind, timed=False,
                            library=True)
    assert r["ok"], r
    assert r["library_err"] < 1e-3, r


def test_main_path_card_matches_cpu(engines):
    gpu, cpu, bvh, means, stds = engines
    r = chip_smoke.check_against_cpu(gpu, cpu, bvh, means, stds)
    assert r["lockstep_ok"] and r["stop_rule_ok"], r


def test_k2_rejects_bad_input(engines):
    from dragposer_tpu_torch.ops import temporal_fused

    packed = engines[0].model.temporal
    enc = torch.zeros(2, 14, 33, device="cuda", dtype=torch.float64)
    dec = torch.zeros(2, 1, 24, device="cuda")
    mask = torch.zeros(1, 1, device="cuda")
    with pytest.raises(ValueError):
        temporal_fused.forward(packed, None, enc, dec, mask)
