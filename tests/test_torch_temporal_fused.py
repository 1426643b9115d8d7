"""K2's plain twin (port ``ops/temporal_fused.forward`` on the CPU) against
JAX ``models/temporal.forward`` and the interpret-mode Pallas kernel
``ops/temporal_fused.forward``, on the example checkpoint.

Tolerance rtol 1e-4, atol 1e-5, as ``tests/test_temporal_fused.py``: the
same function with softmax, LayerNorm and the 2048-wide FF sums
reassociated.  Masks: the rollout's (1, S_dec) visibility mask and a full
(S_dec, S_dec) causal mask; column 0 is always visible.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"


@pytest.fixture(scope="module")
def setup():
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import loading as jl
    from dragposer_tpu.ops import temporal_fused as jf
    from dragposer_tpu_torch.ops import temporal_fused as tf

    params, _, _ = jl.load_temporal(MODEL_DIR, jc.TEMPORAL_PARAM)
    return (params, jc.TEMPORAL_PARAM,
            jf.pack_params(params, jc.TEMPORAL_PARAM),
            tf.pack_params(params, jc.TEMPORAL_PARAM, "cpu"))


def _mask(kind, s_dec):
    if kind == "row":
        m = np.where(np.arange(s_dec) <= s_dec // 2, 0.0, -np.inf)[None]
    else:
        m = np.where(np.tri(s_dec, dtype=bool), 0.0, -np.inf)
    return m.astype(np.float32)


@pytest.mark.parametrize("b,s_dec,kind", [(1, 1, "row"), (3, 1, "row"),
                                          (5, 5, "row"), (3, 5, "square"),
                                          (1, 5, "square")])
def test_plain_twin_matches_jax(setup, b, s_dec, kind):
    from dragposer_tpu.models import temporal as jt
    from dragposer_tpu.ops import temporal_fused as jf
    from dragposer_tpu_torch.ops import temporal_fused as tf

    params, param, jpacked, tpacked = setup
    rng = np.random.default_rng(b * 10 + s_dec)
    enc = rng.normal(size=(b, 14, 33)).astype(np.float32)
    dec = rng.normal(size=(b, s_dec, 24)).astype(np.float32)
    mask = _mask(kind, s_dec)
    ref = np.asarray(jt.forward(params, param, enc, dec, tgt_mask=mask))
    ker = np.asarray(jf.forward(jpacked, param, enc, dec, mask))
    before = tf.COUNTS.plain
    got = tf.forward(tpacked, param, torch.as_tensor(enc),
                     torch.as_tensor(dec), torch.as_tensor(mask)).numpy()
    assert tf.COUNTS.plain == before + 1 and tf.COUNTS.kernel == 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ker, rtol=1e-4, atol=1e-5)


def test_pointer_table_order(setup):
    """84 weights in the order the CUDA kernel's enums expect."""
    from dragposer_tpu_torch.ops import temporal_fused as tf

    ptrs = tf._pointers(setup[3])
    assert len(ptrs) == 9 + 3 * 10 + 3 * 15
    shapes = [tuple(p.shape) for p in ptrs]
    assert shapes[:9] == [(33, 48), (48,), (24, 48), (48,), (48, 24), (24,),
                          (30, 48), (2, 48), (2, 48)]
    assert shapes[9:19] == [(48, 144), (144,), (48, 48), (48,), (48, 2048),
                            (2048,), (2048, 48), (48,), (2, 48), (2, 48)]
    assert shapes[39:45] == [(48, 144), (144,), (48, 48), (48,), (48, 144),
                             (144,)]
    assert all(p.is_contiguous() and p.dtype == torch.float32 for p in ptrs)
