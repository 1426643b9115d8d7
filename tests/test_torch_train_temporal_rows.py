"""The port's rows-layout temporal training step against the JAX package, on
the CPU.

* dropout 0: loss and every parameter gradient of the port's
  ``_teacher_forced_loss(layout="rows", train=True)`` against JAX
  ``_teacher_forced_loss(layout="rows", fused_ff=True, train=True)`` (K3a/K3b
  in interpret mode) on carried-over JAX parameters, in a narrow
  configuration (1+1 layers, FF 256, B = 8): loss to rtol 1e-5, gradients
  to 2e-5 · max|ref| (float32 sums reassociated between XLA:CPU and
  PyTorch); and against the port's lanes layout, which computes the same
  function (as ``tests/test_ff_fused.py`` holds JAX's two layouts);
* dropout 0.1: the loss is a function of the seeds; each feed-forward
  site's mask is JAX's at that site's seed (JAX's other sites draw threefry
  bits, which the port cannot reproduce);
* ten ``make_train_step(layout="rows")`` steps on one batch lower the
  loss;
* ``train(layout="rows")`` writes its checkpoints and resumes exactly.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dragposer_tpu import config as jc
from dragposer_tpu.models import temporal as jtm
from dragposer_tpu.ops import ff_fused as jff
from dragposer_tpu.train import temporal as jtr
from dragposer_tpu_torch import config as tc
from dragposer_tpu_torch.models import temporal as ttm
from dragposer_tpu_torch.ops import ff_fused as tff
from dragposer_tpu_torch.train import temporal as ttr

torch.set_num_threads(2)
MODEL_DIR = "models/model_dancedb_example"
NARROW = dict(jc.TEMPORAL_PARAM, n_encoder_layers=1, n_decoder_layers=1,
              dim_feedforward=256, batch_size=4)
FF_SITES = (5, 11)   # the seeds' feed-forward sites at 1+1 layers


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    L = 24
    return (rng.normal(size=(b, 15, L)).astype(np.float32),
            rng.normal(size=(b, 15, L)).astype(np.float32),
            rng.normal(size=(b, 15, 3)).astype(np.float32),
            rng.normal(size=(b, 15, 6)).astype(np.float32),
            rng.normal(scale=0.1, size=L).astype(np.float32),
            rng.uniform(0.5, 1.5, size=L).astype(np.float32))


def _port_loss(tp, param, arrays, seeds, layout):
    return ttr._teacher_forced_loss(tp, param, *map(torch.as_tensor, arrays),
                                    train=True, seeds=seeds, layout=layout)


def test_rows_loss_and_grads_match_jax_at_dropout_0():
    param = dict(NARROW, dropout=0.0)
    jp = jtm.init_params(jax.random.PRNGKey(3), param)
    arrays = _batch(8, 4)
    key = jax.random.PRNGKey(7)

    def loss(p):
        return jtr._teacher_forced_loss(p, param, *arrays, train=True,
                                        rng=key, fused_ff=True, layout="rows")

    ref, ref_grads = jax.value_and_grad(loss)(jp)
    rg = dict(ttm.named_leaves(jax.device_get(ref_grads)))
    seeds = list(range(1, 65))
    losses = {}
    for layout in ("rows", "lanes"):
        tp = ttm.trainable(jax.device_get(jp), "cpu")
        got = _port_loss(tp, param, arrays, seeds, layout)
        got.backward()
        losses[layout] = float(got.detach())
        np.testing.assert_allclose(losses[layout], float(ref), rtol=1e-5)
        for path, t in ttm.named_leaves(tp):
            r = np.asarray(rg[path])
            np.testing.assert_allclose(
                t.grad.numpy(), r, rtol=0,
                atol=2e-5 * float(np.abs(r).max()) + 1e-9,
                err_msg=f"{layout}: {path}")
    assert abs(losses["rows"] - losses["lanes"]) <= 1e-5 * losses["rows"]


def test_rows_dropout_masks_follow_the_seeds():
    param = dict(NARROW, dropout=0.1)
    jp = jax.device_get(jtm.init_params(jax.random.PRNGKey(5), param))
    arrays = _batch(8, 6)
    keys = jax.random.split(jax.random.PRNGKey(11), 64)
    # the seed JAX's ff_dropout derives from each site's key
    seeds = [int(jax.random.randint(k, (), 0, 2 ** 31 - 1, jnp.int32))
             for k in keys]
    calls = []
    ff = tff.ff_dropout_seeded

    def record(x, ff1, ff2, rate, seed):
        calls.append((x.reshape(-1, x.shape[-1]).shape[0], seed))
        return ff(x, ff1, ff2, rate, seed)

    tp = ttm.trainable(jp, "cpu")
    with chip_smoke._swapped(tff, ff_dropout_seeded=record):
        a = float(_port_loss(tp, param, arrays, seeds, "rows").detach())
    b = float(_port_loss(tp, param, arrays, seeds, "rows"))
    c = float(_port_loss(tp, param, arrays, seeds[::-1], "rows"))
    assert a == b and a != c
    assert [s for _, s in calls] == [seeds[i] for i in FF_SITES]
    f = param["dim_feedforward"]
    for m, seed in calls:
        y = jff._fwd_call(0.1, jnp.zeros((m, f)), jnp.zeros((f, f)),
                          jnp.ones((f,)), jnp.eye(f), jnp.zeros((f,)),
                          jnp.array([seed], jnp.int32))
        np.testing.assert_array_equal(
            tff.keep_mask_rows(m, f, 0.1, seed).numpy(), np.asarray(y > 0.5))


def test_rows_train_steps_lower_the_loss(example_parents):
    """``make_train_step(layout="rows")`` on one batch of windows, through
    the example generator's encoder: the loss falls."""
    from dragposer_tpu_torch.models import loading, vae

    param = dict(NARROW, dropout=0.0)
    gen, means, stds = loading.load_generator(MODEL_DIR)
    vae_params = loading.tree_to_torch(gen, "cpu")
    statics = vae.build_statics(example_parents, tc.VAE_PARAM)
    tp = ttm.init_params(torch.Generator().manual_seed(4), param)
    step = ttr.make_train_step(vae_params, statics, param,
                               ttr.make_optimizer(tp, param), layout="rows")
    rng = np.random.default_rng(8)
    batch = [torch.as_tensor(rng.normal(scale=0.3, size=s).astype(np.float32))
             for s in ((8, 15, 176), (8, 15, 176), (8, 15, 3), (8, 15, 6))]
    stats = [torch.as_tensor(a) for a in (means["dqs"], stds["dqs"],
                                          np.zeros(24, np.float32),
                                          np.ones(24, np.float32))]
    host, dev = (torch.Generator().manual_seed(1),
                 torch.Generator().manual_seed(2))
    before = tff.COUNTS_FWD_ROWS.plain
    losses = [float(step(tp, host, dev, *batch, *stats)) for _ in range(10)]
    assert tff.COUNTS_FWD_ROWS.plain == before + 10 * 2
    assert np.mean(losses[-3:]) < 0.9 * np.mean(losses[:3]), losses


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded synthetic clips (train 200 + 180 frames, eval 130)."""
    root = tmp_path_factory.mktemp("train_rows")
    data = root / "data"
    for sub, frames, seed in (("train", (200, 180), 5), ("eval", (130,), 9)):
        (data / sub).mkdir(parents=True)
        chip_smoke.write_synthetic_clips(str(data / sub), frames, seed)
    return str(data)


def _model_dir(tmp_path):
    d = tmp_path / "model"
    d.mkdir(parents=True)
    for f in ("generator.npz", "parameters.json"):
        shutil.copy(os.path.join(MODEL_DIR, f), d / f)
    return str(d)


def test_rows_train_writes_checkpoints_and_resumes_exactly(corpus, tmp_path):
    """Two epochs in one run equal one epoch, then a resumed second."""
    from dragposer_tpu_torch.models import checkpoint as tck

    param = dict(NARROW, dropout=0.1)
    straight = _model_dir(tmp_path / "a")
    resumed = _model_dir(tmp_path / "b")
    quiet = dict(device="cpu", log=lambda s: 0, layout="rows")
    out = ttr.train(corpus, straight, param, epochs=2, **quiet)
    assert [h["steps"] for h in out["history"]] == [2, 2]
    assert all(np.isfinite([h["train_loss"], h["eval_loss"]]).all()
               for h in out["history"])
    for f in ("temporal.npz", "temporal.last.npz"):
        assert os.path.exists(os.path.join(straight, f))
    before = tff.COUNTS_FWD_ROWS.plain
    ttr.train(corpus, resumed, param, epochs=1, **quiet)
    assert tff.COUNTS_FWD_ROWS.plain == before + 4   # 2 steps × 2 FFs
    out = ttr.train(corpus, resumed, param, epochs=2, load=True, **quiet)
    assert [h["epoch"] for h in out["history"]] == [1]
    a, ao, ae = tck.load_training_state(straight + "/temporal.last.npz")
    b, bo, be = tck.load_training_state(resumed + "/temporal.last.npz")
    for (path, x), (_, y) in zip(ttm.named_leaves((a, ao)),
                                 ttm.named_leaves((b, bo))):
        np.testing.assert_array_equal(x, y, err_msg=path)
    assert float(ae["best"]) == float(be["best"])


def test_rows_training_forward_needs_seeds():
    tp = ttm.init_params(torch.Generator().manual_seed(1), tc.TEMPORAL_PARAM)
    with pytest.raises(ValueError):
        ttm.forward(tp, tc.TEMPORAL_PARAM, torch.zeros(2, 14, 33),
                    torch.zeros(2, 15, 24), train=True)


def test_rows_card_vs_cpu_step_check_tells_gates_and_bf16_apart():
    """The card-vs-CPU step check of ``chip_smoke.py`` in the rows layout,
    run on the CPU: given the step's own ReLU gates the gate-synced plain
    step agrees within ``GRAD_L2_TOL``; one flipped gate is counted and
    fails it; K3a/K3b on bfloat16 operands fail it."""
    param = dict(NARROW, dropout=0.1)
    batch = tuple(map(torch.as_tensor, _batch(8, 11)))
    seeds = list(range(1, 65))
    init = ttm.init_params(torch.Generator().manual_seed(2), param)
    sites, ff = [], tff.ff_dropout_seeded

    def record(x, ff1, ff2, rate, seed):
        sites.append((x.detach().reshape(-1, x.shape[-1]).clone(),
                      ff1["w"].detach().clone(), ff1["b"].detach().clone(),
                      seed))
        return ff(x, ff1, ff2, rate, seed)

    def gates_of(rnd):
        return [(rnd(x) @ rnd(w).T + b) > 0 for x, w, b, _ in sites]

    with chip_smoke._swapped(tff, ff_dropout_seeded=record):
        own = chip_smoke._step_leaves(init, param, "cpu", batch, seeds,
                                      "rows")
    gates = gates_of(lambda t: t)
    synced, flips = chip_smoke._cpu_step(init, param, batch, seeds, gates,
                                         "rows")
    assert flips == [0, 0]
    assert chip_smoke._step_agreement(own, synced)["ok"]

    # close the kept open gate nearest 0, as rounding would
    x, w, b, seed = sites[0]
    pre = x @ w.T + b
    keep = tff.keep_mask_rows(*pre.shape, param["dropout"], seed)
    i = int(torch.where(gates[0] & keep, pre, torch.inf).argmin())
    gates[0].view(-1)[i] = False
    flipped, flips = chip_smoke._cpu_step(init, param, batch, seeds, gates,
                                          "rows")
    assert flips == [1, 0]
    res = chip_smoke._step_agreement(own, flipped)
    assert not res["ok"], res
    assert res["worst_grad_leaf"].startswith("enc_layers/0/ff1/"), res

    rnd = chip_smoke._bf16
    fp, bp = tff.forward_plain_rows, tff.backward_plain_rows
    sites.clear()
    with chip_smoke._swapped(
            tff, ff_dropout_seeded=record,
            forward_plain_rows=lambda x, w1, b1, w2, b2, r, s: fp(
                rnd(x), rnd(w1), b1, rnd(w2), b2, r, s),
            backward_plain_rows=lambda x, w1, b1, w2, g, r, s: bp(
                rnd(x), rnd(w1), b1, rnd(w2), rnd(g), r, s)):
        control = chip_smoke._step_leaves(init, param, "cpu", batch, seeds,
                                          "rows")
    control_ref, _ = chip_smoke._cpu_step(init, param, batch, seeds,
                                          gates_of(rnd), "rows")
    res = chip_smoke._step_agreement(control, control_ref)
    assert not res["ok"] and res["grad_rel_l2_err"] > 10 * \
        chip_smoke.GRAD_L2_TOL
