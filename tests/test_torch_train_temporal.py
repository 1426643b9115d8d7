"""The port's temporal trainer against the JAX package, on the CPU.

* init: same tree paths, shapes and distributions;
* ``_limb_noise`` for the same per-limb flags and noise seed: equal to
  atol 2e-6 (hash Box-Muller, ulp-level ``log``/``cos`` differences);
* the lanes-layout training loss and every parameter gradient against JAX
  ``_teacher_forced_loss(layout="lanes", fused_ff=True, fused_attn=True)``
  on carried-over JAX parameters with JAX's 64 seeds, at dropout 0.1 and 0,
  in a narrow configuration (1+1 layers, FF 256, B = 8) so that the
  interpret-mode kernels stay quick: loss to rtol 1e-5, gradients to
  2e-5 · max|ref| (float32 sums reassociated between XLA:CPU and PyTorch;
  the masks are equal bit for bit, so nothing else differs);
* the card-vs-CPU step check of ``chip_smoke.py``, run on the CPU: the
  gate-synced plain step within ``GRAD_L2_TOL`` of the step itself, while
  one flipped ReLU gate or K3 on bfloat16 operands fails it;
* three Adam steps against optax on the same gradients: rtol 1e-6 / atol
  1e-7 (the same update, scalars rounded in another order);
* a port-written ``temporal.npz`` read by JAX ``checkpoint.load`` gives the
  same forward (rtol 1e-4 / atol 1e-5, as ``tests/test_torch_models.py``);
* exact resume from ``temporal.last.npz``: bitwise equal parameters;
* windows, encodings and statistics against ``dragposer_tpu.data``.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from dragposer_tpu import config as jc
from dragposer_tpu.models import temporal as jtm
from dragposer_tpu.ops import hash_dropout as jhd
from dragposer_tpu.train import temporal as jtr
from dragposer_tpu_torch import config as tc
from dragposer_tpu_torch.models import temporal as ttm
from dragposer_tpu_torch.train import temporal as ttr

torch.set_num_threads(2)
MODEL_DIR = "models/model_dancedb_example"
NARROW = dict(jc.TEMPORAL_PARAM, n_encoder_layers=1, n_decoder_layers=1,
              dim_feedforward=256, batch_size=4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded synthetic clips (train 200 + 180 frames, eval 130) and a model
    directory holding the example generator."""
    root = tmp_path_factory.mktemp("train_temporal")
    data = root / "data"
    for sub, frames, seed in (("train", (200, 180), 5), ("eval", (130,), 9)):
        (data / sub).mkdir(parents=True)
        chip_smoke.write_synthetic_clips(str(data / sub), frames, seed)
    return str(data)


def _model_dir(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    for f in ("generator.npz", "parameters.json"):
        shutil.copy(os.path.join(MODEL_DIR, f), d / f)
    return str(d)


def _init_bound(path, shape):
    """The uniform bound each leaf is drawn with (JAX ``init_params``)."""
    outer = path.split("/")[0] in ("in_proj_enc", "in_proj_dec", "out_proj")
    name = path.split("/")[-1]
    if outer or (name == "b" and "/ff" in path):
        fan_in = {"in_proj_enc": 33, "in_proj_dec": 24, "out_proj": 48,
                  "ff1": 48, "ff2": 2048}[path.split("/")[-2]]
        return 1.0 / np.sqrt(fan_in)
    return np.sqrt(6.0 / (shape[0] + shape[1]))


def test_init_params_same_tree_and_distributions():
    jp = jax.device_get(jtm.init_params(jax.random.PRNGKey(0),
                                        jc.TEMPORAL_PARAM))
    tp = ttm.init_params(torch.Generator().manual_seed(0), tc.TEMPORAL_PARAM)
    jl, tl = dict(ttm.named_leaves(jp)), dict(ttm.named_leaves(tp))
    assert sorted(jl) == sorted(tl)
    assert ttm.count_params(tp) == jtm.count_params(jp)
    for path, t in tl.items():
        a, r = t.detach().numpy(), np.asarray(jl[path])
        assert a.shape == r.shape and t.requires_grad, path
        if np.all(r == r.flat[0]):          # LayerNorm and attention biases
            np.testing.assert_array_equal(a, r, err_msg=path)
            continue
        bound = _init_bound(path, a.shape)
        for x in (a, r):                    # U(-bound, bound) on both sides
            assert np.abs(x).max() <= bound, path
            assert np.abs(x).max() >= 0.8 * bound, path
        if a.size >= 1000:
            assert abs(a.std() / (bound / np.sqrt(3)) - 1) < 0.05, path


def test_limb_noise_matches_jax():
    rng = np.random.default_rng(3)
    dq = rng.normal(size=(3, 15, 176)).astype(np.float32)
    m = rng.normal(size=176).astype(np.float32)
    s = rng.uniform(0.5, 2.0, size=176).astype(np.float32)
    fired = 0
    for i in range(12):
        key = jax.random.PRNGKey(i)
        ref = np.asarray(jtr._limb_noise(key, jnp.asarray(dq), m, s, 0.5))
        k_apply, k_noise = jax.random.split(key)
        applies = np.asarray(jax.random.uniform(k_apply, (4,)) < 0.5).tolist()
        seed = int(jax.random.randint(k_noise, (), 0, 2 ** 31 - 1, jnp.int32))
        got = ttr._limb_noise(torch.as_tensor(dq), torch.as_tensor(m),
                              torch.as_tensor(s), applies, seed).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
        fired += any(applies)
    assert 0 < fired < 12
    g = torch.Generator().manual_seed(1)
    applies, seed = ttr.draw_limb_noise(g, 0.1)
    assert len(applies) == 4 and 0 <= seed < 2 ** 31 - 1


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    L = 24
    return (rng.normal(size=(b, 15, L)).astype(np.float32),
            rng.normal(size=(b, 15, L)).astype(np.float32),
            rng.normal(size=(b, 15, 3)).astype(np.float32),
            rng.normal(size=(b, 15, 6)).astype(np.float32),
            rng.normal(scale=0.1, size=L).astype(np.float32),
            rng.uniform(0.5, 1.5, size=L).astype(np.float32))


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_training_loss_and_grads_match_jax(rate):
    param = dict(NARROW, dropout=rate)
    jp = jtm.init_params(jax.random.PRNGKey(3), param)
    arrays = _batch(8, 4)
    key = jax.random.PRNGKey(7)

    def loss(p):
        return jtr._teacher_forced_loss(p, param, *arrays, train=True,
                                        rng=key, fused_ff=True,
                                        fused_attn=True, layout="lanes")

    ref, ref_grads = jax.value_and_grad(loss)(jp)
    seeds = [int(s) for s in np.asarray(jhd.seeds_for(key, 64))]
    tp = ttm.trainable(jax.device_get(jp), "cpu")
    got = ttr._teacher_forced_loss(tp, param,
                                   *map(torch.as_tensor, arrays),
                                   train=True, seeds=seeds)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    rg = dict(ttm.named_leaves(jax.device_get(ref_grads)))
    for path, t in ttm.named_leaves(tp):
        r = np.asarray(rg[path])
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=2e-5 * float(np.abs(r).max()) + 1e-9,
                                   err_msg=path)


def test_card_vs_cpu_step_check_tells_gates_and_bf16_apart():
    """The card-vs-CPU step check of ``chip_smoke.py`` on the CPU: given
    the step's own ReLU gates, the gate-synced plain step agrees within
    ``GRAD_L2_TOL`` (float32 rounding only); one flipped gate is counted
    and fails it; K3 on bfloat16 operands fails it."""
    from dragposer_tpu_torch.ops import ff_fused

    param = dict(NARROW, dropout=0.1)
    lat, lat_f, disp, hts, ml, sl = map(torch.as_tensor, _batch(8, 11))
    batch = (lat, lat_f, disp, hts, ml, sl)
    seeds = list(range(1, 65))
    init = ttm.init_params(torch.Generator().manual_seed(2), param)
    sites, ff = [], ff_fused.ff_dropout_lanes

    def record(x, ff1, ff2, rate, seed):
        sites.append((x.detach().clone(), ff1["w"].detach().clone(),
                      ff1["b"].detach().clone(), seed))
        return ff(x, ff1, ff2, rate, seed)

    def gates_of(rnd):
        return [((torch.einsum("fd,sdb->sfb", rnd(w), rnd(x))
                  + b[None, :, None]) > 0).contiguous()
                for x, w, b, _ in sites]

    with chip_smoke._swapped(ff_fused, ff_dropout_lanes=record):
        own = chip_smoke._step_leaves(init, param, "cpu", batch, seeds)
    gates = gates_of(lambda t: t)
    synced, flips = chip_smoke._cpu_step(init, param, batch, seeds, gates)
    assert flips == [0, 0]
    assert chip_smoke._step_agreement(own, synced)["ok"]

    # close the kept open gate nearest 0, as rounding would
    x, w, b, seed = sites[0]
    pre = torch.einsum("fd,sdb->sfb", w, x) + b[None, :, None]
    keep = ff_fused.keep_mask_lanes(*pre.shape, param["dropout"], seed)
    i = int(torch.where(gates[0] & keep, pre, torch.inf).argmin())
    gates[0].view(-1)[i] = False
    flipped, flips = chip_smoke._cpu_step(init, param, batch, seeds, gates)
    assert flips == [1, 0]
    res = chip_smoke._step_agreement(own, flipped)
    assert not res["ok"], res
    assert res["worst_grad_leaf"].startswith("enc_layers/0/ff1/"), res

    rnd = chip_smoke._bf16
    fp, bp = ff_fused.forward_plain, ff_fused.backward_plain
    sites.clear()
    with chip_smoke._swapped(
            ff_fused, ff_dropout_lanes=record,
            forward_plain=lambda x, w1, b1, w2, b2, r, s: fp(
                rnd(x), rnd(w1), b1, rnd(w2), b2, r, s),
            backward_plain=lambda x, w1, b1, w2, g, r, s: bp(
                rnd(x), rnd(w1), b1, rnd(w2), rnd(g), r, s)):
        control = chip_smoke._step_leaves(init, param, "cpu", batch, seeds)
    control_ref, _ = chip_smoke._cpu_step(init, param, batch, seeds,
                                          gates_of(rnd))
    res = chip_smoke._step_agreement(control, control_ref)
    assert not res["ok"] and res["grad_rel_l2_err"] > 10 * \
        chip_smoke.GRAD_L2_TOL


def test_adam_three_steps_match_optax():
    param = dict(NARROW, learning_rate=1e-3)
    jp = jax.device_get(jtm.init_params(jax.random.PRNGKey(1), param))
    tp = ttm.trainable(jp, "cpu")
    opt = ttr.make_optimizer(tp, param)
    jopt = optax.adam(param["learning_rate"], b1=0.9, b2=0.999, eps=1e-8)
    state = jopt.init(jp)
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: rng.normal(size=np.shape(a)).astype(np.float32), jp)
        updates, state = jopt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        gl = dict(ttm.named_leaves(grads))
        for path, t in ttm.named_leaves(tp):
            t.grad = torch.as_tensor(gl[path])
        opt.step()
    jl = dict(ttm.named_leaves(jax.device_get(jp)))
    for path, t in ttm.named_leaves(tp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jl[path]),
                                   rtol=1e-6, atol=1e-7, err_msg=path)


def test_port_checkpoint_read_by_jax(tmp_path):
    from dragposer_tpu.models import checkpoint as jck
    from dragposer_tpu_torch.models import checkpoint as tck

    tp = ttm.init_params(torch.Generator().manual_seed(5), tc.TEMPORAL_PARAM)
    ml = np.linspace(-1, 1, 24).astype(np.float32)
    sl = np.linspace(0.5, 2, 24).astype(np.float32)
    path = str(tmp_path / "temporal.npz")
    tck.save(path, tp, extra={"means_latent": ml, "stds_latent": sl})
    jp, extra = jck.load(path)
    np.testing.assert_array_equal(extra["means_latent"], ml)
    np.testing.assert_array_equal(extra["stds_latent"], sl)
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(3, 14, 33)).astype(np.float32)
    dec = rng.normal(size=(3, 15, 24)).astype(np.float32)
    mask = np.where(np.tri(15, dtype=bool), 0.0, -np.inf).astype(np.float32)
    ref = np.asarray(jtm.forward(jp, jc.TEMPORAL_PARAM, enc, dec,
                                 tgt_mask=mask))
    with torch.no_grad():
        got = ttm.forward(tp, tc.TEMPORAL_PARAM, torch.as_tensor(enc),
                          torch.as_tensor(dec), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_exact_resume(corpus, tmp_path):
    """Two epochs in one run equal one epoch, then a resumed second."""
    from dragposer_tpu_torch.models import checkpoint as tck

    param = dict(NARROW, dropout=0.1)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    straight = _model_dir(tmp_path / "a")
    resumed = _model_dir(tmp_path / "b")
    ttr.train(corpus, straight, param, epochs=2, device="cpu", log=lambda s: 0)
    ttr.train(corpus, resumed, param, epochs=1, device="cpu", log=lambda s: 0)
    out = ttr.train(corpus, resumed, param, epochs=2, load=True,
                    device="cpu", log=lambda s: 0)
    assert [h["epoch"] for h in out["history"]] == [1]
    a, ao, ae = tck.load_training_state(straight + "/temporal.last.npz")
    b, bo, be = tck.load_training_state(resumed + "/temporal.last.npz")
    for (path, x), (_, y) in zip(ttm.named_leaves((a, ao)),
                                 ttm.named_leaves((b, bo))):
        np.testing.assert_array_equal(x, y, err_msg=path)
    assert float(ae["best"]) == float(be["best"])


def test_train_writes_loadable_checkpoints(corpus, tmp_path):
    from dragposer_tpu_torch.models import loading

    model = _model_dir(tmp_path)
    out = ttr.train(corpus, model, dict(NARROW, dropout=0.0), epochs=2,
                    device="cpu", log=lambda s: 0)
    hist = out["history"]
    assert [h["steps"] for h in hist] == [2, 2]        # 9 windows, B = 4
    assert all(np.isfinite([h["train_loss"], h["eval_loss"]]).all()
               for h in hist)
    params, ml, sl = loading.load_temporal(model)
    assert ml.shape == (24,) and np.all(sl > 0)
    assert params["enc_layers"][0]["ff1"]["w"].shape == (256, 48)


def test_cli_trains_on_cpu(corpus, tmp_path):
    """The CLI at the recipe's full width (3+3 layers, FF 2048) for one
    epoch on the tiny corpus (one batch of all 9 windows)."""
    from dragposer_tpu_torch.cli import train_temporal as cli

    root = tmp_path / "models"
    name = "t"
    model = root / f"model_{name}_{os.path.basename(corpus)}"
    model.mkdir(parents=True)
    for f in ("generator.npz", "parameters.json"):
        shutil.copy(os.path.join(MODEL_DIR, f), model / f)
    out = cli.main([corpus, name, "--models-root", str(root), "--epochs",
                    "1", "--device", "cpu"])
    assert out["history"][0]["steps"] == 1
    assert (model / "temporal.npz").exists()
    assert (model / "temporal.last.npz").exists()


def test_entry_points_need_a_gpu_unless_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.train(corpus, _model_dir(tmp_path), NARROW, epochs=1,
                  log=lambda s: 0)


def test_windows_and_stats_match_jax(corpus):
    from dragposer_tpu.data import datasets as jds
    from dragposer_tpu.data import encoding as jenc
    from dragposer_tpu_torch.data import datasets as tds
    from dragposer_tpu_torch.data import encoding as tenc

    d = os.path.join(corpus, "train")
    param = jc.TEMPORAL_PARAM
    jm, _, _ = jds.load_motion_dir(d, param, height_indices=param[
        "height_indices"], sample_step=4)
    tm, _, _ = tds.load_motion_dir(d, param, height_indices=param[
        "height_indices"], sample_step=4)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.displacement_acc, b.displacement_acc,
                                   atol=1e-6)
    js, ts = jenc.RunningStats(), tenc.RunningStats()
    for a, b in zip(tm, jm):
        ts.add(a)
        js.add(b)
    (tmean, tstd), (jmean, jstd) = ts.finalize(), js.finalize()
    for k in ("dqs", "displacement"):
        np.testing.assert_allclose(tmean[k], jmean[k], atol=1e-5)
        np.testing.assert_allclose(tstd[k], jstd[k], rtol=1e-4, atol=1e-5)
    with open(os.path.join(MODEL_DIR, "parameters.json")) as f:
        assert json.load(f)
    tw = tds.build_temporal_dataset(tm, param, tmean, tstd)
    jw = jds.build_temporal_dataset(jm, param, tmean, tstd)
    assert tw.dqs_past.shape == jw.dqs_past.shape == (9, 15, 176)
    # normalized dual quats compared at the data's scale: channels with a
    # tiny std amplify float32 encoding differences
    for field, scale in (("dqs_past", tstd["dqs"]), ("dqs_future",
                                                     tstd["dqs"]),
                         ("disp_past_acc", 1.0), ("heights", 1.0)):
        np.testing.assert_allclose(getattr(tw, field) * scale,
                                   getattr(jw, field) * scale, atol=1e-5,
                                   err_msg=field)
