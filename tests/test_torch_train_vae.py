"""The port's pose-VAE trainer (``train/vae.py``, ``cli/train_vae.py``)
against the JAX package, on the CPU.

* ``loss_fn``'s six terms against JAX ``train/vae.loss_fn`` on the example
  checkpoint and a JAX init, with JAX's reparameterization draw handed to
  the port: each term to rtol 1e-5;
* every gradient leaf, the grad-of-grad consecutive term included, against
  ``jax.grad``: 1e-4 · max|g| of the leaf per entry (float32 sums through
  the decoder, FK and its reverse reassociated between XLA:CPU and
  PyTorch, twice for the second-order term);
* the consecutive term's inner gradient ∇_z f against central finite
  differences in float64 (``tests/test_training.py`` does it in float32 at
  rtol 2e-2): rtol 1e-6;
* one and three steps of clipping + AdamW against optax's chain on the
  same gradients, clipped and not: rtol 1e-6 / atol 1e-7;
* ``evaluate_generator`` against JAX's, same parameters and noise: rtol
  1e-4 (the root rotation integrated over 64-frame blocks in float32);
* ``train`` and the CLI on a tiny synthetic corpus: checkpoints written,
  exact resume.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from dragposer_tpu import config as jc
from dragposer_tpu.data import datasets as jds
from dragposer_tpu.models import vae as jv
from dragposer_tpu.ops.topology import Skeleton as JSkeleton
from dragposer_tpu.train import vae as jtv
from dragposer_tpu_torch import config as tc
from dragposer_tpu_torch.data import datasets as tds
from dragposer_tpu_torch.models import checkpoint as tck
from dragposer_tpu_torch.models import loading
from dragposer_tpu_torch.models import temporal as ttm
from dragposer_tpu_torch.models import vae as tv
from dragposer_tpu_torch.ops.topology import Skeleton as TSkeleton
from dragposer_tpu_torch.train import vae as ttv

torch.set_num_threads(2)
MODEL_DIR = "models/model_dancedb_example"


@pytest.fixture(scope="module")
def setup(example_parents):
    rng = np.random.default_rng(0)
    offsets = rng.normal(scale=0.2, size=(22, 3)).astype(np.float32)
    offsets[0] = 0
    params, means, stds = loading.load_generator(MODEL_DIR)
    return dict(
        parents=example_parents, offsets=offsets, params=params,
        mean=means["dqs"], std=stds["dqs"],
        jsk=JSkeleton.build(example_parents, offsets),
        tsk=TSkeleton.build(example_parents, offsets),
        js=jv.build_statics(example_parents, jc.VAE_PARAM),
        ts=tv.build_statics(example_parents, tc.VAE_PARAM))


def _pairs(b, seed):
    """Normalized consecutive-frame pairs: (B, 2, 176, 1), (B, 2, 3, 1)."""
    rng = np.random.default_rng(seed)
    dq = rng.normal(scale=0.5, size=(b, 1, 176, 1))
    dqs = dq + rng.normal(scale=0.05, size=(b, 2, 176, 1))
    disp = rng.normal(scale=0.5, size=(b, 2, 3, 1))
    return dqs.astype(np.float32), disp.astype(np.float32)


def _params(setup, which):
    if which == "example":
        return setup["params"]
    return jax.device_get(jv.init_params(jax.random.PRNGKey(3),
                                         setup["parents"], jc.VAE_PARAM))


def _both_losses(setup, params, b, use_fk=True, seed=1):
    dqs, disp = _pairs(b, seed)
    key = jax.random.PRNGKey(seed)

    def jloss(p):
        return jtv.loss_fn(p, setup["js"], setup["jsk"], key, (dqs, disp),
                           setup["mean"], setup["std"], setup["offsets"],
                           jc.VAE_PARAM, use_fk)

    noise = torch.as_tensor(np.asarray(jax.random.normal(key, (2 * b, 24))))
    tp = ttm.trainable(params, "cpu")
    total, terms = ttv.loss_fn(
        tp, setup["ts"], setup["tsk"], None,
        (torch.as_tensor(dqs), torch.as_tensor(disp)),
        torch.as_tensor(setup["mean"]), torch.as_tensor(setup["std"]),
        tc.VAE_PARAM, use_fk, noise=noise)
    return jloss, tp, total, terms


@pytest.mark.parametrize("which", ["example", "init"])
def test_loss_terms_match_jax(setup, which):
    jloss, _, total, terms = _both_losses(setup, _params(setup, which), 6)
    jtotal, jterms = jloss(_params(setup, which))
    assert list(terms) == list(jterms)
    for k in jterms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)


@pytest.mark.parametrize("which,use_fk", [("example", True), ("init", True),
                                          ("example", False)])
def test_gradients_match_jax(setup, which, use_fk):
    params = _params(setup, which)
    jloss, tp, total, _ = _both_losses(setup, params, 5, use_fk, seed=2)
    ref = dict(ttm.named_leaves(jax.device_get(
        jax.grad(lambda p: jloss(p)[0])(params))))
    total.backward()
    for path, t in ttm.named_leaves(tp):
        r = np.asarray(ref[path])
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()) + 1e-12,
                                   err_msg=path)


def test_consecutive_inner_gradient_matches_finite_differences(setup):
    dec64 = loading.tree_to_torch(setup["params"]["decoder"], "cpu",
                                  torch.float64)
    mean = torch.as_tensor(setup["mean"], dtype=torch.float64)
    std = torch.as_tensor(setup["std"], dtype=torch.float64)
    ts = tv.statics_on(setup["ts"], "cpu")
    ts64 = dataclasses.replace(
        ts, dec_masks=tuple(m.double() for m in ts.dec_masks),
        dec_unpools=tuple(m.double() for m in ts.dec_unpools))

    def f(z):
        p = ttv._positions_of_latent(z, dec64, ts64, setup["tsk"], mean, std,
                                     (1, 2))
        return ((p[:, 0] - p[:, 1]) ** 2).sum()

    z = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 24)))
    zr = z.clone().requires_grad_(True)
    g, = torch.autograd.grad(f(zr), zr)
    eps = 1e-6
    for idx in [(0, 0), (0, 13), (1, 7), (1, 23)]:
        zp, zm = z.clone(), z.clone()
        zp[idx] += eps
        zm[idx] -= eps
        fd = (float(f(zp)) - float(f(zm))) / (2 * eps)
        np.testing.assert_allclose(float(g[idx]), fd, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("steps", [1, 3])
def test_clip_and_adamw_match_optax(setup, steps):
    params = _params(setup, "init")
    jopt = jtv.make_optimizer(jc.VAE_PARAM)
    state = jopt.init(params)
    tp = ttm.trainable(params, "cpu")
    topt = ttv.make_optimizer(tp, tc.VAE_PARAM)
    rng = np.random.default_rng(5)
    for i in range(steps):
        # the first step's global norm is above the clip (100), the others
        # below it
        scale = 30.0 if i == 0 else 0.01
        grads = jax.tree.map(lambda a: (rng.normal(size=np.shape(a)) * scale)
                             .astype(np.float32), params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        gl = dict(ttm.named_leaves(grads))
        for path, t in ttm.named_leaves(tp):
            t.grad = torch.as_tensor(gl[path]).clone()
        norm = ttv.clip_and_step(topt, tc.VAE_PARAM)
        assert (float(norm) > 100.0) == (i == 0)
    jl = dict(ttm.named_leaves(jax.device_get(params)))
    for path, t in ttm.named_leaves(tp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jl[path]),
                                   rtol=1e-6, atol=1e-7, err_msg=path)


def test_train_step_lowers_the_loss(setup):
    tp = tv.init_params(torch.Generator().manual_seed(0), setup["parents"],
                        tc.VAE_PARAM)
    opt = ttv.make_optimizer(tp, tc.VAE_PARAM)
    step = ttv.make_train_step(setup["ts"], setup["tsk"], tc.VAE_PARAM, True,
                               opt)
    dqs, disp = (torch.as_tensor(a) for a in _pairs(4, 6))
    m, s = torch.zeros(176), torch.ones(176)
    noise = torch.zeros(8, 24)     # z = mu: the loss is a function of tp
    losses = [float(step(tp, None, dqs, disp, m, s, noise)[0])
              for _ in range(8)]
    assert losses[-1] < losses[0], losses


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded synthetic clips (train 200 + 180 frames, eval 130)."""
    data = tmp_path_factory.mktemp("train_vae") / "data"
    for sub, frames, seed in (("train", (200, 180), 5), ("eval", (130,), 9)):
        (data / sub).mkdir(parents=True)
        chip_smoke.write_synthetic_clips(str(data / sub), frames, seed)
    return str(data)


def test_evaluate_generator_matches_jax(setup, corpus):
    _, means, stds = loading.load_generator(MODEL_DIR)
    d = os.path.join(corpus, "eval")
    jm, jsk, jb = jds.load_motion_dir(d, jc.VAE_PARAM, keep_bvh=True)
    tm, tsk, tb = tds.load_motion_dir(d, tc.VAE_PARAM, keep_bvh=True)
    rng = np.random.default_rng(8)
    noise = {m.dqs.shape[0]: rng.normal(size=(m.dqs.shape[0], 24))
             .astype(np.float32) for m in tm}
    js, params = setup["js"], setup["params"]

    def jrec(p, key, dqs, mean, std):
        mu, logvar = jv.encode(p["encoder"], js, dqs[:, :, None])
        z = mu + noise[dqs.shape[0]] * jnp.exp(0.5 * logvar)
        motion, disp = jv.decode(p["decoder"], js, z, mean, std)
        return motion[:, :, 0], disp[:, :, 0]

    trec = ttv.make_reconstruct(setup["ts"])
    ref = jtv.evaluate_generator(params, jrec, None, jm, jb, jsk, means, stds)
    got = ttv.evaluate_generator(
        loading.tree_to_torch(params, "cpu"),
        lambda p, g, dqs, m, s: trec(p, g, dqs, m, s, noise=torch.as_tensor(
            noise[dqs.shape[0]])), None, tm, tb, tsk, means, stds)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert 0 < got[0] < 0.5


def test_train_writes_checkpoints_and_resumes_exactly(corpus, tmp_path):
    """Two epochs in one run equal one epoch, then a resumed second."""
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    quiet = dict(device="cpu", log=lambda s: 0)
    out = ttv.train(corpus, straight, tc.VAE_PARAM, epochs=2, **quiet)
    hist = out["history"]
    assert [h["steps"] for h in hist] == [6, 6]     # 377 pairs, batch 64
    assert set(hist[0]["terms"]) == {"kld", "root", "displacement",
                                     "consecutive", "joints", "fk"}
    assert all(np.isfinite([h["train_loss"], h["mpjpe"], h["mpeepe"]]).all()
               for h in hist)
    for f in ("generator.npz", "parameters.json", "generator.last.npz"):
        assert os.path.exists(os.path.join(straight, f)), f
    params, means, stds = loading.load_generator(straight)
    assert params["decoder"]["convs"][2]["w"].shape == (92, 92, 1)
    assert means["dqs"].shape == (176,)

    ttv.train(corpus, resumed, tc.VAE_PARAM, epochs=1, **quiet)
    out = ttv.train(corpus, resumed, tc.VAE_PARAM, epochs=2, load=True,
                    **quiet)
    assert [h["epoch"] for h in out["history"]] == [1]
    a, ao, ae = tck.load_training_state(straight + "/generator.last.npz")
    b, bo, be = tck.load_training_state(resumed + "/generator.last.npz")
    for (path, x), (_, y) in zip(ttm.named_leaves((a, ao)),
                                 ttm.named_leaves((b, bo))):
        np.testing.assert_array_equal(x, y, err_msg=path)
    assert float(ae["best"]) == float(be["best"])


def test_cli_trains_on_cpu(corpus, tmp_path):
    from dragposer_tpu_torch.cli import train_vae as cli

    root = tmp_path / "models"
    out = cli.main([corpus, "t", "--fk", "--epochs", "1", "--models-root",
                    str(root), "--device", "cpu"])
    assert out["history"][0]["steps"] == 6
    model = root / f"model_t_{os.path.basename(corpus)}"
    assert (model / "generator.npz").exists()
    assert (model / "generator.last.npz").exists()


def test_entry_point_needs_a_gpu_unless_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttv.train(corpus, str(tmp_path), tc.VAE_PARAM, epochs=1,
                  log=lambda s: 0)


def test_export_with_incremental_root_matches_jax(tmp_path):
    """``export.result_to_bvh`` as the VAE's evaluation calls it (root
    increments integrated per 64-frame block from ground truth, root
    displacement summed per block) against JAX's: Euler angles to 1e-3
    degrees (float32 quaternion products reassociated: JAX's prefix scan,
    the port's running product), positions to 1e-5 m."""
    from dragposer_tpu import export as jexport
    from dragposer_tpu.io.bvh import BVH as JBVH
    from dragposer_tpu_torch import export as texport
    from dragposer_tpu_torch.io.bvh import BVH as TBVH

    frames = 150
    path = str(tmp_path / "clip.bvh")
    chip_smoke.synthetic_bvh(frames, 4).save(path)
    jb, tb = JBVH().load(path), TBVH().load(path)
    _, means, stds = loading.load_generator(MODEL_DIR)
    rng = np.random.default_rng(3)

    def unit(q):
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    q = unit(rng.normal(size=(frames, 22, 4)))
    q[:, 0] = unit(np.array([1.0, 0, 0, 0]) + rng.normal(scale=0.02,
                                                           size=(frames, 4)))
    mean_q = means["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    std_q = stds["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    poses = ((q.reshape(frames, -1) - mean_q) / std_q).astype(np.float32)
    disp = rng.normal(size=(frames, 3)).astype(np.float32)
    gt = unit(rng.normal(size=(frames, 4))).astype(np.float32)
    kw = dict(displacement=disp, are_root_rot_incr=True, gt_rotations=gt)
    ref = jexport.result_to_bvh(poses, means, stds, jb,
                                JSkeleton.build(jb.parents, jb.offsets), **kw)
    got = texport.result_to_bvh(poses, means, stds, tb,
                                TSkeleton.build(tb.parents, tb.offsets), **kw)
    np.testing.assert_allclose(got.rotations, ref.rotations, rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=1e-5)
