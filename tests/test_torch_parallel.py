"""The port's data-parallel layer (``parallel/mesh.py``,
``parallel/distributed.py``, ``eval_drag --mesh``) against the JAX
package's rules, on the CPU.

* layouts: ``make_mesh``'s ``("data", "model")`` grid, ``shard_batch``
  cutting the leading axis over ``data``, and the tensor-parallel
  temporal layout of every leaf equal to the JAX module's spec
  (``tests/test_parallel.py``'s rules);
* ``evaluate_batched(mesh_devices=2)`` over two CPU slots (the CPU named
  twice by a stubbed ``local_devices``) on an odd lane count (one inert
  padding lane) against the unsharded run, lane by lane, within 1e-6;
* ``_run_sharded`` itself on 5 lanes, and two processes joined by
  ``torch.distributed`` (gloo, asked for by ``device="cpu"``) each
  running 4 of 8 lanes, gathered
  through ``DTensor``s, against one process running all of them: PyTorch's
  CPU matmuls round a lane differently at another lane count (5e-5 in
  the latent between 3 and 5 lanes, no sharding involved), so these hold
  the pipeline lockstep's tolerances (``tests/test_torch_pipeline.py``);
  the processes also place the temporal weights as DTensors on a (1, 2)
  mesh.  The worker is this file run as a script, with a 120 s timeout;
* with no GPU and no device named, the layer raises: it never runs on the
  CPU unasked.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _cpu_slots(monkeypatch, n):
    """``parallel.mesh.local_devices`` giving ``n`` slots of the CPU (a
    card per slot, as the sharded path sees them)."""
    from dragposer_tpu_torch.parallel import mesh as meshlib

    monkeypatch.setattr(meshlib, "local_devices",
                        lambda kind=None: [torch.device("cpu")] * n)


def _cpu_mesh(data, model):
    from dragposer_tpu_torch.parallel import mesh as meshlib

    return meshlib.make_mesh(data=data, model=model,
                             devices=[torch.device("cpu")] * (data * model))


def test_make_mesh_axes():
    mesh = _cpu_mesh(4, 2)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (4, 2)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.device_mesh is None


def test_make_mesh_defaults_to_local_devices_on_data(monkeypatch):
    """``make_mesh()`` takes ``local_devices()``; the CPU is a device only
    where the caller names it."""
    from dragposer_tpu_torch.parallel import mesh as meshlib

    assert meshlib.local_devices("cpu") == [torch.device("cpu")]
    assert meshlib.make_mesh(devices=meshlib.local_devices(
        "cpu")).devices.shape == (1, 1)
    _cpu_slots(monkeypatch, 3)
    mesh = meshlib.make_mesh()
    assert mesh.devices.shape == (3, 1)
    with pytest.raises(ValueError):
        meshlib.make_mesh(data=4, devices=meshlib.local_devices("cpu"))


def test_shard_batch_places_leading_axis():
    from dragposer_tpu_torch.parallel import mesh as meshlib

    mesh = _cpu_mesh(4, 2)
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    pieces = meshlib.shard_batch({"x": x}, mesh)
    assert len(pieces) == 8
    assert meshlib.batch_sharding(mesh).spec == ("data",)
    # grid position (i, k) holds rows 2i, 2i + 1; the model axis copies
    for i in range(4):
        for k in range(2):
            np.testing.assert_array_equal(pieces[2 * i + k]["x"].numpy(),
                                          x[2 * i:2 * i + 2])
    rep = meshlib.replicate(x, mesh)
    assert all(np.array_equal(r.numpy(), x) for r in rep)
    with pytest.raises(ValueError, match="divide"):
        meshlib.shard_batch(np.zeros((7, 2)), mesh)


def test_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    from dragposer_tpu_torch.parallel import mesh as meshlib

    mesh = _cpu_mesh(4, 2)
    assert meshlib.batch_sharding(mesh).placements == [Shard(0),
                                                       Replicate()]
    assert meshlib.replicated(mesh).placements == [Replicate(), Replicate()]
    assert meshlib.NamedSharding(mesh, (None, "model")).placements == [
        Replicate(), Shard(1)]


def test_temporal_param_sharding_layout_matches_jax():
    """Every leaf's spec equals the JAX module's (a one-device JAX mesh
    names the same specs), and the (1, 2) local placement cuts ``ff1``'s
    rows and ``ff2``'s columns in two."""
    import jax

    from dragposer_tpu.config import TEMPORAL_PARAM
    from dragposer_tpu.models import temporal as jtemporal
    from dragposer_tpu.parallel import mesh as jmesh
    from dragposer_tpu_torch.parallel import mesh as meshlib

    tparams = jax.device_get(jtemporal.init_params(jax.random.PRNGKey(0),
                                                   TEMPORAL_PARAM))
    jsharded = jmesh.temporal_param_sharding(
        tparams, jmesh.make_mesh(data=1, model=1,
                                 devices=jax.devices()[:1]))
    flat = jax.tree_util.tree_flatten_with_path(jsharded)[0]
    n_model = 0
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        want = tuple(leaf.sharding.spec)
        got = meshlib.temporal_spec(name, leaf.ndim)
        assert got + (None,) * (len(want) - len(got)) == want + (None,) * (
            len(got) - len(want)), name
        n_model += "model" in got
    # per encoder layer QKV, out, ff1, ff2; per decoder layer two attentions
    assert n_model == (4 * TEMPORAL_PARAM["n_encoder_layers"]
                       + 6 * TEMPORAL_PARAM["n_decoder_layers"])
    pieces = meshlib.temporal_param_sharding(tparams, _cpu_mesh(1, 2))
    ff1 = np.asarray(tparams["enc_layers"][0]["ff1"]["w"])
    ff2 = np.asarray(tparams["enc_layers"][0]["ff2"]["w"])
    np.testing.assert_array_equal(np.concatenate(
        [p["enc_layers"][0]["ff1"]["w"].numpy() for p in pieces], 0), ff1)
    np.testing.assert_array_equal(np.concatenate(
        [p["enc_layers"][0]["ff2"]["w"].numpy() for p in pieces], 1), ff2)
    assert pieces[0]["enc_layers"][0]["ff1"]["w"].shape[0] == ff1.shape[0] // 2
    np.testing.assert_array_equal(
        pieces[1]["enc_layers"][0]["ln1"]["g"].numpy(),
        np.asarray(tparams["enc_layers"][0]["ln1"]["g"]))


def _engine_and_clips(tmp_path, n_files):
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.ops.topology import Skeleton

    files = chip_smoke.write_synthetic_clips(
        str(tmp_path), tuple(12 - 2 * i for i in range(n_files)), seed=7)
    first = BVH().load(files[0])
    _, _, parents, offsets, _ = encoding.info_from_bvh(first)
    engine, means, stds = tev.build_engine(
        MODEL_DIR, parents, tev.resolve_config("6_trackers"),
        skeleton=Skeleton.build(parents, offsets, first.names),
        device="cpu")
    return engine, means, stds, files


def test_evaluate_batched_mesh_matches_unsharded(tmp_path, monkeypatch):
    """The ``--batch --mesh 2`` path on two CPU slots: 3 lanes, padded
    to 4 with an inert lane, against the one-device run; the default is
    the one-device run, not the sharded path."""
    from dragposer_tpu_torch.cli import eval_drag as tev

    _cpu_slots(monkeypatch, 2)
    engine, means, stds, files = _engine_and_clips(tmp_path, 3)
    seen = []
    real = tev._export_batched

    def grab(poses, global_pos, *args):
        seen.append((np.array(poses), np.array(global_pos)))
        return real(poses, global_pos, *args)

    monkeypatch.setattr(tev, "_export_batched", grab)
    sharded, real_sharded = [], tev._run_sharded

    def counted(*args, **kwargs):
        sharded.append(args[1])
        return real_sharded(*args, **kwargs)

    monkeypatch.setattr(tev, "_run_sharded", counted)
    one = tev.evaluate_batched(engine, means, stds, engine.skeleton, files,
                               save_dir=str(tmp_path / "one"),
                               mesh_devices=1)
    two = tev.evaluate_batched(engine, means, stds, engine.skeleton, files,
                               save_dir=str(tmp_path / "two"),
                               mesh_devices=2)
    default = tev.evaluate_batched(engine, means, stds, engine.skeleton,
                                   files, save_dir=str(tmp_path / "all"))
    np.testing.assert_allclose(np.asarray(two), np.asarray(one), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(default), np.asarray(one), rtol=0,
                               atol=1e-6)
    assert sharded == [2]
    for lane in range(3):
        for got, ref in zip(seen[1], seen[0]):
            np.testing.assert_allclose(got[lane], ref[lane], rtol=0,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="--mesh 3 > 2 local devices"):
        tev.evaluate_batched(engine, means, stds, engine.skeleton, files,
                             save_dir=str(tmp_path / "x"), mesh_devices=3)


def test_run_sharded_lane_by_lane(tmp_path, monkeypatch):
    """``_run_sharded`` on 5 lanes over 2 slots (one padding lane) against
    ``run_batch_pipelined`` on the same states, lane by lane.  PyTorch's
    CPU matmuls round a row differently at another row count: the first
    3 of these lanes run alone already differ from the 5-lane run by 5e-5
    in the latent, no sharding involved.  So the pieces are held as the
    pipeline lockstep is (``tests/test_torch_pipeline.py``): iterations
    equal, latent atol 1e-4, root position atol 1e-5, normalized pose
    rtol 1e-3 / atol 2e-3, losses rtol 1e-3 / atol 1e-7."""
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.drag.engine import to_host

    _cpu_slots(monkeypatch, 2)
    engine, means, stds, _ = _engine_and_clips(tmp_path, 1)
    bvh = chip_smoke.synthetic_bvh(10, seed=9)
    states, dqs, gp, gr = chip_smoke.lane_batch(engine, bvh, means, stds,
                                                5, 10)
    lengths = np.array([10, 7, 10, 4, 9], np.int32)
    got = tev._run_sharded(engine, 2, states, dqs, gp, gr, lengths, 4)
    _, ref = engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=4,
                                        lengths=lengths)
    ref = to_host(ref)
    for name, a, b in zip(got._fields, got, ref):
        assert a.shape == b.shape, name
    np.testing.assert_array_equal(got.iterations, ref.iterations)
    np.testing.assert_allclose(got.latent, ref.latent, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.global_pos, ref.global_pos, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.pose, ref.pose, rtol=1e-3, atol=2e-3)
    for name in ("loss_pos", "loss_rot"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-3, atol=1e-7, err_msg=name)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lanes(engine, means, stds, B=8, T=8):
    bvh = chip_smoke.synthetic_bvh(T, seed=9)
    return chip_smoke.lane_batch(engine, bvh, means, stds, B, T)


def _worker(rank: int, world: int, port: int, out: str) -> None:
    """One process of the 2-process run: join the group, run this
    process's lanes, gather every output through DTensors, place the
    temporal weights on a (1, 2) mesh; rank 0 writes the gathered arrays
    and the placements it saw."""
    import json

    from torch.distributed.tensor import Replicate, Shard

    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.parallel import distributed as dist
    from dragposer_tpu_torch.parallel import mesh as meshlib

    os.environ.update(DRAGPOSER_COORDINATOR=f"127.0.0.1:{port}",
                      DRAGPOSER_NUM_PROCS=str(world),
                      DRAGPOSER_PROC_ID=str(rank))
    dist.initialize(device="cpu")
    mesh = dist.global_mesh()
    assert mesh.shape == {"data": world, "model": 1}
    engine, means, stds, _ = _engine_and_clips_for_worker()
    states, dqs, gp, gr = _lanes(engine, means, stds)
    sl = dist.process_slice(dqs.shape[0])
    local = type(states)(*[x[sl] for x in states])
    _, out_local = engine.run_batch_pipelined(local, dqs[sl], gp[sl], gr[sl],
                                              sync_k=4)
    glob = dist.shard_host_batch(out_local, mesh)
    full = {n: getattr(glob, n).full_tensor().numpy()
            for n in ("latent", "pose", "global_pos", "iterations")}
    tmesh = meshlib.make_mesh(data=1, model=world)
    tparams = loading.load_temporal(MODEL_DIR)[0]
    placed = meshlib.temporal_param_sharding(tparams, tmesh)
    ff1 = placed["enc_layers"][0]["ff1"]["w"]
    ff2 = placed["enc_layers"][0]["ff2"]["w"]
    ln = placed["enc_layers"][0]["ln1"]["g"]
    ok = (list(ff1.placements) == [Replicate(), Shard(0)]
          and list(ff2.placements) == [Replicate(), Shard(1)]
          and list(ln.placements) == [Replicate(), Replicate()]
          and ff1.to_local().shape[0] * world == ff1.shape[0]
          and np.array_equal(ff1.full_tensor().numpy(),
                             tparams["enc_layers"][0]["ff1"]["w"]))
    if rank == 0:
        np.savez(out, **full)
        with open(out + ".json", "w") as f:
            json.dump({"placements_ok": bool(ok), "world": world,
                       "local_lanes": sl.stop - sl.start}, f)
    import torch.distributed

    torch.distributed.destroy_process_group()


def _engine_and_clips_for_worker():
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = chip_smoke.synthetic_bvh(8, seed=9)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    engine, means, stds = tev.build_engine(
        MODEL_DIR, parents, tev.resolve_config("6_trackers"),
        skeleton=Skeleton.build(parents, offsets, bvh.names), device="cpu")
    return engine, means, stds, None


def test_two_processes_match_one(tmp_path):
    port, out = _free_port(), str(tmp_path / "gathered.npz")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for key in ("DRAGPOSER_COORDINATOR", "DRAGPOSER_NUM_PROCS",
                "DRAGPOSER_PROC_ID"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2",
                               str(port), out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    import json

    with open(out + ".json") as f:
        meta = json.load(f)
    assert meta == {"placements_ok": True, "world": 2, "local_lanes": 4}
    got = np.load(out)
    engine, means, stds, _ = _engine_and_clips_for_worker()
    states, dqs, gp, gr = _lanes(engine, means, stds)
    _, ref = engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=4)
    # 4 lanes a process against 8 in one: held as the pipeline lockstep
    # (see test_run_sharded_lane_by_lane), iterations equal
    ref = {n: getattr(ref, n).numpy() for n in got.files}
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    np.testing.assert_allclose(got["latent"], ref["latent"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["global_pos"], ref["global_pos"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["pose"], ref["pose"], rtol=1e-3,
                               atol=2e-3)


def test_no_device_without_a_gpu_raises(monkeypatch):
    """With no GPU visible, a call that names no device raises where it
    once gave a CPU mesh or a gloo group: ``local_devices()``,
    ``make_mesh()`` and ``initialize`` (before it joins any group)."""
    import torch.distributed

    from dragposer_tpu_torch.parallel import distributed as dist
    from dragposer_tpu_torch.parallel import mesh as meshlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (meshlib.local_devices, meshlib.make_mesh,
                 lambda: dist.initialize(f"127.0.0.1:{_free_port()}", 2, 0)):
        with pytest.raises(RuntimeError, match="no GPU is available"):
            call()
    assert not torch.distributed.is_initialized()
    assert meshlib.local_devices("cpu") == [torch.device("cpu")]


def test_initialize_without_settings_is_a_no_op(monkeypatch):
    import torch.distributed

    from dragposer_tpu_torch.parallel import distributed as dist

    for key in ("DRAGPOSER_COORDINATOR", "DRAGPOSER_NUM_PROCS",
                "DRAGPOSER_PROC_ID"):
        monkeypatch.delenv(key, raising=False)
    dist.initialize()
    assert not torch.distributed.is_initialized()
    assert dist.process_slice(8) == slice(0, 8)
    with pytest.raises(RuntimeError, match="initialize"):
        dist.global_mesh()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
