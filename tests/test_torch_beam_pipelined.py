"""The batched hypothesis beam on the pipelined path
(``drag/hypotheses.run_hypotheses_batched``: each chunk one
``run_batch_pipelined``, the selection and the re-seeding on the device,
only the winners copied out), on the CPU, on seeded synthetic clips under
the 3-tracker configuration.

* With R = 1 the beam is one ``run_batch_pipelined`` over the whole clip,
  bit for bit, at window 16 and at window 0: chunks of 8 frames (a
  window's phase carried across them), the last padded, ragged files.
* With the same draws it keeps the anchor beam's parents
  (``run_hypotheses``) wherever the cumulative losses it ranks are more
  than 1e-6 apart, and its winners' lineages agree with the anchor's
  within ``chip_smoke``'s bounds of the anchor against the pipeline.
* The back-trace on the device equals the host's lineage lists on the same
  outputs and parent tables, and its cumulative losses the host's rule; a
  chunk followed by a selection keeps its survivors' rows alone.
* Only F × T frames reach the host (the ``"beam"`` records), and the beam
  opens its spans.
* Two threads sharing one engine's beam each get what they get alone.
* The benchmark's judge of the beam (``benchmark/reference/beam.py``) at a
  tiny traffic of the cell's configuration passes the cell's limits; each
  planted fault fails them.

Four cases, marked ``cuda``, run on the card: R = 1 chunked against
unchunked bit for bit, no block graph captured by a second call, two
threads on streams of their own sharing one engine's beam (as the daemon's
jobs share a cached engine), each getting what it gets alone, and
``eval_drag --batch --config 3_trackers`` launching K1 and K2 and no plain
twin.  On the GPU machine::

    python -m pytest tests/test_torch_beam_pipelined.py -q --noconftest -m cuda
"""

import contextlib
import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(2)
MODEL_DIR = "models/model_dancedb_example"
# the stop rule never ends a frame before max_iter
FIXED = dict(stop_eps_pos=0.0, stop_eps_rot=0.0, min_loss_incr=-1e9)
CELL = "offline_3trk_beam"


def _clips(directory, n_frames, config, device):
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.ops.topology import Skeleton

    files = chip_smoke.write_synthetic_clips(directory, n_frames, seed=9)
    bvhs = [BVH().load(f) for f in files]
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvhs[0])
    sk = Skeleton.build(parents, offsets, bvhs[0].names)
    te, means, stds = tev.build_engine(MODEL_DIR, parents,
                                       tev.resolve_config(config),
                                       skeleton=sk, device=device)
    T = max(n_frames)

    def pad(x, n):
        return np.concatenate((x[:n], np.repeat(x[n - 1:n], T - n, 0)))

    norms = [tev._encode(f, sk, means, stds) for f in files]
    dqs, gp, gr = (np.stack([pad(getattr(n, k), len(n.dqs))
                             for _, _, n in norms])
                   for k in ("dqs", "global_pos", "global_rot"))
    h0 = np.stack([m.heights[0] for _, m, _ in norms])
    return dict(engine=te, means=means, stds=stds, skeleton=sk, bvhs=bvhs,
                files=files, batch=(dqs, gp, gr, h0),
                lengths=np.asarray([len(n.dqs) for _, _, n in norms]))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _clips(str(tmp_path_factory.mktemp("beam")), (24, 20),
                  "3_trackers", "cpu")


def _engine(te, **hyper):
    e = copy.copy(te)
    e.hyper = te.hyper._replace(**hyper)
    return e


def _noise(n_lanes, n_draws, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_lanes, 24)).astype(np.float32),
            rng.standard_normal((n_draws, n_lanes, 24)).astype(np.float32))


def _beam(e, R, batch, lengths, noise, **kw):
    from dragposer_tpu_torch.drag import hypotheses

    dqs, gp, gr, h0 = batch
    init, eps = noise
    return hypotheses.run_hypotheses_batched(
        e, None, R, dqs, gp, gr, h0, dqs[:, 0][:, :, None], lengths=lengths,
        init_noise=init, resample_noise=eps, **kw)


def _one_pipelined_run(e, batch, lengths, init):
    from dragposer_tpu_torch.drag.engine import to_host

    dqs, gp, gr, h0 = batch
    states = e.init_state(None, dqs[:, 0][:, :, None], gp[:, 0], gr[:, 0],
                          h0, noise=init)
    _, out = e.run_batch_pipelined(states, dqs, gp, gr, sync_k=24,
                                   lengths=lengths)
    return to_host(out)


def _assert_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


@pytest.mark.parametrize("window", [16, 0])
def test_one_hypothesis_is_one_pipelined_run(setup, window):
    e = _engine(setup["engine"], temporal_future_window=window, max_iter=12)
    noise = _noise(2, 0, seed=3)
    out, cum = _beam(e, 1, setup["batch"], setup["lengths"], noise,
                     branch_every=8, sync_k=24)
    assert cum.shape == (2, 1) and cum.dtype == np.float64
    _assert_equal(out, _one_pipelined_run(e, setup["batch"],
                                          setup["lengths"], noise[0]))


def _mpjpe(setup, pose, global_pos, f):
    """MPJPE of one reconstruction (T, ...) of file ``f``."""
    from dragposer_tpu_torch import export, metrics

    n = int(setup["lengths"][f])
    rec = export.result_to_bvh(np.asarray(pose[:n]), setup["means"],
                               setup["stds"], setup["bvhs"][f],
                               setup["skeleton"],
                               global_pos=np.asarray(global_pos[:n]),
                               are_root_rot_incr=False)
    gt = copy.deepcopy(setup["bvhs"][f])
    gt.rotations, gt.positions = gt.rotations[:n], gt.positions[:n]
    return metrics.positional_error(gt, rec)[0]


@pytest.mark.parametrize("hyper", [dict(FIXED, max_iter=5),
                                   dict(max_iter=100)],
                         ids=["fixed_steps", "stop_rule"])
def test_parents_and_lineages_match_the_anchor_beam(setup, hyper):
    from dragposer_tpu_torch.drag import hypotheses

    e = _engine(setup["engine"], **hyper)
    R, K, every, T = 4, 2, 8, 24
    dqs, gp, gr, h0 = setup["batch"]
    batch = (dqs[:, :T], gp[:, :T], gr[:, :T], h0)
    init, eps = _noise(2 * R, 2, seed=11)
    kw = dict(branch_every=every, sigma=0.25, survivors=K)
    out, _, chunks = _beam(e, R, batch, np.full(2, T), (init, eps),
                           sync_k=24, return_chunks=True, **kw)
    checked = 0
    anchor_it, anchor_mpjpe = [], []
    for f in range(2):
        lanes = slice(f * R, (f + 1) * R)
        a_out, a_par, a_sc, _ = hypotheses.run_hypotheses(
            e, None, R, dqs[f, :T], gp[f, :T], gr[f, :T], h0[f],
            dqs[f, 0][:, None], init_noise=init[lanes],
            resample_noise=eps[:, lanes], return_all=True, **kw)
        cum = np.zeros(R)
        for c, chunk in enumerate(chunks[:-1]):
            cum = cum + a_sc[c] * ((chunk.hi - chunk.lo) / T)
            ranked = np.sort(cum)[:K + 1]
            if np.all(np.diff(ranked) > 1e-6 * np.abs(ranked[1:])):
                np.testing.assert_array_equal(
                    chunk.parent.view(2, R)[f].numpy() - f * R, a_par[c])
                checked += 1
            cum = cum[a_par[c]]
        cum = cum + a_sc[-1] * ((chunks[-1].hi - chunks[-1].lo) / T)
        best = int(np.argmin(cum))
        anchor_it.append(a_out.iterations[best].mean())
        anchor_mpjpe.append(_mpjpe(setup, a_out.pose[best],
                                   a_out.global_pos[best], f))
    assert checked >= 1
    it = float(np.asarray(out.iterations).mean())
    assert abs(float(np.mean(anchor_it)) - it) \
        <= chip_smoke.ANCHOR_ITER_REL * it
    mpjpe = np.mean([_mpjpe(setup, out.pose[f], out.global_pos[f], f)
                     for f in range(2)])
    assert abs(float(np.mean(anchor_mpjpe)) - mpjpe) \
        <= chip_smoke.ANCHOR_MPJPE_M


def test_device_back_trace_is_the_host_bookkeeping(setup):
    e = _engine(setup["engine"], max_iter=8)
    F, R, K = 2, 4, 2
    lengths = setup["lengths"]
    out, cum, chunks = _beam(e, R, setup["batch"], lengths,
                             _noise(F * R, 2, seed=5), branch_every=8,
                             survivors=K, sigma=0.5, sync_k=24,
                             return_chunks=True)
    T = setup["batch"][0].shape[1]
    hist = [[[] for _ in range(R)] for _ in range(F)]
    host_cum = np.zeros((F, R))
    n_lens = np.maximum(np.repeat(lengths, R).astype(np.float64), 1.0)
    for i, c in enumerate(chunks):
        # the rows the chunk kept: a selection's survivors, in their order
        # of rank; at the last chunk every lane
        row = c.row.numpy()
        lanes = np.flatnonzero(row >= 0)[np.argsort(row[row >= 0])]
        assert list(row[lanes]) == list(range(len(lanes)))
        if i + 1 < len(chunks):
            assert len(lanes) == F * K
            assert set(lanes) == set(c.parent.numpy())
        else:
            np.testing.assert_array_equal(lanes, np.arange(F * R))
        o = [np.asarray(x)[:, :c.hi - c.lo] for x in c.out]
        valid = np.arange(c.lo, c.hi)[None] < lengths[:, None]
        w = np.repeat(valid, R, axis=0).astype(np.float64)
        n_valid = w.sum(axis=1)
        score = c.score.numpy()
        np.testing.assert_allclose(
            score[lanes], ((o[3] * w[lanes]).sum(axis=1)
                           + (o[4] * w[lanes]).sum(axis=1))
            / np.maximum(n_valid[lanes], 1.0), rtol=1e-12)
        host_cum = host_cum + (score * (n_valid / n_lens)).reshape(F, R)
        for f in range(F):
            for j in range(R):
                r = row[f * R + j]
                hist[f][j].append(None if r < 0 else [a[r] for a in o])
        if i + 1 < len(chunks):
            order = np.argsort(host_cum, axis=1, kind="stable")
            parent = np.stack([order[:, j % K] for j in range(R)], axis=1)
            np.testing.assert_array_equal(
                c.parent.view(F, R).numpy() % R, parent)
            hist = [[list(hist[f][p]) for p in parent[f]] for f in range(F)]
            host_cum = np.take_along_axis(host_cum, parent, axis=1)
    np.testing.assert_allclose(cum, host_cum, rtol=1e-12)
    for f in range(F):
        won = hist[f][int(host_cum[f].argmin())]
        for k, leaf in enumerate(out):
            np.testing.assert_array_equal(
                leaf[f], np.concatenate([x[k] for x in won], axis=0))
    assert out.latent.shape == (F, T, 24)


def test_only_the_winners_reach_the_host(setup):
    from torch.profiler import ProfilerActivity, profile

    from dragposer_tpu_torch import _build

    e = _engine(setup["engine"], **FIXED, max_iter=1)
    F, R, T = 2, 4, setup["batch"][0].shape[1]
    _build.clear_launch_logs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, _ = _beam(e, R, setup["batch"], setup["lengths"],
                       _noise(F * R, 2, seed=1), branch_every=8,
                       survivors=2, sync_k=1)
    log = _build.launch_log("beam")
    _build.clear_launch_logs()
    assert [(r["lo"], r["hi"]) for r in log] == [(0, 8), (8, 16), (16, 24)]
    assert all(r["files"] == F and r["hypotheses"] == R
               and r["survivors"] == 2 for r in log)
    assert sum(r["host_lanes"] * (r["hi"] - r["lo"]) for r in log) == F * T
    assert out.pose.shape[:2] == (F, T)
    names = {ev.name for ev in prof.events()}
    assert {"dragposer.beam", "dragposer.beam.chunk",
            "dragposer.beam.select", "dragposer.beam.emit",
            "dragposer.pipeline"} <= names


def _two_threads(e, batch, lengths, rounds, **kw):
    """Two jobs (the files in turn and swapped, draws of their own) run the
    beam on ``e`` at once, each thread on a stream of its own on the card,
    ``rounds`` times: each must get what it gets alone."""
    swapped = tuple(x[::-1].copy() for x in batch)
    jobs = [(batch, lengths, _noise(2 * 8, 3, seed=6)),
            (swapped, lengths[::-1].copy(), _noise(2 * 8, 3, seed=7))]
    alone = [_beam(e, 8, *job, **kw)[0] for job in jobs]
    cuda = e.device.type == "cuda"

    def job(i, got):
        with (torch.cuda.stream(torch.cuda.Stream()) if cuda
              else contextlib.nullcontext()):
            got[i] = _beam(e, 8, *jobs[i], **kw)[0]
            if cuda:
                torch.cuda.current_stream().synchronize()

    for _ in range(rounds):
        got = [None, None]
        threads = [threading.Thread(target=job, args=(i, got))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for a, b in zip(alone, got):
            _assert_equal(a, b)


def test_two_threads_share_one_engines_beam(setup):
    _two_threads(_engine(setup["engine"], max_iter=4), setup["batch"],
                 setup["lengths"], rounds=1, branch_every=8, survivors=2,
                 sync_k=24)


def _small_cell():
    from benchmark import harness

    c = harness.cell(CELL)
    traffic = dict(c.traffic, files=2, min_frames=24, max_frames=24,
                   pool_clips=2, pool_frames=64, check_files=1,
                   check_lanes=3)
    config = dict(c.config, search=dict(c.config["search"], restarts=4,
                                        survivors=2, branch_every=8))
    return dataclasses.replace(c, traffic=traffic, config=config)


@pytest.fixture(scope="module")
def judged():
    """The judge's numbers for one pass of a tiny traffic (2 files × 24
    frames, 4 hypotheses, 2 survivors, chunks of 8) of the cell's
    configuration on the CPU, with what they were read from."""
    from benchmark.drivers import offline_beam

    cell, seed = _small_cell(), 2 ** 33 + 5
    s = offline_beam.Setup(cell.config, cell.traffic, seed, "cpu")
    result = s.one_pass()
    check, follow, files = offline_beam.sample(s, result, seed)
    kept = offline_beam.record(s, result, files)
    frame, gaps = offline_beam.judged(cell, kept, check, follow, s.search,
                                      s.hyper, s.offsets, "cpu")
    return dict(cell=cell, kept=kept, check=check, follow=follow,
                frame=frame, gaps=gaps)


def _failed(gaps: dict) -> list:
    from benchmark import harness

    lim = harness.load_json(harness.HERE, "limits", CELL + ".json")
    return [k for k, v in lim.items() if k in gaps and not gaps[k] <= v]


def test_the_judge_passes_the_program(judged):
    from benchmark import harness

    lim = harness.load_json(harness.HERE, "limits", CELL + ".json")
    assert set(lim) <= set(judged["gaps"])
    assert _failed(judged["gaps"]) == []
    assert judged["gaps"]["emit_gap"] == 0.0


@pytest.mark.parametrize("fault", ["quarter_of_lanes", "swapped_winner",
                                   "dropped_move", "reversed_selection",
                                   "no_reseeding"])
def test_the_judge_fails_each_planted_fault(judged, fault):
    from benchmark.drivers import offline_batch, offline_beam
    from benchmark.reference import beam

    kept, check, frame = judged["kept"], judged["check"], judged["frame"]
    K = 2
    if fault in offline_beam.FAULTS:
        gaps = beam.check_beam(frame, offline_beam.FAULTS[fault](
            kept, check, K), check, 0.25, K)
    else:
        f = torch.as_tensor([x[0] for x in judged["follow"]])
        last = torch.as_tensor([x[1] for x in judged["follow"]])
        inp, got, jump = beam.follow_lineages(frame, kept, f, last, 0.25, K)
        if fault == "quarter_of_lanes":
            got = offline_batch.FAULTS[fault](got, inp)
        else:       # the judge itself without the re-seeding it expects
            assert bool(jump.any())
            jump = torch.zeros_like(jump)
        gaps = beam.follow_jumping(frame, inp, got, jump)
    assert _failed(gaps)


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels have no CPU mode)")
    return _clips(str(tmp_path_factory.mktemp("beam_card")), (40, 33),
                  "3_trackers", None)


@pytest.mark.cuda
def test_card_one_hypothesis_is_one_pipelined_run(card):
    e = _engine(card["engine"], max_iter=30)
    noise = _noise(2, 0, seed=3)
    out, _ = _beam(e, 1, card["batch"], card["lengths"], noise,
                   branch_every=16, sync_k=24)
    _assert_equal(out, _one_pipelined_run(e, card["batch"],
                                          card["lengths"], noise[0]))


@pytest.mark.cuda
def test_card_second_call_captures_no_block_graph(card):
    from torch.profiler import ProfilerActivity, profile

    from dragposer_tpu_torch import _build, tracing

    e = card["engine"]
    noise = _noise(2 * 8, 3, seed=4)
    kw = dict(branch_every=16, survivors=2, sync_k=24)
    first, _ = _beam(e, 8, card["batch"], card["lengths"], noise, **kw)
    _build.clear_launch_logs()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        again, _ = _beam(e, 8, card["batch"], card["lengths"], noise, **kw)
        torch.cuda.synchronize()
    totals = tracing.counter_totals()
    _build.clear_launch_logs()
    assert totals["pipeline_graph_captures"] == 0
    assert totals["pipeline_graph_replays"] == totals["pipeline_blocks"] > 0
    _assert_equal(first, again)


@pytest.mark.cuda
def test_card_two_threads_share_one_engines_beam(card):
    _two_threads(card["engine"], card["batch"], card["lengths"], rounds=3,
                 branch_every=16, survivors=2, sync_k=24)


@pytest.mark.cuda
def test_card_eval_drag_beam_launches_k1_and_k2(card, tmp_path, capsys):
    from dragposer_tpu_torch.cli import eval_drag as tev

    chip_smoke.reset_kernel_counts()
    res = tev.main([MODEL_DIR, *card["files"], "--config", "3_trackers",
                    "--batch", "--branch-every", "16", "--save-dir",
                    str(tmp_path)])
    counts = chip_smoke.kernel_counts()
    assert "hypotheses:" in capsys.readouterr().out
    assert len(res) == 2 and np.isfinite(res).all()
    assert counts["K1"] > 0 and counts["K2"] > 0
    assert counts["K1_plain"] == 0 and counts["K2_plain"] == 0
