"""The rollout on the lanes that can need it (``engine._rollout_where_needed``
fed by the pipeline's count of active lanes), on the CPU, on the
benchmark's configurations at small sizes (the harness's ``Setup``, as
``tests/test_torch_pipeline_graph.py`` makes them).

A pipelined pass equals, bit for bit (``torch.equal``), the same pass with
every rollout on the whole batch (the lane count dropped and the window's
budget at the batch: ``full_batch_rollouts``): the 6-tracker configuration
(window 0) at ragged lengths, and the 4-tracker one (window 16) with its
lanes in phase, so that one window boundary needs more lanes than the
budget.  The rollout records count the lanes K2 ran
(``engine._sub_batch``: whole blocks of 9 lanes for a bound on the
needing lanes, then the batch's last, partial block): at window 0 the
bound is the count of active lanes read at the wait before the block
(the whole batch in the prologue); at window 16, the needing lanes.
``_rollout_where_needed`` alone, given 0, 1, some or all lanes, equals
the full-batch rollout and select bit for bit, K2's calls run on the
sub-batch's rows, and at 0 lanes it runs none; the sub-batch keeps every
lane in a block of its full-batch size and the needing lanes in it.

The card's half (bit for bit against the full batch, K2's lanes, and
``begin`` under ``torch.cuda.set_sync_debug_mode("error")``) is in
``tests/test_torch_pipeline_graph.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_pipeline_graph import (_eager, _equal, _inputs, _k2_rows,
                                       _ragged, _records, _setup, _states,
                                       full_batch_rollouts)

# 24 lanes at window 16 (budget 8), each finishing a frame every block
# (max_iter = sync_k): at frame 16 the nine long lanes need a rollout at once
IN_PHASE = [20, 5] * 9 + [5] * 6


@pytest.fixture(scope="module")
def cpu6():
    """24 lanes: two whole blocks of K2 (9 lanes) and a partial one."""
    torch.set_num_threads(2)
    return _setup("offline_6trk_mixed", 24, 10, "cpu", max_iter=8)


@pytest.fixture(scope="module")
def cpu4():
    torch.set_num_threads(2)
    return _setup("offline_4trk_equal", 24, 20, "cpu", max_iter=4)


def _case(case, cpu6, cpu4):
    if case == "6trk_ragged":
        return cpu6, _ragged(cpu6)
    return cpu4, torch.tensor(IN_PHASE, dtype=torch.int32)


def _sub_lanes(n, B, g=9):
    """K2's rows for a bound ``n`` on the needing lanes of ``B``: ``n`` in
    whole blocks of ``g``, then the partial block, or the whole batch."""
    whole = B - B % g
    body = min(whole, -(-n // g) * g)
    return B if body == whole else body + B - whole


def _lanes_given(monkeypatch):
    """The ``lanes`` each ``_Block.begin`` is given, in order."""
    from dragposer_tpu_torch.drag import pipeline

    given, begin = [], pipeline._Block.begin

    def spy(self, c, frame, lanes):
        given.append(lanes)
        return begin(self, c, frame, lanes)

    monkeypatch.setattr(pipeline._Block, "begin", spy)
    return given


@pytest.mark.parametrize("case", ["6trk_ragged", "4trk_in_phase"])
def test_sub_batch_equals_full_batch(cpu6, cpu4, case, monkeypatch):
    s, lengths = _case(case, cpu6, cpu4)
    states = _states(s)
    got = _eager(s, states, _inputs(s), lengths)
    with monkeypatch.context() as m:
        full_batch_rollouts(m)
        ref = _eager(s, states, _inputs(s), lengths)
    _equal(got, ref)


@pytest.mark.parametrize("case", ["6trk_ragged", "4trk_in_phase"])
def test_rollout_records_count_the_lanes(cpu6, cpu4, case, monkeypatch):
    """Window 0: the prologue's record has every lane, each block's the
    count ``begin`` was given, which is the lanes active after the block
    before (its record's ``frame < limit``), as a sub-batch's bound.
    Window 16: the needing lanes are the bound, one boundary's more than
    the budget."""
    from dragposer_tpu_torch.drag import engine as eng

    s, lengths = _case(case, cpu6, cpu4)
    B = lengths.shape[0]
    given = _lanes_given(monkeypatch)
    with _records() as logs:
        _eager(s, _states(s), _inputs(s), lengths)
    rollouts = logs["rollout"]
    lanes = [r["lanes"] for r in rollouts]
    assert lanes[0] == B and min(lanes) < B
    if case == "6trk_ragged":
        assert given == [int((r["frame"] < lengths).sum())
                         for r in rollouts[:-1]]
        assert lanes[1:] == [_sub_lanes(n, B) for n in given]
    else:
        budget = eng.rollout_lane_budget(B, s.engine.hyper
                                         .temporal_future_window)
        needs = [int(r["need"].sum()) for r in rollouts]
        assert lanes == [_sub_lanes(n, B) for n in needs]
        assert budget < needs[1] and lanes[1] < B
    assert all(int(r["need"].sum()) <= r["lanes"] for r in rollouts)


def _roll_inputs(setup, seed):
    from dragposer_tpu_torch.drag import engine as eng

    gen = torch.Generator().manual_seed(seed)
    state = _states(setup)
    state = state._replace(**{
        name: torch.randn(getattr(state, name).shape, generator=gen)
        for name in ("latent_buffer", "displacement_buffer",
                     "heights_buffer")})
    return eng._rollout_inputs(state, setup.engine.hyper), gen


# (cell, lanes given, needing lanes), 24 lanes (blocks of 9, 9 and 6):
# window 0 takes ``lanes``; window 16 counts ``need`` on the host
UNIT = [("offline_6trk_mixed", 0, []), ("offline_6trk_mixed", 1, [17]),
        ("offline_6trk_mixed", 9, [1, 4, 9, 23]),
        ("offline_6trk_mixed", 10, list(range(0, 20, 2))),
        ("offline_6trk_mixed", 24, [0, 2, 5]),
        ("offline_4trk_equal", None, []), ("offline_4trk_equal", None, [7]),
        ("offline_4trk_equal", None, list(range(2, 20, 2))),
        ("offline_4trk_equal", None, list(range(11))),
        ("offline_4trk_equal", None, list(range(24)))]


@pytest.mark.parametrize("cell, lanes, needing", UNIT)
def test_rollout_where_needed_equals_full_batch(cpu6, cpu4, cell, lanes,
                                                needing, monkeypatch):
    """The rollout's buffer equals the full-batch rollout with a select bit
    for bit; K2 runs on the sub-batch for ``lanes`` at window 0 (none at 0
    lanes) and for the needing lanes at window 16."""
    from dragposer_tpu_torch.drag import engine as eng

    s = cpu6 if cell == "offline_6trk_mixed" else cpu4
    e = s.engine
    roll, gen = _roll_inputs(s, 9)
    B = roll[-1].shape[0]
    need = torch.zeros(B, dtype=torch.bool)
    need[needing] = True
    full = eng._temporal_rollout_core_T(e.model, e.hyper, e.tparam, *roll)
    tbuf = torch.randn(full.shape, generator=gen)
    rows = _k2_rows(monkeypatch)
    got = eng._rollout_where_needed(e.model, e.hyper, e.tparam, *roll, need,
                                    tbuf, lanes=lanes)
    assert torch.equal(got, torch.where(need[:, None, None], full, tbuf))
    steps = e.hyper.temporal_future_window // e.hyper.sample_step + 1
    n = len(needing) if lanes is None else lanes
    assert rows == [_sub_lanes(n, B)] * (steps if n else 0)
    if not n:
        assert got is tbuf


def test_needed_first_is_a_stable_partition():
    from dragposer_tpu_torch.drag import engine as eng

    rng = np.random.default_rng(4)
    for B in (1, 7, 64):
        need = torch.as_tensor(rng.random(B) < 0.3)
        order = [i for i in range(B) if need[i]] + [i for i in range(B)
                                                    if not need[i]]
        for m in {0, int(need.sum()), B}:
            assert eng._needed_first(need, m).tolist() == order[:m]


@pytest.mark.parametrize("B", [8, 9, 24, 64, 8192])
def test_sub_batch_keeps_the_block_sizes(B):
    """Every needing lane is in the sub-batch; its whole blocks are lanes of
    the whole batch's whole blocks, the needing first in lane order; the
    partial block follows as it is, so each lane's block has its size in
    the whole batch."""
    from dragposer_tpu_torch.drag import engine as eng

    g, rng = 9, np.random.default_rng(B)
    whole = B - B % g
    for share in (0.01, 0.1, 0.5):
        need = torch.as_tensor(rng.random(B) < share)
        need[rng.integers(B)] = True
        n = int(need.sum())
        idx = eng._sub_batch(need, n, g)
        if _sub_lanes(n, B, g) == B:
            assert idx is None
            continue
        idx = idx.tolist()
        assert len(idx) == _sub_lanes(n, B, g) and len(set(idx)) == len(idx)
        assert set(np.flatnonzero(need.numpy())) <= set(idx)
        body = idx[:len(idx) - (B - whole)]
        assert len(body) % g == 0 and max(body) < whole
        assert idx[len(body):] == list(range(whole, B))
        assert body[:int(need[:whole].sum())] == [
            i for i in range(whole) if need[i]]
