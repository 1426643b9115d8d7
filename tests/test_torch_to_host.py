"""The outputs' copy to the host (``engine.to_host``): each lane's prefix
of rows that hold data, packed and streamed through a ring of two chunks
into zeroed arrays, against ``.cpu().numpy()`` bit for bit.

On the CPU the core (``engine._copy_out``) runs on CPU tensors through a
ring of the size each case passes: ragged prefixes, an interior row of
zeros, a lane held only by ``iterations`` or ``loss_rot``, ``-0.0`` in the
padding, lanes of no rows and of all T, every row kept, chunks that cut a
lane's run or hold one row, leaves that are no tensors, a single lane and
a lead the copy leaves to ``.cpu()``, a second call beside the first's
arrays, the zeroed arrays each call allocates, threads sharing one held
ring, a real pipelined pass at ragged lengths, and the ``"to_host"``
record.

On the card (marked ``cuda``, skipped elsewhere), ``engine.to_host``
against ``.cpu().numpy()`` on a 6-tracker ragged pipelined pass, a
4-tracker pass of equal lanes and the beam's winners; two threads on
streams of their own copying at once; one ring a device across calls.
On a GPU machine::

    python -m pytest tests/test_torch_to_host.py -q --noconftest -m cuda
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_pipeline_graph import SYNC_K, _inputs, _setup, _states

torch.set_num_threads(1)
B, T, J, L = 6, 10, 3, 5
LENGTHS = [10, 0, 4, 7, 1, 10]


def _outputs(lengths=LENGTHS, seed=0):
    """A FrameOutput (B, T, ...) of nonzero values within each lane's
    length and zeros past it."""
    from dragposer_tpu_torch.drag.engine import FrameOutput

    g = torch.Generator().manual_seed(seed)
    valid = torch.arange(T)[None] < torch.as_tensor(lengths)[:, None]

    def leaf(*shape, dtype=torch.float32):
        x = (torch.randint(1, 50, (B, T) + shape, generator=g,
                           dtype=torch.int32) if dtype == torch.int32
             else torch.rand((B, T) + shape, generator=g) + 0.5)
        keep = valid.reshape(B, T, *[1] * len(shape))
        return torch.where(keep, x, torch.zeros((), dtype=dtype))

    return FrameOutput(pose=leaf(J * 4), global_pos=leaf(3),
                       iterations=leaf(dtype=torch.int32), loss_pos=leaf(),
                       loss_rot=leaf(), latent=leaf(L))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else \
        a.view(f"u{a.dtype.itemsize}")


def _assert_same(got, out):
    """``got`` equals ``out``'s ``.cpu().numpy()`` bit for bit, leaf by
    leaf; other leaves pass through."""
    assert type(got) is type(out)
    for name, g, x in zip(out._fields, got, out):
        if not torch.is_tensor(x):
            assert g is x, name
            continue
        ref = x.cpu().numpy()
        assert isinstance(g, np.ndarray), name
        assert g.shape == ref.shape and g.dtype == ref.dtype, name
        assert np.array_equal(_bits(g), _bits(ref)), name


def _copy(out, chunk_bytes=1 << 20):
    from dragposer_tpu_torch.drag import engine

    return engine._copy_out(out, engine._HostRing("cpu", chunk_bytes))


def _with(out, **rows):
    """``out`` with the rows ``(lane, frame)`` of leaves set: ``name=(lane,
    frame, value)``."""
    leaves = out._asdict()
    for name, (lane, frame, value) in rows.items():
        x = leaves[name].clone()
        x[lane, frame] = value
        leaves[name] = x
    return type(out)(**leaves)


def _kept(out):
    """Each lane's prefix that holds data, read on the host."""
    lanes, frames = out.iterations.shape
    held = np.zeros((lanes, frames), bool)
    for x in out:
        held |= (_bits(x.cpu().numpy()).reshape(lanes, frames, -1)
                 != 0).any(-1)
    frame = np.arange(1, frames + 1)
    return np.where(held, frame, 0).max(1)


CASES = {
    "ragged": lambda: _outputs(),
    # frame 2 of lane 3 all zeros, inside its prefix
    "interior_zero_row": lambda: _with(
        _outputs(), **{k: (3, 2, 0) for k in
                       ("pose", "global_pos", "iterations", "loss_pos",
                        "loss_rot", "latent")}),
    # lane 2 held past its length by one leaf alone
    "held_by_iterations": lambda: _with(_outputs(), iterations=(2, 8, 3)),
    "held_by_loss_rot": lambda: _with(_outputs(), loss_rot=(2, 9, 0.25)),
    # the sign bit alone in the padding
    "negative_zero": lambda: _with(_outputs(), pose=(1, 6, -0.0),
                                   latent=(4, 9, -0.0)),
    "no_rows": lambda: _outputs([0] * B),
    "every_row_kept": lambda: _outputs([T] * B),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_equals_cpu_numpy(case):
    out = CASES[case]()
    _assert_same(_copy(out), out)


def test_negative_zero_counts_as_data():
    from dragposer_tpu_torch.drag import engine

    out = CASES["negative_zero"]()
    flat = [x.reshape(B, T, -1) for x in out]
    n = engine._kept_prefix(flat, T).numpy()
    assert n[1] == 7 and n[4] == 10
    assert list(n) == list(_kept(out))


# a pose row is 48 B: chunks of 1, 2 and 3 rows, 7 rows (a lane's run of
# 10 cut), and one pose row and a few bytes (two latent rows of 20 B)
@pytest.mark.parametrize("chunk_bytes", [48, 100, 144, 7 * 48, 52])
@pytest.mark.parametrize("case", ["ragged", "every_row_kept",
                                  "held_by_loss_rot"])
def test_chunks_cut_lanes_runs(case, chunk_bytes):
    out = CASES[case]()
    _assert_same(_copy(out, chunk_bytes), out)


def test_leaves_that_are_no_tensors_pass_through():
    from dragposer_tpu_torch.drag.engine import FrameOutput

    out = _outputs()
    mixed = FrameOutput(*out[:3], None, "tag", out.latent)
    got = _copy(mixed, 96)
    _assert_same(got, mixed)
    assert got.loss_pos is None and got.loss_rot == "tag"


@pytest.mark.parametrize("lead", [(T,), (2, 3, T)])
def test_other_leads(lead):
    """A single lane (T, ...) through the ring, and two lane axes (2, 3,
    T, ...), which no output has, by ``.cpu()``."""
    out = _outputs([7, 0, 3, 10, 10, 2])
    shaped = type(out)(*[x[:int(np.prod(lead[:-1]))].reshape(
        lead + x.shape[2:]) for x in out])
    _assert_same(_copy(shaped, 96), shaped)


def test_second_call_leaves_the_first_calls_arrays():
    from dragposer_tpu_torch.drag import engine

    ring = engine._HostRing("cpu", 200)
    first_out, second_out = _outputs(seed=1), _outputs(LENGTHS[::-1], 2)
    first = engine._copy_out(first_out, ring)
    kept = [a.copy() for a in first]
    second = engine._copy_out(second_out, ring)
    _assert_same(second, second_out)
    for a, b in zip(first, kept):
        assert np.array_equal(_bits(a), _bits(b))
    _assert_same(first, first_out)
    assert not any(np.shares_memory(a, b) for a in first for b in second)


def test_each_call_allocates_its_arrays_zeroed():
    """The arrays a call returns are fresh, zeroed and writable, of the
    outputs' shapes and dtypes, past every lane's prefix too."""
    from dragposer_tpu_torch.drag import engine

    ring = engine._HostRing("cpu", 200)
    out = _outputs(seed=3)
    got = [engine._copy_out(out, ring) for _ in range(2)]
    for a, b in zip(*got):
        assert a is not b and not np.shares_memory(a, b)
    for g in got:
        _assert_same(g, out)
        for name, a in zip(out._fields, g):
            assert a.flags.writeable, name
            past = np.arange(T)[None] >= np.asarray(LENGTHS)[:, None]
            assert not a[past].any(), name


def test_threads_share_one_held_ring():
    """More threads than cores copy through one ring, held as ``to_host``
    holds a device's, switching as often as the interpreter can: each
    gets its own outputs, and no two calls share an array."""
    import sys

    from dragposer_tpu_torch import _graphs
    from dragposer_tpu_torch.drag import engine

    holder = _graphs.Holder()
    outs = [_outputs(seed=i) if i % 2 else
            _outputs(LENGTHS[::-1], seed=i) for i in range(12)]
    got, errors = [[] for _ in outs], []

    def job(i):
        try:
            for _ in range(15):
                with holder.hold("cpu", "ring", lambda ring: True,
                                 lambda: engine._HostRing("cpu", 160)) as ring:
                    got[i].append(engine._copy_out(outs[i], ring))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=job, args=(i,))
                   for i in range(len(outs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    arrays = set()
    for out, results in zip(outs, got):
        assert len(results) == 15
        for r in results:
            _assert_same(r, out)
            arrays |= {id(a) for a in r}
    assert len(arrays) == 15 * len(outs) * len(LENGTHS)


@pytest.mark.parametrize("case", ["ragged", "every_row_kept",
                                  "held_by_iterations"])
def test_the_to_host_record(case):
    from dragposer_tpu_torch import _build, tracing

    out = CASES[case]()
    kept = int(_kept(out).sum())
    _build.clear_launch_logs()
    with profile(activities=[ProfilerActivity.CPU]):
        _copy(out, 160)
    (rec,) = _build.launch_log("to_host")
    totals = tracing.counter_totals()
    _build.clear_launch_logs()
    row_bytes = sum(x[0, 0].numel() * x.element_size() for x in out)
    assert rec["rows"] == B * T and rec["kept"] == kept
    assert rec["bytes"] == kept * row_bytes and not rec["plain"]
    assert rec["chunks"] >= (kept > 0) * len(out)
    assert totals["to_host_rows"] == B * T
    assert totals["to_host_kept_rows"] == kept


def test_no_record_without_a_profiler():
    from dragposer_tpu_torch import _build

    _build.clear_launch_logs()
    _copy(_outputs())
    assert _build.launch_log("to_host") == []


def _pass(s, lengths=None):
    """One pipelined pass of a benchmark cell's engine and inputs (``s``,
    ``test_torch_pipeline_graph._setup``): its outputs on the device."""
    _, out = s.engine.run_batch_pipelined(_states(s), *_inputs(s),
                                          sync_k=SYNC_K, lengths=lengths)
    return out


def test_pipelined_pass_keeps_each_lanes_frames():
    """A ragged 6-tracker pass on the CPU: every lane's frames are its
    prefix, and nothing past them."""
    s = _setup("offline_6trk_mixed", 5, 12, "cpu", max_iter=6)
    lengths = torch.as_tensor([12, 3, 7, 1, 9], dtype=torch.int32)
    out = _pass(s, lengths)
    assert list(_kept(out)) == lengths.tolist()
    _assert_same(_copy(out, 4096), out)


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (pinned memory and streams)")
    return "cuda"


def _card_copy(out):
    from dragposer_tpu_torch.drag.engine import to_host

    got = to_host(out)
    torch.cuda.synchronize()
    _assert_same(got, out)
    return got


@pytest.mark.cuda
def test_card_6trk_ragged_pass(card):
    from dragposer_tpu_torch import _build, tracing

    s = _setup("offline_6trk_mixed", 64, 40, card, max_iter=30)
    lengths = np.random.default_rng(3).integers(0, 41, size=64)
    lengths[0] = 40
    out = _pass(s, torch.as_tensor(lengths, dtype=torch.int32,
                                   device=card))
    _build.clear_launch_logs()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _card_copy(out)
    totals = tracing.counter_totals()
    _build.clear_launch_logs()
    assert totals["to_host_rows"] == 64 * 40
    assert totals["to_host_kept_rows"] == int(lengths.sum())


@pytest.mark.cuda
def test_card_4trk_equal_pass(card):
    _card_copy(_pass(_setup("offline_4trk_equal", 64, 40, card,
                            max_iter=30)))


@pytest.mark.cuda
def test_card_beam_winners(card, monkeypatch):
    from dragposer_tpu_torch.drag import engine

    from test_torch_beam_pipelined import _beam, _clips, _engine, _noise

    seen = []
    real = engine.to_host

    def spy(out):
        got = real(out)
        torch.cuda.synchronize()
        _assert_same(got, out)
        seen.append(out.pose.shape)
        return got

    monkeypatch.setattr(engine, "to_host", spy)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        c = _clips(d, (40, 33), "3_trackers", None)
    _beam(_engine(c["engine"], max_iter=20), 8, c["batch"], c["lengths"],
          _noise(2 * 8, 3, seed=4), branch_every=16, survivors=2, sync_k=24)
    assert seen and seen[-1][:2] == (2, 40)


@pytest.mark.cuda
def test_card_two_threads_and_one_ring(card):
    from dragposer_tpu_torch.drag import engine
    from dragposer_tpu_torch.drag.engine import to_host

    outs = [type(o)(*[x.to(card) for x in o])
            for o in (_outputs(seed=5), _outputs(LENGTHS[::-1], 6))]
    to_host(outs[0])
    ring = engine._RINGS[torch.device(card, 0)].slots["ring"]
    errors = []

    def job(out):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(20):
                    _assert_same(to_host(out), out)
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=job, args=(o,)) for o in outs * 2]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors
    assert engine._RINGS[torch.device(card, 0)].slots["ring"] is ring
    assert list(engine._RINGS) == [torch.device(card, 0)]
