"""The port's CUDA-graph rules (``dragposer_tpu_torch/_graphs.py``) on the
CPU, with ``torch.cuda``'s events, streams and graphs faked by
``monkeypatch`` (their fakes log, in order, what is done with them).

``Holder.hold``, as the anchor uses it (a slot a lane count) and as the
pipeline does (one slot): the caller's stream waits on the ``released``
event before the graph is used; a graph made anew comes after a host wait
on that event and after the old graph is dropped; ``released`` is recorded
on the caller's stream on exit, even when the body raises; a slot's graph
is kept while ``matches`` holds; one thread holds at a time.
``capture``: every function runs once on the side stream, in order, the
current stream waits on it, then each is captured there in the
``thread_local`` mode.

``fake_cuda`` and ``eager_capture`` also serve the CPU halves of
``tests/test_torch_anchor_graph.py`` and ``tests/test_torch_pipeline_graph.py``.
"""

import contextlib
import threading
import types
import weakref

import pytest
import torch

from dragposer_tpu_torch import _graphs


class _Stream:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def wait_event(self, event):
        self.log.append(("wait", self.name, event))

    def wait_stream(self, other):
        self.log.append(("wait_stream", self.name, other.name))

    def __repr__(self):
        return self.name


def fake_cuda(monkeypatch) -> types.SimpleNamespace:
    """``torch.cuda.Event``, ``current_stream`` and ``device`` faked: the
    returned namespace's ``log`` holds ``("wait", stream, event)``,
    ``("sync", event)`` and ``("record", event, stream)``; ``current`` is
    the stream ``current_stream`` gives (one a thread, named by
    ``use(name)``)."""
    log = []
    local = threading.local()

    class Event:
        def synchronize(self):
            log.append(("sync", self))

        def record(self, stream):
            log.append(("record", self, stream.name))

    def current_stream(device=None):
        if not hasattr(local, "stream"):
            local.stream = _Stream(log, "s0")
        return local.stream

    def use(name):
        local.stream = _Stream(log, name)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return types.SimpleNamespace(log=log, use=use)


def eager_capture(monkeypatch) -> list:
    """``_graphs.capture`` as eager runs: each function runs once (the
    warm-up), and its "graph" replays it.  Returns the list of captures
    made (each a tuple of the functions)."""
    captures = []

    def capture(device, *fns):
        captures.append(fns)
        for fn in fns:
            fn()
        return [types.SimpleNamespace(replay=fn) for fn in fns]

    monkeypatch.setattr(_graphs, "capture", capture)
    return captures


class _Graph:
    def __init__(self, log, slot, key):
        self.slot, self.key = slot, key
        log.append(("make", slot, key))
        weakref.finalize(self, log.append, ("drop", slot, key))


def _hold(holder, fake, slot, key, body=None):
    """One hold of ``slot`` by a caller wanting ``key``; the body logs its
    use of the graph (and runs ``body``)."""
    with holder.hold("cuda", slot, lambda g: g.key == key,
                     lambda: _Graph(fake.log, slot, key)) as g:
        fake.log.append(("use", g.slot, g.key))
        if body is not None:
            body()


# (slot, key) a hold; the anchor keeps a slot a lane count, the block one
USES = {
    "anchor": [(5, "a"), (3, "a"), (5, "a"), (5, "b"), (3, "a"), (5, "b")],
    "block": [("block", "a"), ("block", "a"), ("block", "b"),
              ("block", "a")],
}


def _expected(calls, released):
    """The log the holder's rules give for ``calls``, one stream."""
    log, slots = [], {}
    for slot, key in calls:
        log.append(("wait", "s0", released))
        if slots.get(slot) != key:
            log.append(("sync", released))
            if slot in slots:
                log.append(("drop", slot, slots[slot]))
            log.append(("make", slot, key))
            slots[slot] = key
        log += [("use", slot, key), ("record", released, "s0")]
    return log, slots


@pytest.mark.parametrize("use", sorted(USES))
def test_hold_orders_wait_recapture_and_record(monkeypatch, use):
    """The caller's stream waits on ``released`` before every use; a graph
    made anew follows the host's wait and the old graph's drop; each hold
    records ``released`` on exit; a slot keeps its graph while ``matches``
    holds."""
    fake = fake_cuda(monkeypatch)
    holder = _graphs.Holder()
    for slot, key in USES[use]:
        old = (weakref.ref(holder.slots[slot]) if slot in holder.slots
               else None)
        same = old is not None and old().key == key
        _hold(holder, fake, slot, key)
        if same:
            assert holder.slots[slot] is old()
        else:
            assert old is None or old() is None
    released = holder.released
    expected, slots = _expected(USES[use], released)
    assert fake.log == expected
    assert {s: g.key for s, g in holder.slots.items()} == slots


@pytest.mark.parametrize("use", sorted(USES))
def test_released_is_recorded_when_the_body_raises(monkeypatch, use):
    """A body that raises still records ``released`` on its stream and
    lets go of the lock; the next holder's stream waits on that event, and
    the graph is kept."""
    fake = fake_cuda(monkeypatch)
    holder = _graphs.Holder()
    slot, key = USES[use][0]

    def fail():
        raise ValueError("in the body")

    with pytest.raises(ValueError, match="in the body"):
        _hold(holder, fake, slot, key, body=fail)
    released = holder.released
    assert fake.log[-1] == ("record", released, "s0")
    assert not holder.lock.locked()
    graph = holder.slots[slot]
    fake.use("s1")
    _hold(holder, fake, slot, key)
    assert holder.slots[slot] is graph
    assert fake.log[-3:] == [("wait", "s1", released), ("use", slot, key),
                             ("record", released, "s1")]


def test_the_next_stream_waits_on_the_last_holders_record(monkeypatch):
    """Two callers on two streams: each waits on the event the other
    recorded, one ``released`` event for the holder."""
    fake = fake_cuda(monkeypatch)
    holder = _graphs.Holder()
    for name in ("s1", "s2", "s1"):
        fake.use(name)
        _hold(holder, fake, 5, "a")
    ev = holder.released
    waits = [e for e in fake.log if e[0] in ("wait", "record")]
    assert waits == [("wait", "s1", ev), ("record", ev, "s1"),
                     ("wait", "s2", ev), ("record", ev, "s2"),
                     ("wait", "s1", ev), ("record", ev, "s1")]


def test_one_thread_holds_at_a_time(monkeypatch):
    """A second thread's hold waits until the first has recorded
    ``released``: the uses never overlap (each join bounded)."""
    fake = fake_cuda(monkeypatch)
    holder = _graphs.Holder()
    inside = threading.Event()
    leave = threading.Event()

    def first():
        fake.use("s1")
        _hold(holder, fake, "block", "a",
              body=lambda: (inside.set(), leave.wait(10)))

    def second():
        fake.use("s2")
        _hold(holder, fake, "block", "a")

    t1 = threading.Thread(target=first)
    t1.start()
    assert inside.wait(10)
    t2 = threading.Thread(target=second)
    t2.start()
    t2.join(0.2)
    assert t2.is_alive()     # blocked on the lock
    leave.set()
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    ev = holder.released
    order = [e for e in fake.log if e[0] in ("wait", "use", "record")]
    assert order == [("wait", "s1", ev), ("use", "block", "a"),
                     ("record", ev, "s1"), ("wait", "s2", ev),
                     ("use", "block", "a"), ("record", ev, "s2")]


def test_capture_warms_every_function_then_captures_each(monkeypatch):
    """``capture``: the side stream waits on the current one, every
    function runs once on it in order, the current stream waits on the
    side one, then each function is captured on the side stream in the
    ``thread_local`` mode, one graph each, in order."""
    fake = fake_cuda(monkeypatch)
    log = fake.log
    streams = []

    def new_stream(device):
        streams.append(_Stream(log, f"side{len(streams)}"))
        return streams[-1]

    @contextlib.contextmanager
    def on(stream):
        log.append(("on", stream.name))
        yield
        log.append(("off", stream.name))

    class Graph:
        pass

    @contextlib.contextmanager
    def graph(g, stream, capture_error_mode):
        log.append(("capture", g, stream.name, capture_error_mode))
        yield
        log.append(("end", g))

    monkeypatch.setattr(torch.cuda, "Stream", new_stream)
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    fns = [lambda n=n: log.append(("run", n)) for n in range(2)]
    got = _graphs.capture("cuda", *fns)
    assert len(streams) == 1 and len(got) == 2
    g0, g1 = got
    assert log == [
        ("wait_stream", "side0", "s0"), ("on", "side0"), ("run", 0),
        ("run", 1), ("off", "side0"), ("wait_stream", "s0", "side0"),
        ("capture", g0, "side0", "thread_local"), ("run", 0), ("end", g0),
        ("capture", g1, "side0", "thread_local"), ("run", 1), ("end", g1)]
