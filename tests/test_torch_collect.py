"""``TickHandle.result``'s copy to the host (``api/handles.py``).

On the CPU each tensor crosses by ``.cpu()``, one blocking read each, and
nothing is pinned: the arrays, ``host.syncs`` and ``collect_s`` are as they
always were.  The card's branch (a pinned block a tensor, asynchronous
copies, one wait) is held here against fakes of the allocator and the
stream; ``tests/test_torch_gpu.py`` runs it on the card.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import KnnSession, ServiceSpec, handles
from repro_torch.data import make_workload

torch.set_num_threads(2)

SIDE = 22_500.0
N = 1500
PINNED = ("collect.pinned", "collect.host_allocs")
# the tensors that cross a tick, by mode: 2 shard counters and the 2 lists,
# or the 2 counters and the sink's 7 aggregates
CROSSING = {"full": 4, "stats": 9}


@pytest.fixture
def traced():
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()


def _ticks(collect, ticks=2):
    """The build and ``ticks`` moves of a CPU session: each tick's result
    taken first on the device, then materialized."""
    spec = ServiceSpec(k=8, window=64, chunk=256, side=SIDE,
                       backend="fused_bucket", collect=collect)
    session = KnnSession(spec, device="cpu")
    world = make_workload(N, "uniform", seed=3, side=SIDE)
    pos = world.positions()
    session.ingest_objects(pos)
    handle = session.register_queries(pos, np.arange(N, dtype=np.int32))
    out = []
    for step in range(ticks + 1):
        if step:
            world.advance()
            pos = world.positions()
            session.ingest_objects(pos)
            session.update_queries(handle, pos)
        h = session.submit()
        dev = h.result(materialize=False)
        want = [t.clone() for t in (dev.shard_candidates, dev.shard_iterations,
                                    *(dev.aggregates or ()))]
        if collect == "full":
            want += [dev.nn_idx.clone(), dev.nn_dist.clone()]
        out.append((want, h.result()))
    return out


def _same(array, tensor):
    want = tensor.numpy()
    return (isinstance(array, np.ndarray) and array.dtype == want.dtype
            and array.shape == want.shape
            and array.tobytes() == want.tobytes())


@pytest.mark.parametrize("collect", sorted(CROSSING))
def test_cpu_collect_copies_each_tensor_by_a_blocking_read(traced, collect):
    """A CPU tick pins nothing: no ``collect.*`` counter, the arrays bit for
    bit the device result's, and ``host.syncs`` the sweep's 2 a pass and its
    last, the finalize's 3, the drain and one a crossing tensor."""
    for t, (want, res) in enumerate(_ticks(collect)):
        counters = res.trace.counters
        assert not set(PINNED) & set(counters)
        got = [res.shard_candidates, res.shard_iterations,
               *(res.aggregates or ())]
        if collect == "full":
            got += [res.nn_idx, res.nn_dist]
            assert res.nn_idx.shape == (N, 8) and res.nn_idx.dtype == np.int32
            assert res.nn_dist.dtype == np.float32
        else:
            assert res.nn_idx is None and res.nn_dist is None
        assert len(got) == CROSSING[collect]
        assert all(_same(a, w) for a, w in zip(got, want))
        assert res.collect_s > 0
        assert res.trace.spans["result.collect"].n == 1
        if t:  # the build tick reads no drift bool
            assert counters["host.syncs"] == (
                2 * counters["sweep.passes"] + 1 + 3 + 1 + CROSSING[collect])


def test_cpu_to_host_is_cpu_numpy_and_off_records_nothing(traced):
    tensors = (torch.arange(6, dtype=torch.int32).reshape(2, 3),
               torch.tensor(float("nan")), torch.tensor([-0.0, 1.5]))
    rec = tracing.open_tick(torch.device("cpu"))
    with tracing.into(rec):
        got = handles._to_host(tensors)
    assert tracing.finish(rec).counters == {"host.syncs": 3}
    assert all(_same(a, t) for a, t in zip(got, tensors))
    tracing.disable()
    totals = dict(tracing.totals().counters)
    handles._to_host(tensors)
    assert tracing.totals().counters == totals


class _Card:
    """Fakes of the card's side of ``_to_host``: source tensors that say
    they are on the card, the caching host allocator (a cache of freed
    blocks by shape and dtype, its ``num_host_alloc``) and the stream."""

    def __init__(self, monkeypatch):
        self.made, self.waits, self.copies, self.free = 0, 0, [], {}
        card = self

        class Source(SimpleNamespace):
            is_cuda = True

        class Block:
            def __init__(self, shape, dtype):
                self.key, self.data = (tuple(shape), dtype), None

            def copy_(self, src, non_blocking=False):
                assert card.waits == 0, "a copy after the wait"
                card.copies.append(non_blocking)
                self.data = src.t.clone()

            def numpy(self):
                assert card.waits == 1, "read before the copies landed"
                return self.data.numpy()

        def empty(shape, dtype=None, pin_memory=False):
            assert pin_memory
            cached = card.free.get((tuple(shape), dtype))
            if cached:
                return cached.pop()
            card.made += 1
            return Block(shape, dtype)

        stream = SimpleNamespace(synchronize=self._wait)
        self.source = lambda t: Source(t=t, shape=t.shape, dtype=t.dtype)
        self.cache = lambda block: card.free.setdefault(block.key, []).append(
            block)
        monkeypatch.setattr(handles.torch, "empty", empty)
        monkeypatch.setattr(handles.torch.cuda, "current_stream",
                            lambda: stream)
        monkeypatch.setattr(handles.torch.cuda, "host_memory_stats",
                            lambda: {"num_host_alloc": card.made})

    def _wait(self):
        self.waits += 1


@pytest.mark.parametrize("cached", [False, True])
def test_card_branch_copies_without_blocking_and_waits_once(
        traced, monkeypatch, cached):
    """Every tensor copied into its own pinned block with
    ``non_blocking=True``, one wait before any array is read; counted: one
    ``host.syncs``, ``collect.pinned`` a tensor, ``collect.host_allocs`` the
    blocks the allocator had to make (none when its cache holds them)."""
    lists = (torch.arange(64, dtype=torch.int32).reshape(16, 4),
             torch.linspace(0, 1, 64).reshape(16, 4),
             torch.tensor([3, 4], dtype=torch.int32))
    card = _Card(monkeypatch)
    if cached:
        for t in lists:
            card.cache(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
        card.made = 0
    rec = tracing.open_tick(torch.device("cpu"))
    with tracing.into(rec):
        got = handles._to_host([card.source(t) for t in lists])
    assert tracing.finish(rec).counters == {
        "host.syncs": 1, "collect.pinned": 3,
        "collect.host_allocs": 0 if cached else 3}
    assert card.copies == [True] * 3 and card.waits == 1
    assert all(_same(a, t) for a, t in zip(got, lists))


def test_card_branch_off_reads_no_allocator_stats(monkeypatch):
    card = _Card(monkeypatch)
    monkeypatch.setattr(handles.torch.cuda, "host_memory_stats",
                        lambda: pytest.fail("stats read with tracing off"))
    totals = dict(tracing.totals().counters)
    t = torch.arange(8, dtype=torch.int32)
    (got,) = handles._to_host([card.source(t)])
    assert _same(got, t) and card.waits == 1
    assert tracing.totals().counters == totals
