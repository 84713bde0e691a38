"""``repro_torch.tracing``: the spans and counters inside a session's tick.

Off, a tick makes no record, no profiler range and no CUDA event, and its
result carries no trace.  On, each span lands in its tick under its parent,
self time never passes host time, the sweep's counters agree with B1's
launches and the blocking reads, and the lists and counters of every tick
are bit for bit those of tracing off.  The ``gpu`` test times the device
spans on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tracing.py
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.data import make_workload
from repro_torch.kernels import fused_scan as tfs

torch.set_num_threads(2)

SIDE = 22_500.0
N = 1500

# span -> its parent, as the tick's path opens them (single plan)
PARENTS = {
    "hand_in.objects": None,
    "hand_in.queries": None,
    "submit": None,
    "submit.stage": "submit",
    "refresh": "submit",
    "plan.sort": "submit",
    "sweep": "submit",
    "sweep.pass": "sweep",
    "sweep.sync": "sweep.pass",
    "sweep.scan": "sweep.pass",
    "sweep.nav": "sweep.pass",
    "plan.unsort": "submit",
    "result.finalize": None,
    "result.collect": None,
}
DEVICE_SPANS = ("refresh", "plan.sort", "sweep", "sweep.scan", "plan.unsort",
                "result.collect")


@pytest.fixture
def traced():
    """Tracing on for one test, off after it whatever happens."""
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()


def _spec(**kw):
    return ServiceSpec(**{"k": 8, "window": 64, "chunk": 256, "side": SIDE,
                          **kw})


def _world(dist="uniform", seed=3):
    return make_workload(N, dist, seed=seed, side=SIDE)


def _ticks(session, world, ticks, maintenance="rebuild", share=0.05):
    """Build, then ``ticks`` ticks; each moves the world and hands in a
    snapshot (rebuild) or the moved share's rows (incremental)."""
    pos = world.positions()
    qid = np.arange(N, dtype=np.int32)
    session.ingest_objects(pos)
    handle = session.register_queries(pos, qid)
    out = [session.submit().result()]
    g = np.random.default_rng(7)
    for _ in range(ticks):
        world.advance()
        new = world.positions()
        if maintenance == "incremental":
            ids = np.sort(g.choice(N, int(share * N), replace=False))
            session.update_objects(ids.astype(np.int32), new[ids])
            pos = pos.copy()
            pos[ids] = new[ids]
        else:
            pos = new
            session.ingest_objects(pos)
        session.update_queries(handle, pos)
        out.append(session.submit().result())
    return out


def test_off_makes_no_trace_range_or_event(monkeypatch):
    assert not tracing.enabled()
    totals = tracing.totals()
    counted = dict(totals.counters)
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: made.append(kw) or pytest.fail(
                            "a CUDA event was made with tracing off"))
    from torch.profiler import ProfilerActivity, profile

    session = KnnSession(_spec(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = _ticks(session, _world(), 1)
    assert all(r.trace is None for r in results)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert names and not any(n.startswith(tracing.PREFIX) for n in names)
    # a CUDA tick's record, asked for with tracing off, is none either
    assert tracing.open_tick(torch.device("cuda")) is None
    with tracing.into(None), tracing.span("sweep", device=True) as s:
        tracing.count("host.syncs")
    assert s is tracing.span("refresh") and made == []
    assert tracing.totals() is totals and totals.counters == counted


def test_on_spans_land_in_their_tick_under_their_parent(traced):
    from torch.profiler import ProfilerActivity, profile

    session = KnnSession(_spec(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build, t1, t2 = _ticks(session, _world(), 2)
    # the build tick refreshes through _build and opens no ``refresh``
    assert build.trace.spans["refresh.build"].parent == "submit"
    assert "refresh" not in build.trace.spans
    assert "hand_in.objects" in build.trace.spans  # the first ingest
    for res in (t1, t2):
        spans = res.trace.spans
        assert set(spans) == set(PARENTS)
        assert {n: s.parent for n, s in spans.items()} == PARENTS
        for name, st in spans.items():
            assert st.n >= 1 and st.self_ms <= st.host_ms + 1e-9, name
            assert (st.device_ms is not None) == (name in DEVICE_SPANS)
        for name in ("submit", "sweep", "refresh", "result.collect"):
            assert spans[name].n == 1
        # the last pass finds no live row: one more pass span than passes
        passes = res.trace.counters["sweep.passes"]
        assert spans["sweep.pass"].n == passes + 1
        assert spans["sweep.sync"].n == 2 * passes + 1
        assert spans["sweep.scan"].n == passes
        children = sum(spans[n].host_ms for n in PARENTS
                       if PARENTS[n] == "submit")
        assert children <= spans["submit"].host_ms
        assert res.trace.counters["sweep.rows"] >= N
    # one identifier a tick, in submit order
    assert [r.trace.tick for r in (build, t1, t2)] == [
        build.trace.tick, build.trace.tick + 1, build.trace.tick + 2]
    # the totals are the ticks' sum
    total = tracing.totals()
    assert total.tick == 3
    assert total.counters["sweep.passes"] == sum(
        r.trace.counters["sweep.passes"] for r in (build, t1, t2))
    # a running profiler sees each span as a range of its own name
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert {tracing.PREFIX + n for n in PARENTS} <= names


def test_sweep_passes_are_b1_launches_and_syncs_bound_them(traced,
                                                          monkeypatch):
    """On the fp32 narrow route every pass launches B1 once.  The CPU runs
    B1's plain version and counts no launch, so the wrapper counts here as
    the card would."""
    real = tfs.fused_scan_merge

    def counting(*args, **kw):
        tfs.fused_scan_merge.launches += 1
        return real(*args, **kw)

    counting.launches = 0
    monkeypatch.setattr(tfs, "fused_scan_merge", counting)
    session = KnnSession(_spec(backend="fused_bucket"), device="cpu")
    pos = _world().positions()
    session.ingest_objects(pos)
    session.register_queries(pos, np.arange(N, dtype=np.int32))
    session.submit().result()
    for _ in range(2):
        before = counting.launches
        session.ingest_objects(pos)
        res = session.submit().result()
        passes = res.trace.counters["sweep.passes"]
        assert passes == counting.launches - before > 0
        syncs = res.trace.counters["host.syncs"]
        assert syncs >= 2 * passes
        # the sweep's 2 a pass and its last, 2 scalars and the drift bool,
        # the drain, 4 copies (2 counters, 2 lists)
        assert syncs == 2 * passes + 1 + 3 + 1 + 4


def test_drift_rebuild_is_traced_in_its_ticks_finalize(traced):
    """Past half the build's work every tick's finalize rebuilds: the first
    after the build does, and its record holds the rebuild."""
    session = KnnSession(_spec(rebuild_factor=0.5), device="cpu")
    build, t1 = _ticks(session, _world("gaussian"), 1)
    assert t1.rebuilt
    spans = t1.trace.spans
    assert spans["refresh.build"].parent == "result.finalize"
    assert spans["result.finalize"].self_ms <= spans["result.finalize"].host_ms
    assert spans["refresh.build"].host_ms <= spans["result.finalize"].host_ms


def test_incremental_refresh_is_traced_and_skip_opens_none(traced):
    session = KnnSession(_spec(maintenance="incremental"), device="cpu")
    world = _world()
    _, t1 = _ticks(session, world, 1, "incremental")
    assert t1.maintenance == "incremental"
    assert t1.trace.spans["refresh"].parent == "submit"
    skip = session.submit().result()  # nothing moved: the index is current
    assert skip.maintenance == "skip" and "refresh" not in skip.trace.spans


def test_a_tick_submitted_untraced_records_nothing_later():
    session = KnnSession(_spec(), device="cpu")
    pos = _world().positions()
    session.ingest_objects(pos)
    session.register_queries(pos, np.arange(N, dtype=np.int32))
    h = session.submit()
    tracing.enable()
    try:
        assert h.result().trace is None
        session.ingest_objects(pos)
        spans = session.submit().result().trace.spans
        # the untraced tick's finalize and collect went nowhere, not into
        # the next tick's record
        assert spans["submit"].n == 1 and spans["hand_in.objects"].n == 1
        assert spans["result.finalize"].n == spans["result.collect"].n == 1
    finally:
        tracing.disable()


@pytest.mark.parametrize("maintenance", ["rebuild", "incremental"])
@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
def test_tracing_changes_no_bit(dist, maintenance):
    spec = _spec(maintenance=maintenance)
    off = _ticks(KnnSession(spec, device="cpu"), _world(dist), 3, maintenance)
    tracing.enable()
    try:
        on = _ticks(KnnSession(spec, device="cpu"), _world(dist), 3,
                    maintenance)
    finally:
        tracing.disable()
    assert [r.maintenance for r in on] == [r.maintenance for r in off]
    for a, b in zip(off, on):
        assert a.trace is None and b.trace is not None
        assert np.array_equal(a.nn_idx, b.nn_idx)
        assert np.array_equal(a.nn_dist.view(np.uint32),
                              b.nn_dist.view(np.uint32))
        assert a.iterations == b.iterations
        assert np.float32(a.candidates).tobytes() == np.float32(
            b.candidates).tobytes()
        assert a.rebuilt == b.rebuilt


def _recording(monkeypatch):
    """Every ``tracing.count`` call, in order, still counted."""
    calls = []
    real = tracing.count

    def count(name, n=1):
        calls.append((name, n))
        real(name, n)

    monkeypatch.setattr(tracing, "count", count)
    return calls


def test_tail_passes_count_the_passes_with_fewer_live_rows_than_a_chunk(
        traced, monkeypatch):
    """One ``sweep.tail_passes`` count a pass, 1 where the pass's live rows
    (its ``sweep.rows``) are fewer than one chunk; a skewed world's sweep
    has passes of both kinds."""
    calls = _recording(monkeypatch)
    results = _ticks(KnnSession(_spec(), device="cpu"), _world("gaussian"), 2)
    live = [n for name, n in calls if name == "sweep.rows"]
    tail = [n for name, n in calls if name == "sweep.tail_passes"]
    assert len(live) == len(tail)
    for res in results:  # the ticks' passes, in submit order
        counters = res.trace.counters
        passes = counters["sweep.passes"]
        mine, live = live[:passes], live[passes:]
        assert tail[:passes] == [int(n < 256) for n in mine]
        tail = tail[passes:]
        assert counters["sweep.tail_passes"] == sum(n < 256 for n in mine)
        assert 0 < counters["sweep.tail_passes"] < passes
    assert live == tail == []


def test_off_the_sweep_counts_no_tail_and_times_no_scan(monkeypatch):
    assert not tracing.enabled()
    calls = _recording(monkeypatch)
    totals = tracing.totals()
    counted = dict(totals.counters)
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: pytest.fail(
        "a CUDA event was made with tracing off"))
    results = _ticks(KnnSession(_spec(), device="cpu"), _world("gaussian"), 1)
    assert all(r.trace is None for r in results)
    # the sweep makes its calls; each returns at the switch, recording nothing
    assert any(name == "sweep.tail_passes" for name, _ in calls)
    assert tracing.totals() is totals and totals.counters == counted
    assert tracing.span("sweep.scan", device=True) is tracing.span("sweep")


def test_scan_span_is_timed_inside_the_sweep_on_the_cpu(traced):
    """On the CPU a device span's extent is its host duration: the scan's,
    summed over the passes, lies inside the sweep's."""
    _, t1 = _ticks(KnnSession(_spec(), device="cpu"), _world("gaussian"), 1)
    spans = t1.trace.spans
    scan, sweep = spans["sweep.scan"], spans["sweep"]
    assert scan.device_ms == pytest.approx(scan.host_ms)
    assert 0 < scan.device_ms <= sweep.device_ms
    assert scan.n == t1.trace.counters["sweep.passes"]


# each tick's lists (digest of the ids and distance bits), trips, candidate
# sum and sweep counters, as the sweep gave them before it counted its tail
# passes and timed its scan on the device (build tick, then two moves)
BEFORE = {
    "uniform": [
        ("c23027d6b59c84b2", 48, 221198.0, {
            "host.syncs": 24, "sweep.nav_rows": 2347, "sweep.passes": 8,
            "sweep.rows": 4694}),
        ("f286a80892d044d6", 48, 221381.0, {
            "host.syncs": 25, "sweep.nav_rows": 2351, "sweep.passes": 8,
            "sweep.rows": 4702}),
        ("ebc5777f44fd25cb", 48, 220463.0, {
            "host.syncs": 25, "sweep.nav_rows": 2343, "sweep.passes": 8,
            "sweep.rows": 4686})],
    "gaussian": [
        ("214546e4b9fa68b6", 39, 196654.0, {
            "host.syncs": 28, "sweep.nav_rows": 1831, "sweep.passes": 10,
            "sweep.rows": 3704}),
        ("76066fe463d4054f", 40, 197322.0, {
            "host.syncs": 29, "sweep.nav_rows": 1842, "sweep.passes": 10,
            "sweep.rows": 3720}),
        ("4651acc39420e246", 40, 198606.0, {
            "host.syncs": 29, "sweep.nav_rows": 1869, "sweep.passes": 10,
            "sweep.rows": 3761})],
}


@pytest.mark.parametrize("dist", sorted(BEFORE))
def test_sweep_outputs_and_counters_are_those_from_before(traced, dist):
    import hashlib

    session = KnnSession(_spec(), device="cpu")
    world = make_workload(N, dist, seed=3, side=SIDE)
    got = []
    for res in _ticks(session, world, 2):
        digest = hashlib.sha256(
            np.ascontiguousarray(res.nn_idx).tobytes()
            + np.ascontiguousarray(res.nn_dist).view(np.uint32).tobytes())
        counters = {n: c for n, c in res.trace.counters.items()
                    if n != "sweep.tail_passes"}
        got.append((digest.hexdigest()[:16], res.iterations, res.candidates,
                    counters))
    assert got == BEFORE[dist]


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = 1

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        assert self.t is not None and end.t is not None
        return 2.5


def test_device_spans_on_a_cuda_record_time_events_from_a_pool(traced,
                                                                monkeypatch):
    """A CUDA tick's device spans record a pair of events each, read at
    finish; the next tick takes the same events again."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    for tick in range(2):
        rec = tracing.open_tick(torch.device("cuda"))
        with tracing.into(rec), tracing.span("submit"):
            with tracing.span("sweep", device=True):
                with tracing.span("sweep.pass"):
                    tracing.count("sweep.passes")
            with tracing.span("plan.unsort", device=True):
                pass
        assert rec.trace.spans["sweep"].device_ms is None  # not read yet
        trace = tracing.finish(rec)
        assert trace.spans["sweep"].device_ms == 2.5
        assert trace.spans["plan.unsort"].device_ms == 2.5
        assert trace.spans["sweep.pass"].device_ms is None
        assert trace.spans["sweep"].parent == "submit"
        assert _FakeEvent.made == 4  # two pairs, made on the first tick
    assert tracing.totals().counters == {"sweep.passes": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run this file on the GPU machine")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_spans_time_a_tick_on_the_card(cuda):
    spec = ServiceSpec(k=32, chunk=8192, side=SIDE, backend="fused_bucket")
    world = make_workload(100_000, "uniform", seed=5, side=SIDE)
    pos = world.positions()
    qid = np.arange(pos.shape[0], dtype=np.int32)
    off_session = KnnSession(spec, device=cuda)
    off_session.ingest_objects(pos)
    off_session.register_queries(pos, qid)
    off = off_session.submit().result()
    tracing.enable()
    try:
        session = KnnSession(spec, device=cuda)
        session.ingest_objects(pos)
        h = session.register_queries(pos, qid)
        session.submit().result()
        session.ingest_objects(pos)
        session.update_queries(h, pos)
        before = tfs.fused_scan_merge.launches
        res = session.submit().result()
        launches = tfs.fused_scan_merge.launches - before
    finally:
        tracing.disable()
    assert np.array_equal(off.nn_idx, res.nn_idx)
    assert np.array_equal(off.nn_dist, res.nn_dist)
    spans = res.trace.spans
    for name in DEVICE_SPANS:
        assert spans[name].device_ms > 0, name
    # the device spans lie inside the tick, one after another (the scan's
    # inside the sweep's)
    assert sum(spans[n].device_ms for n in DEVICE_SPANS
               if PARENTS[n] != "sweep.pass") <= 1e3 * res.wall_s
    assert res.trace.counters["sweep.passes"] == launches


@pytest.mark.gpu
def test_scan_span_times_the_card_within_the_sweep(cuda):
    """A skewed tick on the card: the scan's device extent, summed over its
    passes, is above zero and inside the sweep's; the tail passes are some
    of the passes."""
    spec = ServiceSpec(k=32, chunk=8192, side=SIDE, backend="fused_bucket")
    pos = make_workload(100_000, "gaussian", seed=5, side=SIDE).positions()
    qid = np.arange(pos.shape[0], dtype=np.int32)
    tracing.enable()
    try:
        session = KnnSession(spec, device=cuda)
        session.ingest_objects(pos)
        h = session.register_queries(pos, qid)
        session.submit().result()
        session.ingest_objects(pos)
        session.update_queries(h, pos)
        res = session.submit().result()
    finally:
        tracing.disable()
    spans, counters = res.trace.spans, res.trace.counters
    assert spans["sweep.scan"].n == counters["sweep.passes"]
    assert 0 < spans["sweep.scan"].device_ms <= spans["sweep"].device_ms
    assert 0 < counters["sweep.tail_passes"] <= counters["sweep.passes"]
