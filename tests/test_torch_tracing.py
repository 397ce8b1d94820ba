"""The port's device pipeline profiler (``mqtt_tpu_torch.tracing``) against
the JAX package's (``mqtt_tpu.tracing``), and its seams in the port's
matchers and stage, on the CPU.

- The same synthetic ``note_dispatch``/``note_resolve`` stamps (a seeded
  clock passed as arguments; nothing sleeps) into a ``DeviceProfiler`` of
  each package give equal (``==``) ``duty_cycle``, ``overlap_ratio``,
  ``bench_block()`` and ``device_snapshot()``, and byte-identical
  exposition text on each package's registry.
- ``TorchMatcher.profiler``: the same batches through the port's matcher
  and the JAX ``TpuMatcher``, each with a profiler, stamp the same
  batches, compact and overflow counts and transfer bytes.
- ``MatchStage(profiler=)`` over ``DeltaMatcher`` and over
  ``DeltaMatcher(mesh=...)``: one record per device batch the stage
  issued, every record with its issue and D2H windows, on device 0.
"""

import asyncio

import numpy as np
import pytest

from mqtt_tpu import telemetry as jtel
from mqtt_tpu import tracing as jtr
from mqtt_tpu.ops.matcher import TpuMatcher

from mqtt_tpu_torch import DeltaMatcher, MatchStage, TorchMatcher
from mqtt_tpu_torch import telemetry as ttel
from mqtt_tpu_torch import tracing as ttr
from mqtt_tpu_torch.parallel import make_mesh

from test_torch_flat import twin_tries
from test_torch_matcher import assert_same
from test_torch_sharded import mesh_corpus, mesh_topics
from test_torch_topics import MAX_LEVELS, corpus_ops, corpus_topics

DEVICE_SETS = ((0,), (0,), (0, 1), None, (1,))


def _stamps(seed: int, n: int = 60) -> list:
    """A seeded batch stream: (issue t0, t1, sync s0, s1, devices, compact,
    overflow, bytes) with serial, overlapping and idle-gapped windows."""
    rng = np.random.default_rng(seed)
    out = []
    t = 10.0
    for k in range(n):
        t0 = t + float(rng.exponential(2e-4))
        t1 = t0 + float(rng.exponential(1e-4))
        s0 = t1 + float(rng.exponential(1e-3))
        s1 = s0 + float(rng.exponential(3e-4))
        compact = bool(rng.random() < 0.6)
        out.append((t0, t1, s0, s1, DEVICE_SETS[k % len(DEVICE_SETS)], compact,
                    compact and rng.random() < 0.1, int(rng.integers(0, 1 << 22))))
        t = t1 if rng.random() < 0.4 else s1  # overlap the next batch, or not
    return out


def _feed(prof, stamps) -> None:
    for t0, t1, s0, s1, devices, compact, overflow, nbytes in stamps:
        rec = prof.open_batch()
        rec.devices = devices
        prof.note_dispatch(rec, t0, t1)
        if nbytes:
            rec.d2h_bytes, rec.d2h_bytes_ranges, rec.d2h_bytes_dense = nbytes, 3 * nbytes, 9 * nbytes
        rec.compact, rec.compact_overflow = compact, overflow
        prof.note_resolve(rec, s0, s1)
    # a resolve without a dispatch folds the histogram only
    prof.note_resolve(prof.open_batch(), 99.0, 99.5)


@pytest.mark.parametrize("seed", [0, 4, 9])
@pytest.mark.parametrize("with_registry", [False, True], ids=["bare", "registry"])
def test_same_stamps_give_equal_aggregates(seed, with_registry):
    stamps = _stamps(seed)
    jreg = jtel.MetricsRegistry() if with_registry else None
    treg = ttel.MetricsRegistry() if with_registry else None
    jp, tp = jtr.DeviceProfiler(jreg), ttr.DeviceProfiler(treg)
    _feed(jp, stamps)
    _feed(tp, stamps)
    assert tp.batches == jp.batches == len(stamps)
    assert tp.duty_cycle() == jp.duty_cycle()
    assert tp.overlap_ratio() == jp.overlap_ratio()
    assert 0.0 <= tp.duty_cycle() <= 1.0 and 0.0 < tp.overlap_ratio() <= 1.0
    assert tp.bench_block() == jp.bench_block()
    assert tp.device_snapshot() == jp.device_snapshot()
    assert sorted(tp.device_snapshot()) == [0, 1]
    for name in ("issue_hist", "d2h_hist", "idle_gap_hist", "compact_d2h_hist"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert (b.counts, b.count, b.sum) == (a.counts, a.count, a.sum), name
    if with_registry:
        text = treg.exposition()
        assert text == jreg.exposition()
        assert ttel.check_exposition(text) == jtel.check_exposition(text)
        assert 'mqtt_tpu_device_duty_cycle_ratio{device="1"}' in text


def test_bytes_and_byte_bounds_match():
    assert ttr.BYTE_BOUNDS == jtr.BYTE_BOUNDS
    for pkg in (jtr, ttr):
        prof = pkg.DeviceProfiler()
        assert prof.bench_block() == {"batches": 0, "duty_cycle": 0.0, "overlap_ratio": 0.0, "issue_p99_ms": 0.0,
                                      "d2h_p99_ms": 0.0, "idle_gap_p99_ms": 0.0, "idle_gap_count": 0,
                                      "compact_batches": 0, "compact_overflows": 0}
        assert prof.device_snapshot() == {}
        assert prof.ensure_device(3) is prof.ensure_device(3)


class _Recording(ttr.DeviceProfiler):
    """Keeps every record it opens."""

    def __init__(self, registry=None):
        super().__init__(registry)
        self.records = []

    def open_batch(self):
        rec = super().open_batch()
        self.records.append(rec)
        return rec


def _check_records(prof, n_batches: int) -> None:
    assert prof.batches == n_batches == len(prof.records)
    for rec in prof.records:
        assert rec.dispatch is not None and rec.d2h is not None
        assert rec.dispatch[0] <= rec.dispatch[1] <= rec.d2h[0] <= rec.d2h[1]
        assert rec.devices == (0,) and rec.d2h_bytes > 0
    assert sorted(prof.device_snapshot()) == [0]
    assert prof.device_snapshot()[0]["batches"] == n_batches
    assert 0.0 <= prof.duty_cycle() <= 1.0 and 0.0 <= prof.overlap_ratio() <= 1.0


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "ranges"])
def test_matcher_stamps_match_the_jax_matcher(compact):
    ops = corpus_ops(51, n_subs=800)
    jidx, tidx = twin_tries(ops)
    kw = dict(max_levels=MAX_LEVELS) if compact else dict(max_levels=MAX_LEVELS, compact=False)
    tm = TorchMatcher(tidx, device="cpu", **kw)
    jm = TpuMatcher(jidx, lazy=False, **kw)
    tm.profiler, jm.profiler = _Recording(), jtr.DeviceProfiler()
    topics = corpus_topics(52, n=400)
    for lo in range(0, len(topics), 100):
        batch = topics[lo : lo + 100]
        assert_same(batch, tm.match_topics(batch), tidx, jidx, jm.match_topics(batch))
    _check_records(tm.profiler, -(-len(topics) // 100))
    want, got = jm.profiler.bench_block(), tm.profiler.bench_block()
    timing = ("duty_cycle", "overlap_ratio", "issue_p99_ms", "d2h_p99_ms", "idle_gap_p99_ms", "idle_gap_count",
              "compact_d2h_p99_ms")
    assert {k: v for k, v in got.items() if k not in timing} == {k: v for k, v in want.items() if k not in timing}
    assert tm.profiler.d2h_bytes_total == tm.stats.d2h_bytes
    assert (tm.profiler.compact_batches > 0) == compact


def _run_stage(dm, index, topics, prof, max_batch):
    async def drive():
        stage = MatchStage(dm, index.subscribers, max_batch=max_batch, latency_budget_s=None,
                           max_pending=4096, profiler=prof)
        stage.start()
        try:
            return await asyncio.gather(*(stage.submit(t) for t in topics)), stage
        finally:
            await stage.stop()

    return asyncio.run(drive())


@pytest.mark.parametrize("route", ["single", "mesh"])
def test_stage_fills_one_record_per_device_batch(route):
    # one filter per client on the mesh, where the sharded merge equals the trie's
    ops = mesh_corpus(53, n=600) if route == "mesh" else corpus_ops(53, n_subs=600)
    jidx, tidx = twin_tries(ops)
    mesh = make_mesh(["cpu"] * 4) if route == "mesh" else None
    dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, device="cpu", mesh=mesh)
    reg = ttel.MetricsRegistry()
    prof = _Recording(reg)
    dm.snapshot.profiler = prof
    topics = mesh_topics(54, n=500) if route == "mesh" else corpus_topics(54, n=500)
    try:
        batches0 = dm.stats.batches
        results, stage = _run_stage(dm, tidx, topics, prof, max_batch=64)
        assert_same(topics, results, tidx, jidx)
        n = dm.stats.batches - batches0
        assert n == len(stage.service_log) >= len(topics) // 64
        _check_records(prof, n)
        text = reg.exposition()
        assert ttel.check_exposition(text) > 0
        assert f'mqtt_tpu_device_issue_seconds_count{{device="0"}} {n}' in text
        # detached, the matcher stamps nothing more
        dm.snapshot.profiler = None
        _run_stage(dm, tidx, topics[:64], None, max_batch=64)
        assert prof.batches == n
    finally:
        dm.close()


# -- the span tracer and the stage's device legs ------------------------------


def _traced_run(tel, tr, seed: int):
    """200 publishes through a ``Telemetry`` of ``tel``'s package with a
    seeded ``Tracer`` of ``tr``'s attached: each sampled clock gets seeded
    stamps at explicit times and is observed; returns the facade and the
    sampling pattern (None, plain clock, trace id)."""
    tele = tel.Telemetry(sample=3)
    tracer = tr.Tracer(sample=7, ring=256, seed=seed, registry=tele.registry)
    tracer._anchor = 0.0
    tele.attach_tracer(tracer)
    rng = np.random.default_rng(seed)
    pattern = []
    for k in range(200):
        clock = tele.publish_clock()
        pattern.append(None if clock is None else getattr(clock, "trace_id", "clock"))
        if clock is None:
            continue
        clock.t0 = clock.last = 20.0 + k
        for stage in ("decode", "admission", "staging_wait", "h2d", "device_dispatch", "d2h", "encode", "flush"):
            clock.stamp_until(stage, clock.last + float(rng.exponential(2e-4)))
        tele.observe_publish(clock, f"site/{k % 5}", k % 3)
    return tele, tracer, pattern


@pytest.mark.parametrize("seed", [0, 6])
def test_seeded_tracers_sample_the_same_spans(seed):
    """The same seed gives the same sampling decisions, trace and span ids,
    span trees and exemplars in both packages: equal exports (the wall
    anchor pinned), byte-identical exposition with its exemplars, and
    ``check_trace_events`` agreeing."""
    jt, jtr_, jpat = _traced_run(jtel, jtr, seed)
    tt, ttr_, tpat = _traced_run(ttel, ttr, seed)
    assert tpat == jpat and sum(p not in (None, "clock") for p in tpat) == 200 // 7
    assert list(ttr_.ring) == list(jtr_.ring)
    assert ttr_.export() == jtr_.export()
    assert ttr.check_trace_events(ttr_.export_json()) == jtr.check_trace_events(jtr_.export_json()) > 0
    text = tt.exposition()
    assert text == jt.exposition() and '# {trace_id="' in text
    assert (ttr_.spans_total, ttr_.publishes_total) == (jtr_.spans_total, jtr_.publishes_total)
    for bad in ({}, {"traceEvents": []}, {"traceEvents": [{"name": "x", "ph": "B"}]}):
        for mod in (jtr, ttr):
            with pytest.raises(ValueError):
                mod.check_trace_events(bad)


def test_a_client_trace_id_is_adopted_alike():
    """A v5 ``trace-id`` user property adopts the client's id, bounded by
    the per-second budget, in both packages."""
    from mqtt_tpu import packets as jpk

    from mqtt_tpu_torch import packets as tpk

    out = []
    for tel, tr, pk_mod in ((jtel, jtr, jpk), (ttel, ttr, tpk)):
        tele = tel.Telemetry(sample=0)
        tracer = tr.Tracer(sample=1000, seed=3)
        tracer.adopt_max_per_s = 2
        tele.attach_tracer(tracer)
        ids = []
        for k in range(4):
            pk = pk_mod.Packet()
            pk.properties.user = [pk_mod.UserProperty("trace-id", f"client-{k}")]
            clock = tele.adopt_trace(pk)
            ids.append(getattr(clock, "trace_id", None))
        out.append(ids)
    assert out[0] == out[1] == ["client-0", "client-1", None, None]


def _stage_clocks(stage_mod, tel, dm, index, topics, prof):
    """Every topic through a ``MatchStage`` with a telemetry plane and the
    profiler, each publish carrying a stage clock; each clock's stage names
    and the facade's counters."""
    tele = tel.Telemetry(sample=1)

    async def drive():
        stage = stage_mod.MatchStage(dm, index.subscribers, max_batch=64, latency_budget_s=None, max_pending=4096,
                                     profiler=prof, telemetry=tele)
        stage.start()
        clocks = [tel.StageClock() for _ in topics]
        try:
            await asyncio.gather(*(stage.submit(t, c) for t, c in zip(topics, clocks)))
        finally:
            await stage.stop()
        return clocks

    clocks = asyncio.run(drive())
    return [[s for s, _dt in c.stages] for c in clocks], tele


def test_the_stage_stamps_the_device_legs_as_the_jax_stage():
    """``MatchStage(telemetry=, profiler=)`` in both packages: every
    publish's clock is stamped ``staging_wait`` and then ``h2d``,
    ``device_dispatch`` and ``d2h`` from its batch's own record, each leg
    a duration of its window; the h2d and d2h handoff waits and the batch
    service are observed once per batch."""
    from mqtt_tpu import staging as jst
    from mqtt_tpu.ops.delta import DeltaMatcher as JDeltaMatcher

    from mqtt_tpu_torch import staging as tst

    ops = corpus_ops(61, n_subs=600)
    jidx, tidx = twin_tries(ops)
    topics = corpus_topics(62, n=300)
    jdm = JDeltaMatcher(jidx, max_levels=MAX_LEVELS, background=False, lazy=False)
    tdm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, device="cpu")
    jprof, tprof = jtr.DeviceProfiler(), _Recording()
    jdm._snap.profiler, tdm.snapshot.profiler = jprof, tprof
    try:
        jnames, jtele = _stage_clocks(jst, jtel, jdm, jidx, topics, jprof)
        tnames, ttele = _stage_clocks(tst, ttel, tdm, tidx, topics, tprof)
    finally:
        jdm.close(), tdm.close()
    legs = ["staging_wait", "h2d", "device_dispatch", "d2h"]
    assert tnames == jnames and all(n == legs for n in tnames)
    n = tprof.batches
    assert n >= len(topics) // 64 and ttele.batch_service.count == n
    assert ttele.leg_wait["h2d"].count == ttele.leg_wait["d2h"].count == n
    assert sum(ttele.batch_fill.counts) == n and ttele.fallback["admission"].value == 0
    assert jtele.batch_service.count == jprof.batches
