"""The stage's predicate and decrypt legs, on the CPU, against the JAX
package's ``MatchStage`` on the same corpus.

Both stages carry each publish's payload features and decrypt job beside
its topic; after each batch the port's filtered subscriber sets and
emissions must equal the JAX stage's, and every decrypt job must carry
the same keystream bytes. A kernel failure on either leg must reach the
publishers' futures: no host path answers for it.
"""

import asyncio
import random
import threading
import time

import numpy as np
import pytest

from mqtt_tpu.ops.matcher import TpuMatcher
from mqtt_tpu.packets import Subscription as JSubscription
from mqtt_tpu.predicates import PredicateEngine as JPredicates
from mqtt_tpu.staging import MatchStage as JMatchStage
from mqtt_tpu.tenancy import KeyRegistry as JKeyRegistry
from mqtt_tpu.tenancy import RecryptEngine as JRecrypt
from mqtt_tpu.tenancy import TenantPlane
from mqtt_tpu.topics import ns_scope_filter, ns_scope_topic

from mqtt_tpu_torch import (
    DeltaMatcher,
    KernelError,
    KeyRegistry,
    MatchStage,
    PredicateEngine,
    RecryptEngine,
    Subscribers,
    Subscription,
    Tenant,
    TopicsIndex,
)
from mqtt_tpu_torch.ops import predicates as tops
from mqtt_tpu_torch.ops import recrypt as trec

from test_torch_predicates import _assert_emits, _canon_emits, _canon_subs, payload_corpus, twin_predicated_tries

TENANT = "t0"
N_KEYS = 6


def _key(k: int) -> bytes:
    return bytes([7, k]) * 8


def _add_tenant(jidx, tidx):
    """Encrypted-namespace subscribers of one tenant: three groups of
    topics, each with a wildcard filter held by six keyed subscribers and
    one keyless one."""
    for g in range(3):
        flt = ns_scope_filter(TENANT, f"e/g{g}/+")
        for k in range(N_KEYS + 1):
            cid = f"{TENANT}:g{g}s{k}"
            jidx.subscribe(cid, JSubscription(filter=flt, qos=1))
            tidx.subscribe(cid, Subscription(filter=flt, qos=1))


def _keys(reg):
    for k in range(N_KEYS):
        reg.set_key(TENANT, f"s{k}", _key(k))
    reg.set_key(TENANT, "pub", _key(99))
    return reg


def _publishes(seed: int, n: int, recrypt):
    """(topic, payload) pairs: predicated topics with JSON payloads, and
    encrypted-namespace publishes sealed under the publisher's key."""
    rng = random.Random(seed)
    payloads = payload_corpus(seed, n)
    out = []
    for i in range(n):
        if rng.random() < 0.3:
            plain = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 100)))
            wire = recrypt.seal_with_key(_key(99), plain, bytes(rng.randrange(256) for _ in range(12)))
            out.append((ns_scope_topic(TENANT, f"e/g{rng.randrange(3)}/d{i % 5}"), wire))
        else:
            out.append((rng.choice(["s/1/t", "s/2/t", "s/2/x", "q/1", "hot/agg"]), payloads[i]))
    return out


async def _drive(stage, items):
    stage.start()
    try:
        return await asyncio.gather(*(stage.submit(t, feats=f, rjob=r) for t, f, r in items),
                                    return_exceptions=True)
    finally:
        await stage.stop()


def _carriers(pubs, predicates, recrypt, tenant):
    items = []
    for topic, payload in pubs:
        rjob = recrypt.decrypt_job(tenant, ("pub",), payload) if topic.startswith("\x00") else None
        items.append((topic, predicates.features_for(payload), rjob))
    return items


@pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])
def test_stage_legs_match_the_jax_stage(lazy):
    jidx, tidx, suffixes = twin_predicated_tries(13)
    _add_tenant(jidx, tidx)
    jpred, tpred = JPredicates(oracle_sample=1), PredicateEngine(oracle_sample=1, device="cpu")
    for s in suffixes:
        jpred.register(s)
        tpred.register(s)
    jrec = JRecrypt(_keys(JKeyRegistry()), oracle_sample=1, device_min_blocks=1)
    trec_eng = RecryptEngine(_keys(KeyRegistry()), oracle_sample=1, device_min_blocks=1, device="cpu")
    jten = TenantPlane().register(TENANT, encrypted=("e/",))
    tten = Tenant(TENANT, encrypted=("e/",))
    pubs = _publishes(17, 500, trec_eng)
    jitems = _carriers(pubs, jpred, jrec, jten)
    titems = _carriers(pubs, tpred, trec_eng, tten)

    jstage = JMatchStage(TpuMatcher(jidx, max_levels=6, lazy=False), jidx.subscribers, max_batch=64,
                         latency_budget_s=None, predicates=jpred, recrypt=jrec)
    dm = DeltaMatcher(tidx, max_levels=6, background=False, device="cpu", lazy=lazy)
    tstage = MatchStage(dm, tidx.subscribers, max_batch=64, latency_budget_s=None,
                        predicates=tpred, recrypt=trec_eng)
    try:
        jres = asyncio.run(_drive(jstage, jitems))
        tres = asyncio.run(_drive(tstage, titems))
    finally:
        dm.close()
    assert not tstage.fallbacks and tstage.admission_fallbacks == 0
    # apply() reads (and filters) a view's maps as it does a Subscribers'
    n_views = sum(type(ts).__name__ == "SubscribersView" for ts in tres)
    assert (n_views > 0) if lazy else n_views == 0
    n_rows = n_keystreams = 0
    for (topic, payload), (_t, jf, jr), (_t2, tf, tr), js, ts in zip(pubs, jitems, titems, jres, tres):
        assert not isinstance(ts, BaseException) and not isinstance(js, BaseException)
        n_rows += tf.device_row is not None
        assert (tf.device_row is None) == (jf.device_row is None)
        if tf.device_row is not None:
            assert np.array_equal(tf.device_row, jf.device_row) and tf.row_gen == jf.row_gen
        if tr is not None:
            assert (tr.key_id, tr.error) == (jr.key_id, jr.error)
            assert (tr.keystream is None) == (jr.keystream is None)
            if tr.keystream is not None:
                n_keystreams += 1
                assert np.array_equal(tr.keystream, jr.keystream)
            plain = trec_eng.open_publish(tten, ("pub",), payload, tr)
            assert plain is not None and plain == jrec.open_publish(jten, ("pub",), payload, jr)
        jsubs, jemits = jpred.apply(js, payload, jf)
        tsubs, temits = tpred.apply(ts, payload, tf)
        assert _canon_subs(tsubs) == _canon_subs(jsubs), topic
        _assert_emits(_canon_emits(temits), _canon_emits(jemits))
    assert n_rows == len(pubs) and n_keystreams > 50
    assert tpred.oracle_mismatches == 0 and trec_eng.oracle_mismatches == 0
    assert tpred.device_batches == jpred.device_batches >= len(pubs) // 64
    assert tpred.device_decisions == jpred.device_decisions > 0


def _small_stage(leg, monkeypatch):
    def fail(*args, **kwargs):
        raise KernelError(f"{leg} launch failed")

    if leg == "rules_eval":
        monkeypatch.setattr(tops, "rules_eval", fail)
    else:
        monkeypatch.setattr(trec, "keystream", fail)
    tidx = TopicsIndex()
    tidx.subscribe("c", Subscription(filter="a/+", qos=1, predicates=("$GT{v:0.5}",)))
    tidx.subscribe("k", Subscription(filter=ns_scope_filter(TENANT, "e/+")))
    pred = PredicateEngine(device="cpu")
    pred.register("$GT{v:0.5}")
    rec = RecryptEngine(_keys(KeyRegistry()), device_min_blocks=1, device="cpu")
    tenant = Tenant(TENANT, encrypted=("e/",))
    items = []
    for i in range(40):
        if i % 2:
            wire = rec.seal_with_key(_key(99), b"m" * 50)
            items.append((ns_scope_topic(TENANT, f"e/{i}"), pred.features_for(wire),
                          rec.decrypt_job(tenant, ("pub",), wire)))
        else:
            items.append((f"a/{i}", pred.features_for(b'{"v": 0.7}'), None))
    dm = DeltaMatcher(tidx, max_levels=4, background=False, device="cpu")
    stage = MatchStage(dm, tidx.subscribers, max_batch=16, latency_budget_s=None, predicates=pred, recrypt=rec)
    try:
        results = asyncio.run(_drive(stage, items))
    finally:
        dm.close()
    return results, stage, pred, rec, items


@pytest.mark.parametrize("leg", ["rules_eval", "keystream"])
def test_a_kernel_failure_on_a_leg_reaches_the_futures(leg, monkeypatch):
    results, stage, pred, rec, items = _small_stage(leg, monkeypatch)
    assert all(isinstance(r, KernelError) for r in results)
    assert not stage.fallbacks and stage.admission_fallbacks == 0
    # nothing was answered by a host path: no rows, no keystreams, no
    # host evaluations or host keystream blocks
    assert all(f.device_row is None for _t, f, _r in items)
    assert all(r is None or r.keystream is None for _t, _f, r in items)
    assert pred.host_evals == 0 and rec.host_blocks == 0


def test_fanout_kernel_failures_raise(monkeypatch):
    def fail(*args, **kwargs):
        raise KernelError("launch failed")

    rec = RecryptEngine(_keys(KeyRegistry()), device_min_blocks=1, device="cpu")
    tenant = Tenant(TENANT, encrypted=("e/",))
    monkeypatch.setattr(trec, "keystream", fail)
    with pytest.raises(KernelError):
        rec.seal_fanout(tenant, b"p" * 64, [("a", ("s1",)), ("b", ("s2",))])
    assert rec.host_blocks == 0
    pred = PredicateEngine(device="cpu")
    pred.register("$MAX{v:32}")
    monkeypatch.setattr(tops, "agg_reduce", fail)
    subs = TopicsIndex()
    for k in range(4):
        subs.subscribe(f"w{k}", Subscription(filter="h", predicates=("$MAX{v:32}",)))
    for i in range(31):
        pred.apply(subs.subscribers("h"), b'{"v": %d}' % i)
    with pytest.raises(KernelError):
        pred.apply(subs.subscribers("h"), b'{"v": 31}')


class _SlowMatcher:
    """A matcher whose every batch takes ``service_s`` to resolve: a slow
    device side."""

    def __init__(self, service_s: float) -> None:
        self.service_s = service_s

    def match_topics_async(self, topics, profile=None):
        def resolve():
            time.sleep(self.service_s)
            return [Subscribers() for _ in topics]

        return resolve


async def _burst_waits(stage, n: int) -> list:
    """One small batch (the stage's first service reading), then a burst
    of ``n`` publishes submitted at once: each publish's wait from the
    burst's start to its result."""
    stage.start()
    try:
        await asyncio.gather(*(stage.submit(f"w/{i}") for i in range(8)))
        t0 = time.perf_counter()
        waits = []

        async def one(i):
            await stage.submit(f"b/{i}")
            waits.append(time.perf_counter() - t0)

        await asyncio.gather(*(one(i) for i in range(n)))
    finally:
        await stage.stop()
    return waits


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_the_deadline_bounds_a_publish_stage_wait_when_the_device_is_slow(package):
    """Batches of 64 that take 50 ms each: unbounded, a burst of 1024
    waits 16 services for its last publish. With a 50 ms budget the
    admission deadline (projected depth x service over twice the budget)
    sends the rest of the burst to the host walk, in both packages, and
    the burst's slowest publish waits a few services. Both stages walk
    on the event loop's thread, inside ``submit``."""
    cls = JMatchStage if package == "jax" else MatchStage
    threads = []

    def walk(topic):
        threads.append(threading.current_thread().name)
        return Subscribers()

    free = cls(_SlowMatcher(0.05), walk, max_batch=64, latency_budget_s=None)
    unbounded = max(asyncio.run(_burst_waits(free, 1024)))
    stage = cls(_SlowMatcher(0.05), walk, max_batch=64, latency_budget_s=0.05)
    waits = asyncio.run(_burst_waits(stage, 1024))
    assert len(waits) == 1024 and unbounded > 0.75
    assert stage.admission_fallbacks > 512 and len(threads) == stage.admission_fallbacks
    assert max(waits) < 0.5 * unbounded
    assert set(threads) == {threading.main_thread().name}


def test_a_refused_publish_resolves_when_the_stage_stops_before_its_walk():
    """A publish the admission refused is walked inside ``submit``, so a
    ``stop()`` in the same loop iteration finds it resolved already."""
    seen = []

    async def drive():
        stage = MatchStage(_SlowMatcher(0.05), lambda t: seen.append(t) or Subscribers(), max_pending=1)
        stage.start()
        first = stage.submit("a")
        refused = stage.submit("b")  # max_pending reached: the host walk
        await stage.stop()
        return await asyncio.gather(first, refused), stage

    results, stage = asyncio.run(drive())
    assert [len(r.subscriptions) for r in results] == [0, 0]
    assert stage.admission_fallbacks == 1 and "b" in seen


async def _hogged_burst(stage, n: int, hog_s: float) -> None:
    """Four publishes one after another, then a burst of ``n`` at once,
    while a task blocks the event loop for ``hog_s`` on each of its
    turns: a loop busy with other work."""
    stop = False

    async def hog():
        while not stop:
            time.sleep(hog_s)
            await asyncio.sleep(0)

    stage.start()
    task = asyncio.get_running_loop().create_task(hog())
    try:
        for i in range(4):
            await stage.submit(f"w/{i}")
        await asyncio.gather(*(stage.submit(f"b/{i}") for i in range(n)))
    finally:
        stop = True
        await task
        await stage.stop()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_a_busy_event_loop_trips_the_deadline_only_in_the_jax_stage(package):
    """Batches that resolve in 1 ms on a loop that another task blocks for
    100 ms at a time. The JAX stage times each batch on the loop's clock,
    which counts the loop's delay in resuming the drainer, so its deadline
    (twice a 20 ms budget) sends the burst to the host walk. The port's
    deadline reads the resolve leg timed on its own thread and admits
    every publish: the device keeps up, and a walk would run on the same
    busy loop."""
    cls = JMatchStage if package == "jax" else MatchStage
    stage = cls(_SlowMatcher(0.001), lambda topic: Subscribers(), max_batch=64, latency_budget_s=0.02)
    asyncio.run(_hogged_burst(stage, 256, 0.1))
    if package == "jax":
        assert stage.admission_fallbacks > 128
    else:
        assert stage.admission_fallbacks == 0 and not stage.fallbacks


class _BoomMatcher:
    """A matcher whose issue (``at="issue"``) or resolve (``at="resolve"``)
    raises."""

    def __init__(self, at: str) -> None:
        self.at = at

    def match_topics_async(self, topics, profile=None):
        if self.at == "issue":
            raise RuntimeError("issue failed")

        def resolve():
            raise RuntimeError("resolve failed")

        return resolve


@pytest.mark.parametrize("at", ["issue", "resolve"])
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_a_matcher_failure_reaches_the_futures_where_the_jax_stage_walks(package, at):
    """The stage's own departure (ROADMAP, Departures): a matcher that raises at
    issue or at resolve. The JAX stage answers each publish from the host
    walk; the port's stage gives the publishers' futures the error and
    walks nothing (the server's breaker, ``ResilientMatcher``, is the one
    host route for a device fault)."""
    cls = JMatchStage if package == "jax" else MatchStage
    walked = []

    async def drive():
        stage = cls(_BoomMatcher(at), lambda t: walked.append(t) or Subscribers(), window_s=0.001)
        stage.start()
        try:
            return await asyncio.gather(stage.submit("a/b"), stage.submit("a/c"), return_exceptions=True)
        finally:
            await stage.stop()

    results = asyncio.run(drive())
    if package == "jax":
        assert all(len(r.subscriptions) == 0 for r in results) and sorted(walked) == ["a/b", "a/c"]
    else:
        assert all(isinstance(r, RuntimeError) for r in results) and walked == []
