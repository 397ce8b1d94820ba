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
