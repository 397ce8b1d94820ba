"""The port's retained half of the trie and its retained-match engine
against the JAX package, on the CPU.

(a) ``retain_message``/``retain_bulk``/``messages``/``_trim`` of the port's
``TopicsIndex`` against ``mqtt_tpu.topics.TopicsIndex`` on seeded
retain/clear lists with subscriptions mixed in: the same return codes, the
same trie shape, the same retained store and the same ``messages`` lists,
in order. (b) ``RetainedMatchEngine(device="cpu")`` (K1's plain version)
against ``mqtt_tpu.ops.retained.RetainedMatchEngine`` (JAX on the CPU)
call by call: the same name lists in order, the same declines, the same
counters, and sorted lists equal to the walk. (c) The device-resident
packed corpus against the JAX engine's numpy ``packed[:n]`` after appends,
growth and compaction. Tolerance 0 throughout: names, counters and token
words are equal or the test fails.

The JAX engine's breaker cases (a kernel failure degrading to the walk
through ``CircuitBreaker``) have no counterpart: the port's engine has no
breaker and raises.
"""

import numpy as np
import pytest
import torch

from mqtt_tpu.ops.retained import RetainedMatchEngine as JEngine
from mqtt_tpu.packets import PUBLISH as JPUBLISH
from mqtt_tpu.packets import FixedHeader as JFixedHeader
from mqtt_tpu.packets import Packet as JPacket
from mqtt_tpu.packets import Subscription as JSubscription
from mqtt_tpu.topics import TopicsIndex as JTopicsIndex

from mqtt_tpu_torch import RetainedMatchEngine, Subscription, TopicsIndex
from mqtt_tpu_torch.ops import retained as tret
from mqtt_tpu_torch.topics import ns_scope_filter, ns_scope_topic

from test_torch_topics import retain_packet, retained_filters, retained_ops

SHARED = ("depth", "filter", "overflow")


def _jpacket(topic: str, payload: bytes) -> JPacket:
    return JPacket(fixed_header=JFixedHeader(type=JPUBLISH, retain=True), topic_name=topic, payload=payload)


def _shape(node) -> tuple:
    """A trie node's structure: key, retained topic, and children."""
    return (node.key, node.retain_path, tuple(_shape(c) for c in node.particles.values()))


def _names(index, flt: str) -> list:
    return [p.topic_name for p in index.messages(flt)]


def _pair(ops, subs=()):
    """Both tries from the same retain/clear list, with subscriptions
    ``(client, filter)`` added first; returns the return codes too."""
    j, t = JTopicsIndex(), TopicsIndex()
    for client, flt in subs:
        j.subscribe(client, JSubscription(filter=flt))
        t.subscribe(client, Subscription(filter=flt))
    jc = [j.retain_message(_jpacket(tp, p)) for tp, p in ops]
    tc = [t.retain_message(retain_packet(tp, p)) for tp, p in ops]
    return j, t, jc, tc


# -- (a) the retained half of the trie -----------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_retain_and_messages_match_jax(seed):
    ops = retained_ops(seed)
    subs = [(f"c{i}", flt) for i, flt in enumerate(retained_filters(seed + 100, n=30)) if "$SHARE" not in flt]
    j, t, jc, tc = _pair(ops, subs)
    assert tc == jc and {1, -1, 0} <= set(tc)
    assert _shape(t.root) == _shape(j.root)
    assert list(t.retained.get_all()) == list(j.retained.get_all())
    assert [p.payload for p in t.retained.get_all().values()] == [p.payload for p in j.retained.get_all().values()]
    for flt in retained_filters(seed):
        assert _names(t, flt) == _names(j, flt), flt
    # unsubscribing every filter trims to the same shape: retained nodes stay
    for client, flt in subs:
        assert t.unsubscribe(flt, client) == j.unsubscribe(flt, client)
    assert _shape(t.root) == _shape(j.root)
    for flt in retained_filters(seed):
        assert _names(t, flt) == _names(j, flt), flt


def test_retained_node_under_an_unsubscribed_filter_survives_as_in_jax():
    """A retained node with a subscribed child: unsubscribing the child
    must stop the trim at the retained node (the port's trie before the
    retained half pruned it)."""
    ops = [("keep/me", b"x"), (ns_scope_topic("acme", "keep/me"), b"y"), ("a", b"z")]
    subs = [("c1", "keep/me/deeper/still"), ("c2", ns_scope_filter("acme", "keep/me/+")), ("c3", "a/b/#")]
    j, t, _, _ = _pair(ops, subs)
    for client, flt in subs:
        assert t.unsubscribe(flt, client) and j.unsubscribe(flt, client)
    assert _shape(t.root) == _shape(j.root)
    for flt in ("keep/#", "+/+", ns_scope_filter("acme", "keep/#"), "a/#", "#"):
        assert _names(t, flt) == _names(j, flt), flt
    assert _names(t, "+/+") == ["keep/me"]


def test_retain_bulk_matches_jax():
    ops = retained_ops(7, n=300)
    j, t = JTopicsIndex(), TopicsIndex()
    assert t.retain_bulk([retain_packet(tp, p) for tp, p in ops]) == j.retain_bulk(
        [_jpacket(tp, p) for tp, p in ops])
    assert _shape(t.root) == _shape(j.root)
    assert list(t.retained.get_all()) == list(j.retained.get_all())
    for flt in retained_filters(7):
        assert _names(t, flt) == _names(j, flt), flt


# -- (b) the engine call by call ------------------------------------------------


def _engines(index_pair, **kw):
    j, t = index_pair
    je = JEngine(j, **kw)
    te = RetainedMatchEngine(t, device="cpu", **kw)
    return je, te


def _same(je, te, jidx, tidx, filters):
    """Every filter through both engines: equal answers and counters, and
    each answer equal to the walk as sorted lists."""
    for flt in filters:
        got, want = te.match(flt), je.match(flt)
        assert got == want, flt
        if got is not None:
            assert sorted(got) == sorted(_names(tidx, flt)) == sorted(_names(jidx, flt)), flt
    js, ts = je.stats(), te.stats()
    for k in ("corpus", "device_matches", "oracle_checks", "oracle_mismatches"):
        assert ts[k] == js[k], k
    assert ts["fallbacks"] == {k: js["fallbacks"][k] for k in SHARED}
    assert ts["oracle_mismatches"] == 0


def _packed_equal(je, te):
    """(c): each namespace's device rows equal the JAX engine's numpy rows."""
    assert set(te._corpora) == set(je._corpora)
    for ns, jc in je._corpora.items():
        tc = te._corpora[ns]
        assert tc.names == jc.names and tc.n_tok == jc.n_tok and tc.tombstones == jc.tombstones
        if jc.packed is None:
            assert tc.packed is None
            continue
        assert tuple(tc.packed.shape) == jc.packed.shape
        n = jc.n_tok
        assert np.array_equal(tc.packed[:n].cpu().numpy(), jc.packed[:n])
        assert not tc.packed[n:].any()
        assert np.array_equal(tc.overflow[:n], jc.overflow[:n])
        assert np.array_equal(tc.lengths[:n], jc.packed[:n, 2 * te.max_levels])


@pytest.mark.parametrize("seed", [11, 12])
def test_engine_matches_jax_call_by_call(seed):
    ops = retained_ops(seed)
    j, t, _, _ = _pair(ops)
    je, te = _engines((j, t), oracle_sample=3, min_capacity=16, rebuild_ratio=0.25)
    assert te.reseed() == je.reseed()
    filters = retained_filters(seed)
    _same(je, te, j, t, filters)
    _packed_equal(je, te)
    assert te.device_matches > 0 and te.oracle_checks > 0
    # churn: retains, re-retains and clears, noted as a broker notes them,
    # enough to grow capacities and to compact past rebuild_ratio
    for topic, payload in retained_ops(seed + 50, n=300):
        r = t.retain_message(retain_packet(topic, payload))
        assert r == j.retain_message(_jpacket(topic, payload))
        te.note_retained(topic, r == 1)
        je.note_retained(topic, r == 1)
        if len(topic) % 7 == 0:
            _same(je, te, j, t, filters[:6])
    # clear every other held topic of acme's namespace: its tombstones pass
    # rebuild_ratio, so its corpus compacts and is tokenized anew
    acme = [tp for tp in t.retained.get_all() if tp.startswith(ns_scope_topic("acme", ""))]
    for k, topic in enumerate(acme):
        if k % 2 == 0:
            r = t.retain_message(retain_packet(topic, b""))
            assert r == j.retain_message(_jpacket(topic, b"")) == -1
            te.note_retained(topic, False)
            je.note_retained(topic, False)
    assert te._corpora["acme"].packed is None and te._corpora["acme"].tombstones < len(acme) // 2
    _same(je, te, j, t, filters)
    _packed_equal(je, te)


def test_engine_declines_exact_and_shared_filters_as_jax():
    ops = [("a/b", b"x"), ("a", b"y")]
    je, te = _engines(_pair(ops)[:2])
    je.reseed()
    te.reseed()
    for flt in ("a", "a/b", "$SHARE/g/a/+", ns_scope_filter("acme", "$SHARE/g/#"), ns_scope_filter("acme", "x")):
        assert te.match(flt) is None and je.match(flt) is None
    assert te.device_matches == je.device_matches == 0


def test_both_depth_fallbacks_counted_as_jax():
    """An over-deep filter, and a namespace holding an over-deep retained
    topic: both answer None with ``depth`` counted; the other namespaces
    still take the kernel."""
    deep = "/".join(f"l{i}" for i in range(10))
    ops = [("a/b", b"x"), (ns_scope_topic("deep", deep), b"y"), (ns_scope_topic("deep", "a/b"), b"z")]
    j, t, _, _ = _pair(ops)
    je, te = _engines((j, t), max_levels=8)
    je.reseed()
    te.reseed()
    filters = [deep + "/#", "a/+", ns_scope_filter("deep", "a/+"), ns_scope_filter("deep", "#"), "/".join(["+"] * 9)]
    _same(je, te, j, t, filters)
    assert te.fallbacks == {"depth": 4, "filter": 0, "overflow": 0}
    assert te.device_matches == 1


def test_deletion_tracked_as_jax():
    ops = [("a", b"x"), ("a/b", b"x"), ("a/b/c", b"x"), ("x/y", b"x"), (ns_scope_topic("acme", "a/b"), b"x")]
    j, t, _, _ = _pair(ops)
    je, te = _engines((j, t), oracle_sample=1)
    je.reseed()
    te.reseed()
    assert "a/b" in te.match("a/+")
    for eng, idx, pk in ((te, t, retain_packet("a/b", b"")), (je, j, _jpacket("a/b", b""))):
        assert idx.retain_message(pk) == -1
        eng.note_retained("a/b", False)
    got = te.match("a/+")
    assert got == je.match("a/+") == [] and te.oracle_mismatches == 0
    # clearing nothing, and a namespace never seen, change nothing
    te.note_retained("never/seen", False)
    te.note_retained(ns_scope_topic("ghost", "x"), False)
    assert "ghost" not in te._corpora
    assert te.match(ns_scope_filter("ghost", "#")) == []


def test_oracle_replay_wins_a_mismatch():
    """One match in ``oracle_sample`` replays the walk; when the engine's
    corpus has drifted from the trie, the walk's answer is served and the
    mismatch counted."""
    ops = [("a/b", b"x"), ("a/c", b"x")]
    _j, t, _, _ = _pair(ops)
    te = RetainedMatchEngine(t, oracle_sample=2, device="cpu")
    te.reseed()
    t.retain_message(retain_packet("a/d", b"x"))  # not noted: the corpus drifts
    assert te.match("a/+") == ["a/b", "a/c"]  # call 1: not sampled
    assert sorted(te.match("a/+")) == ["a/b", "a/c", "a/d"]  # call 2: the walk wins
    assert (te.oracle_checks, te.oracle_mismatches) == (1, 1)
    te.reseed()
    assert te.match("a/+") == ["a/b", "a/c", "a/d"]


def test_sys_override_and_hash_base_depth_as_jax():
    ops = [("$SYS/broker/uptime", b"1"), ("$other/visible", b"1"), ("a", b"1"), ("a/b", b"1"),
           ("a/b/c", b"1"), (ns_scope_topic("acme", "$SYS/x"), b"1"), (ns_scope_topic("acme", "$y/x"), b"1")]
    j, t, _, _ = _pair(ops)
    je, te = _engines((j, t), oracle_sample=1)
    je.reseed()
    te.reseed()
    _same(je, te, j, t, ["#", "+/+", "$SYS/#", "$other/#", "a/#", "a/b/#", "+/#",
                         ns_scope_filter("acme", "#"), ns_scope_filter("acme", "+/x"),
                         ns_scope_filter("acme", "$SYS/#")])
    assert te.match("#") == ["$other/visible", "a", "a/b", "a/b/c"]  # by row, as retained
    assert te.match("a/#") == ["a/b", "a/b/c"]
    # the packed dollar column is "$SYS", not startswith("$")
    L = te.max_levels
    assert te._corpora[""].packed[:2, 2 * L + 1].tolist() == [1, 0]


def test_filter_index_cache_is_fifo_and_bounded(monkeypatch):
    monkeypatch.setattr(tret, "_FILTER_CACHE", 4)
    _j, t, _, _ = _pair([("a/b", b"x")])
    te = RetainedMatchEngine(t, device="cpu")
    te.reseed()
    for i in range(6):
        te.match(f"f{i}/+")
    assert list(te._fidx_cache) == [f"f{i}/+" for i in range(2, 6)]
    fidx, arrays = te._fidx_cache["f5/+"]
    # min_buckets=64 lies below the build's floor of 1024 buckets, in both packages
    assert fidx.n_entries == 1 and fidx.table.shape[0] == 1024
    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.int32 for a in arrays)


def test_capacity_growth_keeps_rows_and_compaction_takes_a_new_tensor():
    _j, t, _, _ = _pair([])
    te = RetainedMatchEngine(t, device="cpu", min_capacity=4, rebuild_ratio=0.25)
    topics = [f"g/{i}" for i in range(9)]
    for tp in topics[:3]:
        t.retain_message(retain_packet(tp, b"x"))
        te.note_retained(tp, True)
    assert te.match("g/+") == topics[:3]
    c = te._corpora[""]
    first = c.packed
    assert first.shape[0] == 4
    for tp in topics[3:]:
        t.retain_message(retain_packet(tp, b"x"))
        te.note_retained(tp, True)
    assert te.match("g/+") == topics
    assert c.packed.shape[0] == 16 and c.packed is not first
    assert torch.equal(c.packed[:3], first[:3])
    grown = c.packed
    for tp in topics[:3]:
        t.retain_message(retain_packet(tp, b""))
        te.note_retained(tp, False)
    assert c.packed is None and c.names == topics[3:]  # compacted past the ratio
    assert te.match("g/+") == topics[3:]
    assert c.packed is not grown and c.packed.shape[0] == 8


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetainedMatchEngine(TopicsIndex())
