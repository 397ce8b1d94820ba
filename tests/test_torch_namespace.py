"""Tenant namespace guards on every device route of the port.

The trie drops two kinds of match for a topic scoped into a tenant's
namespace (``NS_CHAR + tenant`` as its first level): a global filter whose
first level is ``+`` or ``#``, and, inside the namespace, a tenant-local
``+``/``#`` first level against a tenant-local ``$`` first level
(``TopicsIndex._ns_excluded``). The flat index cannot see the guard; the
port's materializer applies it per sub id, so ``TorchMatcher``,
``MatchStage`` over ``DeltaMatcher`` and the mesh matcher equal the trie.

The JAX package's ``TpuMatcher`` keeps the fault: its result is the trie's
with the guard switched off, which the last test pins.
"""

import asyncio

import pytest

from mqtt_tpu.ops.matcher import TpuMatcher

from mqtt_tpu_torch import DeltaMatcher, MatchStage, TorchMatcher, subscribers_equal
from mqtt_tpu_torch.ops import matcher
from mqtt_tpu_torch.parallel import make_mesh
from mqtt_tpu_torch.topics import TopicsIndex, ns_scope_filter, ns_scope_topic

from test_torch_flat import twin_tries
from test_torch_matcher import canon
from test_torch_topics import MAX_LEVELS, ns_corpus_ops, ns_topics


def _unguarded(tidx, topics, monkeypatch):
    """The trie's results with the namespace guard switched off."""
    with monkeypatch.context() as m:
        m.setattr(TopicsIndex, "_ns_excluded", staticmethod(lambda topic, filter: False))
        return [tidx.subscribers(t) for t in topics]


def _stage_results(dm, tidx, topics):
    async def drive():
        stage = MatchStage(dm, tidx.subscribers, max_batch=64, latency_budget_s=None, max_pending=4096)
        stage.start()
        try:
            return await asyncio.gather(*(stage.submit(t) for t in topics)), stage
        finally:
            await stage.stop()

    results, stage = asyncio.run(drive())
    assert stage.admission_fallbacks == 0 and not stage.fallbacks
    return results


ROUTES = ["matcher-packed", "matcher-compact", "stage", "mesh-slots", "mesh-compact"]


@pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])
@pytest.mark.parametrize("route", ROUTES)
def test_every_route_equals_the_trie_on_scoped_topics(route, lazy, monkeypatch):
    mesh = route.startswith("mesh")
    _, tidx = twin_tries(ns_corpus_ops(31))
    topics = ns_topics(32)
    if route.startswith("matcher"):
        compact = route == "matcher-compact"
        m = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=compact,
                         compact_capacity=16384 if compact else 0, device="cpu", lazy=lazy)
        got = m.match_topics(topics)
        assert (m.stats.compact_batches > 0) == compact
        assert m.stats.host_fallbacks == 0  # every topic on the device route
    else:
        dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, device="cpu",
                          compact=route != "mesh-slots", compact_capacity=16384 if mesh else 0,
                          mesh=make_mesh(["cpu"] * 8) if mesh else None, lazy=lazy)
        try:
            if route == "stage":
                # one batch resolved before the stage's, so the pair
                # buffer's capacity has learned the corpus's hits: the stage
                # may issue every batch before the first one resolves
                dm.match_topics(topics[:64])
                compact0 = dm.stats.compact_batches
                got = _stage_results(dm, tidx, topics)
                assert dm.stats.compact_batches > compact0  # the stage's own batches
            else:
                got = dm.match_topics(topics)
            assert (dm.stats.compact_batches > 0) == (route != "mesh-slots")
            assert dm.stats.host_fallbacks == 0
        finally:
            dm.close()
    # the C materializer's two forms: views on every compact or ranges
    # route when lazy (the mesh's slot route is eager), eager otherwise
    n_views = sum(type(g).__name__ == "SubscribersView" for g in got)
    assert (n_views > len(topics) // 2) if lazy and route != "mesh-slots" else n_views == 0
    unguarded = _unguarded(tidx, topics, monkeypatch)
    guarded = 0
    for t, g, u in zip(topics, got, unguarded):
        assert subscribers_equal(g, tidx.subscribers(t)), repr(t)
        guarded += not subscribers_equal(g, u)
    # the corpus reaches the guard: many scoped topics lose guarded matches
    assert guarded >= 50


def test_the_guard_cases_by_name():
    _, tidx = twin_tries(ns_corpus_ops(31, n_subs=0))
    m = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu")
    plain, dollar, own = m.match_topics([ns_scope_topic("t9", "e/1"), ns_scope_topic("t9", "$x/1"), "a/e/1"])
    assert set(plain.subscriptions) == {"t", "td"}
    assert set(plain.shared) == {ns_scope_filter("t9", "$SHARE/g/+/1")}
    assert set(plain.inline_subscriptions) == {9003}
    assert set(dollar.subscriptions) == {"tx"} and not dollar.inline_subscriptions
    # outside every namespace nothing is guarded
    assert set(own.subscriptions) == {"g", "p"} and set(own.inline_subscriptions) == {9001, 9002}
    assert set(own.shared) == {"$SHARE/g/#"}


def test_the_jax_matcher_keeps_the_fault(monkeypatch):
    """The JAX ``TpuMatcher`` ignores the guard: on every topic its result
    is the port matcher's with the guard switched off, its subscribers are
    the unguarded trie's, and it differs from the trie on scoped topics (a
    global ``#`` subscriber receives a tenant's publishes)."""
    jidx, tidx = twin_tries(ns_corpus_ops(31))
    topics = ns_topics(32)
    unguarded = _unguarded(tidx, topics, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(matcher, "ns_guard_mode", lambda topic: 0)
        port_off = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu").match_topics(topics)
    jm = TpuMatcher(jidx, max_levels=MAX_LEVELS, lazy=False)
    jax_results = jm.match_topics(topics)
    assert jm.stats.host_fallbacks == 0  # its host walk would apply the guard
    differ = 0
    for t, got, off, u in zip(topics, jax_results, port_off, unguarded):
        assert canon(got) == canon(off), repr(t)
        assert set(got.subscriptions) == set(u.subscriptions), repr(t)
        assert set(got.shared) == set(u.shared), repr(t)
        assert set(got.inline_subscriptions) == set(u.inline_subscriptions), repr(t)
        differ += canon(got) != canon(tidx.subscribers(t))
    assert differ >= 50
    leak = jm.match_topics([ns_scope_topic("t9", "e/1")])[0]
    assert {"g", "p", "t", "td"} <= set(leak.subscriptions)
