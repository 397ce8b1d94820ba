"""The port's subscription trie, and the seeded corpora the port's tests share.

This module imports neither JAX nor the JAX package, so the tests that need
the card (tests/test_torch_cuda.py) can run where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_topics.py
tests/test_torch_cuda.py``. The trie cases are the reference's
(topics.go:583-628); tests/test_torch_flat.py holds the port's trie against
the JAX package's on the same corpora.
"""

import numpy as np
import pytest

from mqtt_tpu_torch.packets import PUBLISH, FixedHeader, Packet, Subscription
from mqtt_tpu_torch.topics import (
    SHARE_PREFIX,
    InlineSubscription,
    TopicsIndex,
    ns_scope_filter,
    ns_scope_topic,
)

MAX_LEVELS = 6
SEGS = ["a", "b", "c", "dd", "", "x", "$SYS", "long-segment-name", "e", "f"]


def _noop(*_a) -> None:
    pass


def corpus_ops(seed: int, n_subs: int = 2500) -> list[tuple]:
    """A seeded mutation list ``(op, client, filter, qos, identifier,
    no_local)`` over every gather class: exact, `+`, `#`, `$SHARE` groups,
    inline subscriptions, `$`-rooted filters, filters deeper than
    MAX_LEVELS, identifiers, no_local, and one spilled entry (more
    subscribers on one path than the id window)."""
    rng = np.random.default_rng(seed)
    ops: list[tuple] = []
    for i in range(n_subs):
        depth = int(rng.integers(1, MAX_LEVELS + 1))
        if rng.random() < 0.02:
            depth = MAX_LEVELS + int(rng.integers(1, 4))  # over-deep
        parts = [SEGS[j] for j in rng.integers(0, len(SEGS), depth)]
        roll = rng.random()
        if roll < 0.25:
            parts[int(rng.integers(0, depth))] = "+"
        elif roll < 0.4:
            parts = parts[: int(rng.integers(0, depth + 1))] + ["#"]
        if rng.random() < 0.05:
            parts[0] = "+"
        flt = "/".join(parts)
        qos = int(rng.integers(0, 3))
        ident = int(rng.choice([0, 0, i % 97 + 1]))
        no_local = bool(rng.random() < 0.1)
        kind = rng.random()
        if kind < 0.08:
            flt = f"{SHARE_PREFIX}/grp{int(rng.integers(0, 4))}/{flt}"
            ops.append(("sub", f"cl{i}", flt, qos, ident, no_local))
        elif kind < 0.13:
            ops.append(("inline", "", flt, 0, 1000 + i, False))
        else:
            ops.append(("sub", f"cl{int(rng.integers(0, n_subs // 3))}", flt, qos, ident, no_local))
    for j in range(20):  # one entry past the window: spilled
        ops.append(("sub", f"hot{j}", "hot/x", j % 3, 0, False))
    return ops


def corpus_topics(seed: int, n: int = 600) -> list[str]:
    """Seeded PUBLISH topics: plain, `$`-rooted, deeper than MAX_LEVELS,
    the spilled path, and the empty topic."""
    rng = np.random.default_rng(seed)
    topics = []
    for _ in range(n):
        depth = int(rng.integers(1, MAX_LEVELS + 3))
        parts = [SEGS[j] for j in rng.integers(0, len(SEGS), depth)]
        if rng.random() < 0.1:
            parts[0] = "$SYS"
        topics.append("/".join(parts))
    return topics + ["hot/x", "hot", "", "$SYS"]


def saturating_ops() -> list[tuple]:
    """Six single-level filters hashing to one bucket of the minimum
    1024-bucket table (a build-saturated bucket), plus a few others."""
    from mqtt_tpu_torch.ops import flat

    S = 1024
    by_slot: dict = {}
    with np.errstate(over="ignore"):
        seed_h = np.uint32(np.uint32(1) * np.uint32(flat._M2)) ^ np.uint32(flat.KIND_EXACT)
    colliding = None
    for i in range(200_000):
        tok = f"sat{i}"
        a, _ = flat.hash_token(tok, 0)
        with np.errstate(over="ignore"):
            s = int(flat._mix_np(seed_h, np.uint32(a))) & (S - 1)
        by_slot.setdefault(s, []).append(tok)
        if len(by_slot[s]) == 6:
            colliding = by_slot[s]
            break
    assert colliding, "no 6-way bucket collision found"
    ops = [("sub", f"c{i}", tok, 1, 0, False) for i, tok in enumerate(colliding)]
    ops += [("sub", "solo", "plain/topic", 0, 0, False), ("sub", "wild", "wild/+", 0, 0, False)]
    return ops


NS_TENANTS = ("t0", "t1", "t2")
NS_SEGS = ["e", "1", "a", "$x", "b"]


def ns_corpus_ops(seed: int, n_subs: int = 300) -> list[tuple]:
    """A seeded mutation list over tenant namespaces: global and scoped
    client, ``$SHARE`` and inline filters whose first (tenant-local) level
    is often ``+``, ``#`` or ``$x``, plus the fixed set of the guard's
    cases (global ``#``, ``+/e/1``, ``$SHARE/g/#``, inline ``#``; scoped
    ``e/+``, ``#``, ``$x/#``). A fifth of the scoped client subscriptions
    come with a global ``+/...`` filter of the same client, which
    the guard drops on every scoped topic: the client's merge must hold
    its scoped filter alone. No other client holds two filters (two
    surviving filters merge in probe order on the device, the walk's
    order in the trie: ROADMAP Queue C)."""
    rng = np.random.default_rng(seed)
    ops: list[tuple] = [
        ("sub", "g", "#", 1, 0, False),
        ("sub", "p", "+/e/1", 0, 3, False),
        ("sub", "sg", f"{SHARE_PREFIX}/g/#", 2, 0, False),
        ("inline", "", "#", 0, 9001, False),
        ("inline", "", "+/e/+", 0, 9002, False),
        ("sub", "t", ns_scope_filter("t9", "e/+"), 1, 0, False),
        ("sub", "td", ns_scope_filter("t9", "#"), 0, 0, False),
        ("sub", "tx", ns_scope_filter("t9", "$x/#"), 2, 0, False),
        ("sub", "ts", ns_scope_filter("t9", f"{SHARE_PREFIX}/g/+/1"), 1, 0, False),
        ("inline", "", ns_scope_filter("t9", "#"), 0, 9003, False),
    ]
    for i in range(n_subs):
        depth = int(rng.integers(1, 4))
        parts = [NS_SEGS[j] for j in rng.integers(0, len(NS_SEGS), depth)]
        roll = rng.random()
        if roll < 0.2:
            parts[0] = "+"
        elif roll < 0.3:
            parts = parts[: int(rng.integers(0, depth + 1))] + ["#"]
        elif roll < 0.45:
            parts[int(rng.integers(0, depth))] = "+"
        flt = "/".join(parts)
        kind = rng.random()
        if kind < 0.12:
            flt = f"{SHARE_PREFIX}/grp{int(rng.integers(0, 3))}/{flt}"
        scoped = rng.random() < 0.65
        if scoped:
            flt = ns_scope_filter(NS_TENANTS[int(rng.integers(0, len(NS_TENANTS)))], flt)
        qos = int(rng.integers(0, 3))
        ident = int(rng.choice([0, i % 31 + 1]))
        if 0.12 <= kind < 0.24:
            ops.append(("inline", "", flt, 0, 5000 + i, False))
            continue
        ops.append(("sub", f"n{i}", flt, qos, ident, False))
        if scoped and kind >= 0.24 and rng.random() < 0.2:
            wild = "+/" + "/".join(parts[1:] or [NS_SEGS[i % len(NS_SEGS)]])
            ops.append(("sub", f"n{i}", wild, int(rng.integers(0, 3)), i % 29 + 1, False))
    return ops


def ns_topics(seed: int, n: int = 300) -> list[str]:
    """Seeded PUBLISH topics, two thirds of them scoped into a tenant's
    namespace (a tenant-local first level of ``$x`` among them), and the
    guard's fixed cases."""
    rng = np.random.default_rng(seed)
    topics = []
    for _ in range(n):
        depth = int(rng.integers(1, 4))
        topic = "/".join(NS_SEGS[j] for j in rng.integers(0, len(NS_SEGS), depth))
        if rng.random() < 0.67:
            topic = ns_scope_topic(NS_TENANTS[int(rng.integers(0, len(NS_TENANTS)))], topic)
        topics.append(topic)
    fixed = ["e/1", "a/e/1", "$x/1", "a"]
    fixed += [ns_scope_topic("t9", t) for t in ("e/1", "$x/1", "$x", "a/1", "e")]
    return topics + fixed


RET_SEGS = ["a", "b", "c", "", "x", "$SYS", "$other", "long-segment-name"]
RET_TENANTS = ("acme", "bulkco", "t2")


def _ret_topic(rng, max_depth: int = MAX_LEVELS) -> str:
    depth = int(rng.integers(1, max_depth + 1))
    parts = [RET_SEGS[j] for j in rng.integers(0, len(RET_SEGS), depth)]
    if rng.random() < 0.5:  # keep $-levels mostly at the top, where the rules bite
        parts[1:] = [q for q in parts[1:] if not q.startswith("$")] or ["a"]
    return "/".join(parts) or "e"  # a topic name is never empty [MQTT-4.7.3-1]


def retained_ops(seed: int, n: int = 400) -> list[tuple]:
    """A seeded retain/clear list ``(topic, payload)`` (an empty payload
    clears): global and scoped topics (``RET_TENANTS``), ``$SYS`` and
    ``$other`` roots, empty levels, topics that are a ``#`` filter's base,
    re-retains and clears of held and of absent topics."""
    rng = np.random.default_rng(seed)
    held: list[str] = []
    ops: list[tuple] = []
    for i in range(n):
        roll = rng.random()
        if held and roll < 0.2:
            ops.append((held[int(rng.integers(0, len(held)))], b""))  # a clear
            continue
        if held and roll < 0.3:
            ops.append((held[int(rng.integers(0, len(held)))], b"again%d" % i))
            continue
        topic = _ret_topic(rng)
        if rng.random() < 0.4:
            topic = ns_scope_topic(RET_TENANTS[int(rng.integers(0, len(RET_TENANTS)))], topic)
        payload = b"" if rng.random() < 0.05 else b"p%d" % i  # a clear of nothing, now and then
        ops.append((topic, payload))
        held.append(topic)
    return ops


def retained_filters(seed: int, n: int = 80) -> list[str]:
    """Seeded SUBSCRIBE filters over the retained corpus: ``+`` and ``#``
    anywhere, exact filters (the engine declines them), ``$SHARE/``
    filters, ``$SYS``/``$other`` roots, global and scoped, and the fixed
    cases of the walk's guards."""
    rng = np.random.default_rng(seed)
    out = ["#", "+", "+/+", "+/#", "a/#", "a/+", "$SYS/#", "$SYS/+", "$other/#", "+/b", "/#", "a",
           f"{SHARE_PREFIX}/g/#"]
    out += [ns_scope_filter(t, f) for t in RET_TENANTS for f in ("#", "+", "+/#", "$SYS/#", "a/+")]
    for _ in range(n):
        parts = _ret_topic(rng, 4).split("/")
        roll = rng.random()
        if roll < 0.4:
            parts[int(rng.integers(0, len(parts)))] = "+"
        elif roll < 0.8:
            parts = parts[: int(rng.integers(0, len(parts) + 1))] + ["#"]
        flt = "/".join(parts)
        if rng.random() < 0.35:
            flt = ns_scope_filter(RET_TENANTS[int(rng.integers(0, len(RET_TENANTS)))], flt)
        out.append(flt)
    return out


def retain_packet(topic: str, payload: bytes) -> Packet:
    return Packet(fixed_header=FixedHeader(type=PUBLISH, retain=True), topic_name=topic, payload=payload)


def apply_port_ops(ops, index: TopicsIndex) -> TopicsIndex:
    for op, client, flt, qos, ident, no_local in ops:
        if op == "sub":
            index.subscribe(client, Subscription(filter=flt, qos=qos, identifier=ident, no_local=no_local))
        elif op == "unsub":
            index.unsubscribe(flt, client)
        else:
            index.inline_subscribe(InlineSubscription(filter=flt, identifier=ident, handler=_noop))
    return index


# -- the port's trie ----------------------------------------------------------

FIND_MATRIX = [
    ("a", "a", True),
    ("a/", "a", False),
    ("a/", "a/", True),
    ("/a", "/a", True),
    ("path/to/my/mqtt", "path/to/my/mqtt", True),
    ("path/to/+/mqtt", "path/to/my/mqtt", True),
    ("+/to/+/mqtt", "path/to/my/mqtt", True),
    ("#", "path/to/my/mqtt", True),
    ("+/+/+/+", "path/to/my/mqtt", True),
    ("+/+/+/#", "path/to/my/mqtt", True),
    ("zen/#", "zen", True),  # as per 4.7.1.2
    ("trailing-end/#", "trailing-end/", True),
    ("+/prefixed", "/prefixed", True),
    ("+/+/#", "path/to/my/mqtt", True),
    ("path/to/", "path/to/my/mqtt", False),
    ("#/stuff", "path/to/my/mqtt", False),
    ("#", "$SYS/info", False),
    ("$SYS/#", "$SYS/info", True),
    ("+/info", "$SYS/info", False),
]


@pytest.mark.parametrize("filter_,topic,matched", FIND_MATRIX, ids=[f"{f}~{t}" for f, t, _ in FIND_MATRIX])
def test_port_trie_find_matrix(filter_, topic, matched):
    index = TopicsIndex()
    index.subscribe("cl1", Subscription(filter=filter_))
    assert (len(index.subscribers(topic).subscriptions) == 1) == matched


def test_port_trie_shared_inline_and_quirk():
    index = TopicsIndex()
    index.subscribe("cl1", Subscription(qos=1, filter=f"{SHARE_PREFIX}/tmp/a/b/c", identifier=111))
    index.subscribe("cl2", Subscription(qos=0, filter=f"{SHARE_PREFIX}/tmp/a/b/c"))
    index.inline_subscribe(InlineSubscription(filter="a/#", identifier=8, handler=_noop))
    index.inline_subscribe(InlineSubscription(filter="#", identifier=9, handler=_noop))
    subs = index.subscribers("a/b/c")
    assert set(subs.shared[f"{SHARE_PREFIX}/tmp/a/b/c"]) == {"cl1", "cl2"}
    assert set(subs.inline_subscriptions) == {8, 9}
    # reference quirk (topics.go:615): an inline sub on a/# does not match "a"
    assert set(index.subscribers("a").inline_subscriptions) == {9}
    # inline subscriptions are exempt from the $-topic rule
    assert set(index.subscribers("$SYS/x").inline_subscriptions) == {9}


def test_port_trie_merge_and_identifiers():
    index = TopicsIndex()
    index.subscribe("c", Subscription(filter="a/+", qos=1, identifier=5))
    index.subscribe("c", Subscription(filter="a/b", qos=2, identifier=7, no_local=True))
    sub = index.subscribers("a/b").subscriptions["c"]
    assert sub.qos == 2 and sub.no_local
    assert sub.identifiers == {"a/+": 5, "a/b": 7} or sub.identifiers == {"a/b": 7, "a/+": 5}


def test_port_trie_mutations_and_observers():
    index = TopicsIndex()
    seen = []
    index.add_observer(seen.append)
    assert index.subscribe("c", Subscription(filter="x/y"))
    assert not index.subscribe("c", Subscription(filter="x/y", qos=1))
    assert index.subscribe_bulk([("d", Subscription(filter="x/y")), ("c", Subscription(filter="x/y"))]) == 1
    assert index.unsubscribe("x/y", "c")
    assert index.unsubscribe("x/y", "d")
    assert index.root.particles == {}  # trimmed
    assert not index.unsubscribe("x/y", "c")
    assert index.inline_subscribe(InlineSubscription(filter="i/#", identifier=3, handler=_noop))
    assert index.inline_unsubscribe(3, "i/#")
    assert [(m.op, m.kind) for m in seen] == [
        ("add", "sub"), ("add", "sub"), ("add", "sub"), ("add", "sub"),
        ("del", "sub"), ("del", "sub"), ("add", "inline"), ("del", "inline"),
    ]
    assert index.version == 8
    index.remove_observer(seen.append)


def test_corpus_helpers_are_seeded():
    assert corpus_ops(3, n_subs=50) == corpus_ops(3, n_subs=50)
    assert corpus_topics(3, n=20) == corpus_topics(3, n=20)
    index = apply_port_ops(corpus_ops(3, n_subs=200), TopicsIndex())
    assert {f"hot{j}" for j in range(20)} <= set(index.subscribers("hot/x").subscriptions)


# -- the retained half --------------------------------------------------------


def test_port_retain_message_return_codes():
    index = TopicsIndex()
    assert index.retain_message(retain_packet("a/b", b"x")) == 1  # new
    assert index.retain_message(retain_packet("a/b", b"y")) == 1  # replace
    assert index.retain_message(retain_packet("a/b", b"")) == -1  # clear
    assert index.retain_message(retain_packet("a/b", b"")) == 0  # nothing to clear
    assert index.retained.get("a/b") is None
    assert index.root.particles == {}  # the cleared chain is trimmed


def test_port_trim_stops_at_a_retained_node():
    index = TopicsIndex()
    index.retain_message(retain_packet("keep/me", b"x"))
    index.subscribe("c1", Subscription(filter="keep/me/deeper"))
    index.unsubscribe("keep/me/deeper", "c1")
    # keep/me anchors a retained message and stays; deeper goes
    assert "deeper" not in index.root.particles["keep"].particles["me"].particles
    assert [p.topic_name for p in index.messages("keep/#")] == ["keep/me"]
    # and a subscription anchors a node whose retained message is cleared
    index.subscribe("c2", Subscription(filter="r/t"))
    index.retain_message(retain_packet("r/t", b"x"))
    index.retain_message(retain_packet("r/t", b""))
    assert len(index.subscribers("r/t").subscriptions) == 1


def test_port_messages_guards():
    index = TopicsIndex()
    for t in ("$SYS/broker/uptime", "normal/topic", "$other/v", "a", "a/b",
              ns_scope_topic("acme", "a/b"), ns_scope_topic("acme", "$SYS/x")):
        index.retain_message(retain_packet(t, b"1"))
    names = lambda f: sorted(p.topic_name for p in index.messages(f))  # noqa: E731
    assert names("#") == ["$other/v", "a", "a/b", "normal/topic"]  # no $SYS, no namespace
    assert names("+/broker/uptime") == []
    assert names("$SYS/#") == ["$SYS/broker/uptime"]
    assert names("a/#") == ["a/b"]  # strictly deeper under #
    assert names(ns_scope_filter("acme", "#")) == [ns_scope_topic("acme", "a/b")]
    assert names(ns_scope_filter("acme", "$SYS/#")) == [ns_scope_topic("acme", "$SYS/x")]
    assert names("a") == ["a"] and names("") == []


def test_port_packet_copy_and_store():
    pk = Packet(fixed_header=FixedHeader(type=PUBLISH, qos=1, retain=True), topic_name="t",
                payload=b"x", origin="c", created=5, expiry=9)
    cp = pk.copy(False)
    assert cp == pk and cp is not pk and cp.fixed_header is not pk.fixed_header
    cp.payload = b"y"
    assert pk.payload == b"x"
    index = TopicsIndex()
    assert index.retained.name == "retained" and len(index.retained) == 0


def test_retained_helpers_are_seeded():
    assert retained_ops(3, n=50) == retained_ops(3, n=50)
    assert retained_filters(3, n=20) == retained_filters(3, n=20)
    index = TopicsIndex()
    codes = {index.retain_message(retain_packet(t, p)) for t, p in retained_ops(3)}
    assert codes == {1, -1, 0}
