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

from mqtt_tpu_torch.packets import Subscription
from mqtt_tpu_torch.topics import SHARE_PREFIX, InlineSubscription, TopicsIndex

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
