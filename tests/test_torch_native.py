"""The port's C host code against its plain Python versions and the JAX
package.

``mqtt_tpu_torch/native`` builds two C sources with the host compiler at
first use: the tokenizer (``mqtt_native.c``) and the materializer
(``accelmod.c``, the module ``mqtt_torch_accel``). Here, on the CPU:

- the C tokenizer and token hash equal ``tokenize_topics_py`` /
  ``hash_token_py`` and the JAX package's tokenizer, bit for bit;
- the C materializer (eager ``Subscribers`` and lazy ``SubscribersView``)
  equals the port's plain versions on the same device output, and the
  matchers built on it equal the JAX package's C and Python output and
  the trie;
- views read like eager results (``materialize``, ``targets``, ``len``,
  ``has_shared``, ``has_inline``, ``is_lazy``) and outlive their sources;
- the port's three-slot ``Subscribers`` and ``Subscription`` take the C
  slot paths;
- a failed build raises.
"""

import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mqtt_tpu.ops import hashing as jhashing
from mqtt_tpu.ops import matcher as jmatcher
from mqtt_tpu.ops.matcher import TpuMatcher

from mqtt_tpu_torch import Subscribers, Subscription, TorchMatcher, native, subscribers_equal
from mqtt_tpu_torch.ops import hashing, matcher
from mqtt_tpu_torch.ops.flat import _bucket, flat_match_compact, flat_match_packed, pack_tokens
from mqtt_tpu_torch.ops.matcher import MatcherStats
from mqtt_tpu_torch.topics import ns_guard_mode
from mqtt_tpu_torch.utils import gctune

from test_torch_flat import twin_tries
from test_torch_matcher import canon
from test_torch_topics import MAX_LEVELS, corpus_ops, corpus_topics, ns_corpus_ops, ns_topics

REPO = Path(__file__).resolve().parent.parent
# corpus_ops at 300 subscriptions: three topics in four take the device
# route (at 1,500 a spilled root '#' entry sends nearly all to the trie).
# Where one client's filters both match, the device merges them in probe
# order and the trie in walk order (ROADMAP Queue C item 3, kept from the
# JAX package), so results are held to the trie by ``delivery`` and to the
# plain and JAX versions field for field.
LEVELS = ["a", "b", "", "$SYS", "$x", "é", "日本", "ü-ß", "sensor-%d", "x" * 200, "+", "#", " "]


def delivery(subs):
    """Who receives a publish and at which QoS: the part of a result the
    device matchers share with the trie whatever the merge order."""
    return (
        {c: s.qos for c, s in subs.subscriptions.items()},
        {g: set(m) for g, m in subs.shared.items()},
        set(subs.inline_subscriptions),
    )


def tokenizer_topics(seed: int, n: int = 400) -> list[str]:
    """Seeded topics with empty, ``$``-first, over-deep (up to 11 levels),
    non-ASCII and multi-block (200-byte) levels, and the edge cases."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, 12))
        parts = [LEVELS[j] for j in rng.integers(0, len(LEVELS), depth)]
        parts = [p % int(rng.integers(0, 1000)) if "%d" in p else p for p in parts]
        out.append("/".join(parts))
    return out + ["", "/", "//", "$", "$/a", "a//b", "\x00t1/e/1", "/".join("abcdefghijk")]


@pytest.mark.parametrize("salt", [0, 0x1234_5678_9ABC_DEF0], ids=["salt0", "salted"])
@pytest.mark.parametrize("max_levels", [4, 8])
def test_c_tokenizer_equals_python_and_the_jax_package(max_levels, salt):
    topics = tokenizer_topics(max_levels * 7 + (salt & 0xFF))
    got = hashing.tokenize_topics(topics, max_levels, salt)
    wants = (
        hashing.tokenize_topics_py(topics, max_levels, salt),
        jhashing.tokenize_topics(topics, max_levels, salt),
        jhashing.tokenize_topics_py(topics, max_levels, salt),
    )
    assert got[4].any() and got[3].any()  # over-deep and $-first topics present
    for want in wants:
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_c_tokenizer_on_an_empty_batch():
    got = hashing.tokenize_topics([], 6, 3)
    want = hashing.tokenize_topics_py([], 6, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape


@pytest.mark.parametrize("salt", [0, 1, 2**63 + 5])
def test_c_hash_token_equals_python(salt):
    for token in ["", "a", "$SYS", "é", "日本", "x" * 127, "y" * 128, "z" * 129, "w" * 300]:
        assert hashing.hash_token(token, salt) == hashing.hash_token_py(token, salt), token
        d = native.hash_token_native(token.encode(), salt)
        assert (d & 0xFFFFFFFF, d >> 32) == hashing.hash_token_py(token, salt)


# -- the materializer against its plain versions --------------------------


def _device_output(m: TorchMatcher, topics: list[str], compact: bool, capacity: int = 1 << 15):
    """One batch through the plain kernels, as the matcher issues it:
    ``(flat, out, len_overflow, padded)``."""
    m.device_arrays  # build
    flat, arrays, _ = m._state
    padded = topics + [""] * (_bucket(max(1, len(topics)), minimum=16) - len(topics))
    tok1, tok2, lengths, is_dollar, len_overflow = hashing.tokenize_topics(padded, flat.max_levels, flat.salt)
    tokens = torch.from_numpy(pack_tokens(tok1, tok2, lengths, is_dollar))
    if compact:
        out = flat_match_compact(*arrays, tokens, max_levels=flat.max_levels, capacity=capacity)
    else:
        out = flat_match_packed(*arrays, tokens, max_levels=flat.max_levels)
    return flat, out.numpy(), len_overflow, padded


def _compact_parts(out, len_overflow, bp, capacity):
    n_hits = int(out[0])
    assert not out[1], "the pair buffer overflowed: raise the capacity"
    totals = out[2 : 2 + bp]
    true_overflow = out[2 + bp : 2 + 2 * bp].astype(bool) | len_overflow
    return n_hits, totals, true_overflow, out[2 + 2 * bp : 2 + 2 * bp + capacity]


def _ranges_both(tidx, topics, lazy):
    m = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=False, device="cpu")
    flat, out, len_overflow, _ = _device_output(m, topics, compact=False)
    P = flat.pat_depth.shape[0]
    n = len(topics)
    s_c, s_py = MatcherStats(), MatcherStats()
    got = matcher.resolve_ranges_native(
        s_c, tidx.subscribers, out[:n], topics, flat, P, len_overflow[:n], None, None, lazy
    )
    want = matcher.resolve_ranges_py(s_py, tidx.subscribers, out[:n], topics, flat, P, len_overflow[:n], None, None)
    assert s_c == s_py
    return got, want, flat, out[:n]


def _compact_both(tidx, topics, lazy, capacity=1 << 15):
    m = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=True, device="cpu")
    flat, out, len_overflow, padded = _device_output(m, topics, compact=True, capacity=capacity)
    n_hits, totals, true_overflow, pair_sid = _compact_parts(out, len_overflow, len(padded), capacity)
    got = matcher.materialize_compact_pairs(
        MatcherStats(), tidx.subscribers, pair_sid, totals, true_overflow, n_hits, topics,
        flat.subs, true_overflow, lazy=lazy,
    )
    want, ovf_idx = matcher.resolve_compact_py(
        pair_sid, totals, true_overflow, topics, flat.subs, n_hits=n_hits
    )
    for i in ovf_idx:
        want[i] = tidx.subscribers(topics[i]) if topics[i] else Subscribers()
    for i, t in enumerate(topics):
        if not t:
            want[i] = Subscribers()
    return got, want, flat, (pair_sid, totals)


def _assert_same(got, want, topics, lazy):
    assert len(got) == len(want) == len(topics)
    for g, w, t in zip(got, want, topics):
        if lazy and type(g) is not Subscribers:  # host-walked rows are plain results
            assert type(g).__name__ == "SubscribersView"
            g = g.materialize()
        assert type(g) is Subscribers
        assert subscribers_equal(g, w), repr(t)
        assert canon(g) == canon(w), repr(t)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "views"])
@pytest.mark.parametrize("route", ["ranges", "compact"])
def test_c_materializer_equals_the_plain_version(route, lazy):
    _, tidx = twin_tries(corpus_ops(7, n_subs=300))
    topics = corpus_topics(21, n=400)
    got, want, _, _ = (_ranges_both if route == "ranges" else _compact_both)(tidx, topics, lazy)
    _assert_same(got, want, topics, lazy)
    for g, t in zip(got, topics):
        assert delivery(g) == delivery(tidx.subscribers(t)), repr(t)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "views"])
@pytest.mark.parametrize("route", ["ranges", "compact"])
def test_c_materializer_applies_the_namespace_guard(route, lazy):
    _, tidx = twin_tries(ns_corpus_ops(31))
    topics = ns_topics(32)
    got, want, _, _ = (_ranges_both if route == "ranges" else _compact_both)(tidx, topics, lazy)
    _assert_same(got, want, topics, lazy)
    for g, t in zip(got, topics):
        assert subscribers_equal(g, tidx.subscribers(t)), repr(t)


@pytest.mark.parametrize("compact", [False, True], ids=["packed", "compact"])
def test_matchers_equal_the_jax_package_c_and_python_output(compact, monkeypatch):
    """``TorchMatcher`` (C, eager and views) against ``TpuMatcher`` through
    the JAX package's own C materializer and through its Python
    expansion (its C module switched off), and against both tries."""
    jidx, tidx = twin_tries(corpus_ops(7, n_subs=300))
    topics = corpus_topics(21, n=400)
    kw = dict(max_levels=MAX_LEVELS, compact=compact, compact_capacity=16384 if compact else 0)
    eager = TorchMatcher(tidx, device="cpu", lazy=False, **kw).match_topics(topics)
    views = TorchMatcher(tidx, device="cpu", **kw).match_topics(topics)
    jax_c = TpuMatcher(jidx, lazy=False, **kw).match_topics(topics)
    with monkeypatch.context() as m:
        m.setattr(jmatcher, "_ACCEL_MEMO", None)
        m.setattr(jmatcher, "_ACCEL_RESOLVED", True)
        jax_py = TpuMatcher(jidx, lazy=False, **kw).match_topics(topics)
    routed = 0
    for i, t in enumerate(topics):
        assert canon(eager[i]) == canon(views[i]) == canon(jax_c[i]) == canon(jax_py[i]), repr(t)
        assert delivery(eager[i]) == delivery(tidx.subscribers(t)) == delivery(jidx.subscribers(t)), repr(t)
        routed += type(views[i]) is Subscribers
    assert routed < len(topics) // 3  # most results are views


# -- views ---------------------------------------------------------------


def _guarded_sids(flat, sids, topic):
    mode = ns_guard_mode(topic)
    return [s for s in sids if not (mode and 0 < flat.subs[s].guard <= mode)]


@pytest.mark.parametrize("corpus", ["mixed", "namespace"])
@pytest.mark.parametrize("route", ["ranges", "compact"])
def test_views_read_like_eager_results(route, corpus):
    ops, topics = (
        (corpus_ops(7, n_subs=300), corpus_topics(21, n=400)) if corpus == "mixed"
        else (ns_corpus_ops(31), ns_topics(32))
    )
    _, tidx = twin_tries(ops)
    both = _ranges_both if route == "ranges" else _compact_both
    views, _, flat, raw = both(tidx, topics, lazy=True)
    eager, _, _, _ = both(tidx, topics, lazy=False)
    if route == "compact":
        pair_sid, totals = raw
        starts = np.concatenate([[0], np.cumsum(totals)])
    P = flat.pat_depth.shape[0]
    n_views = n_shared = n_inline = 0
    for i, (v, e, t) in enumerate(zip(views, eager, topics)):
        if type(v) is Subscribers:
            continue
        n_views += 1
        assert v.is_lazy
        if route == "ranges":
            row = raw[i]
            sids = [s for p in range(P) for s in range(row[p], row[p] + row[P + p])]
        else:
            sids = pair_sid[starts[i] : starts[i + 1]].tolist()
        assert len(v) == len(_guarded_sids(flat, sids, t)), repr(t)
        assert v.has_shared == bool(e.shared) and v.has_inline == bool(e.inline_subscriptions), repr(t)
        n_shared += v.has_shared
        n_inline += v.has_inline
        plan = v.targets()
        # the fan-out plan: one entry per client, in the eager result's
        # order, each wire-equal to the eager subscription (a single
        # sighting without identifier state is the stored object itself)
        assert [c for c, _ in plan] == list(e.subscriptions), repr(t)
        for c, sub in plan:
            want = e.subscriptions[c]
            assert (sub.qos, sub.no_local, sub.retain_as_published, sub.predicates) == (
                want.qos, want.no_local, want.retain_as_published, want.predicates)
            assert {k: x for k, x in (sub.identifiers or {}).items() if x > 0} == {
                k: x for k, x in (want.identifiers or {}).items() if x > 0}
        assert v.is_lazy  # targets() builds no maps
        m = v.materialize()
        assert not v.is_lazy and v.materialize() is m
        assert subscribers_equal(m, e) and canon(m) == canon(e), repr(t)
        assert v.subscriptions is m.subscriptions  # attribute reads reach the result
    assert n_views > 100 and n_shared > 0 and n_inline > 0


def test_a_view_outlives_its_source_arrays():
    _, tidx = twin_tries(corpus_ops(7, n_subs=300))
    topics = corpus_topics(21, n=200)
    m = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=True, device="cpu")
    flat, out, len_overflow, padded = _device_output(m, topics, compact=True)
    n_hits, totals, true_overflow, pair_sid = _compact_parts(out, len_overflow, len(padded), 1 << 15)
    acc = native.accel()
    args = (totals, true_overflow.astype(np.int32), n_hits, len(topics))
    snaps = list(flat.subs.snaps)
    eager, _ = acc.resolve_compact(pair_sid, None, *args, snaps, flat.window, Subscribers)
    views, ovf = acc.resolve_compact_views(np.array(pair_sid), None, *args, snaps, flat.window, Subscribers)
    want = [None if e is None else canon(e) for e in eager]
    del out, pair_sid, totals, args, snaps, eager, flat, m
    gc.collect()
    assert ovf and all(views[i] is None for i in ovf)
    for v, w in zip(views, want):
        if v is not None:
            assert canon(v.materialize()) == w


def test_the_port_result_classes_take_the_slot_paths():
    """The port's three-slot ``Subscribers`` (no ``shared_selected``) and
    ``Subscription`` (``slots=True``) are built by the C slot paths; a
    subclass with an instance dict takes the generic paths."""
    acc = native.accel()
    sub = Subscription(filter="a/+", qos=1)
    snaps = [((("c1", sub),), (), ())]
    sids = np.array([0], dtype=np.int32)
    one = np.array([1], dtype=np.int32)
    zero = np.array([0], dtype=np.int32)

    def delta(cls):
        before = acc.view_stats()
        (res,), _ = acc.resolve_compact(sids, None, one, zero, 1, 1, snaps, 4, cls)
        after = acc.view_stats()
        return res, {k: after[k] - before[k] for k in ("slot_results", "generic_results", "slot_copies", "method_copies")}

    res, d = delta(Subscribers)
    assert type(res) is Subscribers and res.subscriptions["c1"] == sub.self_merged_copy()
    assert d == {"slot_results": 1, "generic_results": 0, "slot_copies": 1, "method_copies": 0}

    class WithDict(Subscribers):
        pass

    res, d = delta(WithDict)
    assert type(res) is WithDict and res.subscriptions["c1"] == sub.self_merged_copy()
    assert d["generic_results"] == 1 and d["slot_results"] == 0

    class Loose(Subscription):  # no slots: an instance dict
        pass

    snaps[0] = ((("c1", Loose(filter="a/+", qos=2)),), (), ())
    res, d = delta(Subscribers)
    assert res.subscriptions["c1"].qos == 2 and res.subscriptions["c1"].identifiers == {"a/+": 0}
    assert d["method_copies"] == 1 and d["slot_copies"] == 0


def test_c_expand_snap_equals_the_plain_version():
    """The exact-map route: every node snapshot of a wildcard-free set,
    with shared and inline entries, through the C ``expand_snap`` and
    ``expand_snap_py``; and the matcher's exact path against the trie."""
    ops = [("sub", f"c{i}", f"a/{i % 50}/b", i % 3, i % 4, i % 5 == 0) for i in range(300)]
    ops += [("sub", f"s{i}", f"$SHARE/g{i % 3}/a/{i % 7}/b", 1, 0, False) for i in range(40)]
    ops += [("inline", "", f"a/{i}/b", 0, 500 + i, False) for i in range(10)]
    _, tidx = twin_tries(ops)
    m = TorchMatcher(tidx, device="cpu")
    m.device_arrays  # build
    snaps = m.index.exact_map
    assert snaps is not None and len(snaps) == 50
    acc = native.accel()
    for key, snap in snaps.items():
        got = acc.expand_snap(snap, Subscribers)
        want = matcher.expand_snap_py(snap)
        assert type(got) is Subscribers and canon(got) == canon(want), key
    topics = [f"a/{i}/b" for i in range(60)] + ["a/x", ""]
    for r, t in zip(m.match_topics(topics), topics):
        assert canon(r) == canon(tidx.subscribers(t)), t
    assert m.stats.host_fast == len(topics) - 1


@pytest.mark.parametrize("corpus", ["mixed", "namespace"])
def test_c_expand_sids_list_equals_expand_sids(corpus):
    """The sharded slot route's C call: seeded sid lists (filled slots,
    one past the table, -1 padding) merged into one result per topic, the
    guard mode of each topic applied, against ``expand_sids``."""
    ops, topics = (
        (corpus_ops(7, n_subs=300), corpus_topics(21, n=200)) if corpus == "mixed"
        else (ns_corpus_ops(31), ns_topics(32))
    )
    _, tidx = twin_tries(ops)
    m = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu")
    m.device_arrays  # build
    table = m.index.subs
    acc = native.accel()
    rng = np.random.default_rng(5)
    n, w = len(table), table.window
    # the sids a kernel can emit: each entry's filled slots
    valid = np.array([o * w + k for o, snap in enumerate(table.snaps) for k in range(sum(map(len, snap)))])
    for t in topics:
        sids = sorted(set(rng.choice(valid, 12).tolist())) + [-1, n + 3]
        mode = ns_guard_mode(t)
        got = acc.expand_sids_list(sids, table.snaps, table.window, Subscribers(), mode)
        want = matcher.expand_sids(table, sids, Subscribers(), mode=mode)
        assert canon(got) == canon(want), repr(t)


def test_shared_guard_class_reads_the_inner_filter():
    """The C guard class of a shared entry is its inner filter's (after
    ``$SHARE/<group>/``), and a scoped filter's empty tenant-local level
    counts as a wildcard, as ``topics.ns_guard_class`` has it."""
    acc = native.accel()
    subs = [
        ("c0", Subscription(filter="$SHARE/g/#")),         # inner '#': class 1
        ("c1", Subscription(filter="$SHARE/g")),           # no inner: class 0
        ("c2", Subscription(filter="$SHARE/g/\x00t/+")),  # scoped '+': class 2
        ("c3", Subscription(filter="$SHARE/g/\x00t")),    # scoped, no level: class 2
        ("c4", Subscription(filter="$SHARE/g/\x00t/e")),  # scoped literal: class 0
    ]
    snaps = [((), tuple(subs), ())]
    for mode, kept in ((0, {0, 1, 2, 3, 4}), (1, {1, 2, 3, 4}), (2, {1, 4})):
        res = acc.expand_sids_list(list(range(5)), snaps, 8, Subscribers(), mode)
        got = {int(c[1]) for g in res.shared.values() for c in g}
        assert got == kept, mode


# -- build and GC tuning ---------------------------------------------------


@pytest.mark.parametrize("cc", ["/nonexistent/cc", "false"], ids=["missing", "failing"])
def test_a_failed_build_raises(cc, tmp_path):
    """With ``CC`` naming a missing or failing compiler, the first use of
    either C module raises ``NativeError`` (the compiler is part of the
    library's name, so no earlier build is reused) and leaves no temp
    file behind."""
    code = (
        "import sys\n"
        "from mqtt_tpu_torch import native\n"
        "from mqtt_tpu_torch.ops import hashing\n"
        "for call in (native.accel, lambda: hashing.tokenize_topics(['a'], 4)):\n"
        "    try:\n"
        "        call()\n"
        "    except native.NativeError as e:\n"
        "        print('raised', str(e).splitlines()[0])\n"
        "    else:\n"
        "        sys.exit('no error')\n"
    )
    env = dict(os.environ, CC=cc, PYTHONPATH=str(REPO))
    before = set((REPO / "mqtt_tpu_torch" / "build").glob("*.tmp"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("raised") == 2, r.stdout
    assert set((REPO / "mqtt_tpu_torch" / "build").glob("*.tmp")) <= before


def test_gctune_is_idempotent_and_leaves_a_disabled_collector_disabled(monkeypatch):
    before, enabled = gc.get_threshold(), gc.isenabled()
    try:
        monkeypatch.setattr(gctune, "_TUNED", False)
        gc.disable()
        gc.set_threshold(700, 10, 10)
        gctune.tune_for_throughput()
        assert not gc.isenabled() and gc.get_threshold() == (700, 10, 10)
        gc.enable()
        gctune.tune_for_throughput()
        assert gc.get_threshold() == (100_000, 50, 50)
        gc.set_threshold(700, 10, 10)
        gctune.tune_for_throughput()  # tuned once: a second call changes nothing
        assert gc.get_threshold() == (700, 10, 10)
        monkeypatch.setattr(gctune, "_TUNED", False)
        gc.set_threshold(200_000, 60, 70)
        gctune.tune_for_throughput()  # higher thresholds are kept
        assert gc.get_threshold() == (200_000, 60, 70)
        gctune.freeze_index()
        assert gc.get_freeze_count() > 0
    finally:
        gc.unfreeze()
        gc.set_threshold(*before)
        (gc.enable if enabled else gc.disable)()
