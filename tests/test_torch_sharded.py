"""The port's subscription-sharded matcher against the JAX package.

The same seeded inputs go through the JAX package's ``flat_match_core``,
its sharded step (``ShardedTpuMatcher`` on ``jax.devices()[:8]``, the
8 virtual CPU devices conftest provides) and ``_tile_compact_core``, and
through the port's plain versions (``flat_match_core_plain``, the plain
step and ``tile_compact_plain``, all on CPU positions of a
``make_mesh(["cpu"] * n)``). Every output is an integer or a boolean:
tolerance 0. The matcher, ``DeltaMatcher(mesh=...)`` and ``MatchStage``
over it must give every topic the subscriber set of both packages' tries.
One process drives each mesh; nothing here opens a process group, a
socket or a thread that outlives its test.
"""

import asyncio
import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from mqtt_tpu.ops import flat as jflat
from mqtt_tpu.ops.hashing import tokenize_topics as jax_tokenize
from mqtt_tpu.parallel import ShardedTpuMatcher
from mqtt_tpu.parallel import make_mesh as jax_make_mesh
from mqtt_tpu.parallel import sharded as jsharded

from mqtt_tpu_torch import DeltaMatcher, MatchStage, Subscription, TopicsIndex, subscribers_equal
from mqtt_tpu_torch.ops import flat as tflat
from mqtt_tpu_torch.ops import kernels
from mqtt_tpu_torch.parallel import ShardedTorchMatcher, dryrun_multichip, make_mesh, shard_of
from mqtt_tpu_torch.parallel import sharded as tsharded

from test_torch_flat import apply_ops, build_twins, jax_arrays, packed_batch, torch_arrays, twin_tries
from test_torch_matcher import assert_same, canon
from test_torch_topics import MAX_LEVELS, corpus_ops, corpus_topics, saturating_ops

CORES = {
    "mixed": lambda: corpus_ops(7, n_subs=300),
    "saturated": saturating_ops,
    "empty": lambda: [],
}


def mesh_corpus(seed: int, n: int = 220) -> list[tuple]:
    """Seeded subscriptions the device serves (few overflows): `+`, `#`,
    `$SHARE` groups, inline subscriptions and `$`-rooted filters over a
    small alphabet, as the JAX package's mesh tests draw them."""
    rng = random.Random(seed)
    segs = ["a", "b", "c", "d", "", "x"]

    def rand_filter():
        parts = [rng.choice(segs + ["+"]) for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.25:
            parts[-1] = "#"
        if rng.random() < 0.05:
            parts[0] = "$SYS"
        return "/".join(parts)

    ops = [("sub", f"cl{i}", rand_filter(), rng.randint(0, 2), 0, False) for i in range(n)]
    ops += [("sub", f"sh{i}", f"$SHARE/g{i % 3}/{rand_filter()}", 1, 0, False) for i in range(20)]
    ops += [("inline", "", rand_filter(), 0, 500 + i, False) for i in range(12)]
    return ops


def mesh_topics(seed: int, n: int = 120) -> list[str]:
    rng = random.Random(seed)
    segs = ["a", "b", "c", "d", "", "x"]
    topics = ["/".join(rng.choice(segs) for _ in range(rng.randint(1, 5))) for _ in range(n)]
    return topics + ["$SYS/a", "$SYS/a/b", "", "a/b/c/d/x/a/b"]


# -- K7: flat_match_core --------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CORES))
@pytest.mark.parametrize("out_slots,overflow_slots", [(64, 0), (8, 0), (8, 20)])
def test_flat_match_core_plain_matches_jax(name, out_slots, overflow_slots):
    _, _, jf, _ = build_twins(CORES[name]())
    topics = corpus_topics(5, n=200) + ["plain/topic", "sat1", "wild/q", "hot/x", "$SYS/x/y"]
    packed = packed_batch(topics, jf)
    L = jf.max_levels
    want = jflat._jit_core()(
        *jax_arrays(jf), jnp.asarray(packed[:, :L].view(np.uint32)),
        jnp.asarray(packed[:, L : 2 * L].view(np.uint32)), jnp.asarray(packed[:, 2 * L]),
        jnp.asarray(packed[:, 2 * L + 1].astype(bool)),
        max_levels=L, out_slots=out_slots, overflow_slots=overflow_slots,
    )
    got = tflat.flat_match_core(
        *torch_arrays(jf), torch.from_numpy(packed), max_levels=L, out_slots=out_slots,
        overflow_slots=overflow_slots,
    )
    for g, w, dtype in zip(got, want, (torch.int32, torch.int32, torch.bool)):
        assert g.dtype == dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
    totals = np.asarray(want[1])
    if name == "mixed":
        assert (totals > out_slots).any() or out_slots == 64
        assert np.asarray(want[2]).any() and (np.asarray(want[0]) >= 0).any()
    if name == "empty":
        assert jf.num_patterns == 0 and not totals.any()


# -- K8: the step -------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_pair():
    ops = mesh_corpus(31337)
    jidx, tidx = twin_tries(ops)
    jm = ShardedTpuMatcher(jidx, mesh=jax_make_mesh(jax.devices()[:8]), max_levels=MAX_LEVELS, lazy=False)
    pm = ShardedTorchMatcher(tidx, mesh=make_mesh(["cpu"] * 8), max_levels=MAX_LEVELS)
    jm.rebuild()
    pm.rebuild()
    try:
        yield jm, pm, jidx, tidx
    finally:
        jm.close()
        pm.close()


def _jax_step(jm, topics):
    arrays, _tables, salt, step = jm._compiled
    tok = jax_tokenize(topics, jm.max_levels, salt)[:4]
    bs = NamedSharding(jm.mesh, PartitionSpec("batch"))
    out = step(*arrays, *(jax.device_put(np.asarray(a), bs) for a in tok))
    return [np.asarray(a) for a in out]


def _port_step(pm, topics):
    placed, _tables, salt = pm._compiled
    tok1, tok2, lengths, is_dollar, _ = tflat.tokenize_topics(topics, pm.max_levels, salt)
    host = torch.from_numpy(tflat.pack_tokens(tok1, tok2, lengths, is_dollar))
    bl = len(topics) // pm.n_batch
    gathered = pm._step(placed, {d: host for d in pm._devices}, bl)
    (g_out, g_tot, g_ovf), = gathered.values()
    # tiles [n_batch, S, bl, ...] -> the JAX step's [S, B, ...]
    return [a.transpose(0, 1).reshape(pm.n_shards, len(topics), *a.shape[3:]).numpy() for a in (g_out, g_tot, g_ovf)]


def test_mesh_layout_matches_jax():
    mesh = make_mesh(["cpu"] * 8)
    jmesh = jax_make_mesh(jax.devices()[:8])
    assert mesh.shape == dict(jmesh.shape) == {"batch": 2, "subs": 4}
    assert make_mesh(["cpu"] * 6).shape == {"batch": 2, "subs": 3}
    assert make_mesh(["cpu"] * 3).shape == {"batch": 1, "subs": 3}
    assert make_mesh(["cpu"] * 8, batch_axis=4).shape == {"batch": 4, "subs": 2}
    assert mesh.unique_devices() == [torch.device("cpu")]


def test_assembled_arrays_match_jax(mesh_pair):
    jm, pm, _, _ = mesh_pair
    arrays, _, jsalt, _ = jm._compiled
    placed, tables, salt = pm._compiled
    assert salt == jsalt
    assert list(placed) == [(torch.device("cpu"), 0, pm.n_shards)]
    for got, want in zip(placed[(torch.device("cpu"), 0, pm.n_shards)], arrays):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want.view(np.int32))
    depth = np.asarray(arrays[2])
    assert (depth == -1).any(), "the stack must carry inert pad patterns"
    assert len(tables) == pm.n_shards
    for pf, jf in zip(pm._flats, jm._flats):
        assert np.array_equal(pf.table, jf.table)
        assert pf.n_subs == jf.num_subs


@pytest.mark.parametrize("n_topics", [16, 124])
def test_step_plain_matches_jax(mesh_pair, n_topics):
    jm, pm, _, _ = mesh_pair
    topics = mesh_topics(7, n=n_topics)
    topics += [""] * (tflat._bucket(len(topics), minimum=2) - len(topics))
    want = _jax_step(jm, topics)
    got = _port_step(pm, topics)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w)
    assert (want[0] >= 0).any()


@pytest.mark.parametrize("T", [1, 2, 4])
def test_multi_tile_step_plain_matches_jax(mesh_pair, T):
    # the plain step over T tiles at once, tokens [T*bl] into the 4-D
    # gathered layout [T, S, bl, K], against the JAX step's [S, B, K]
    jm, pm, _, _ = mesh_pair
    topics = mesh_topics(10, n=124)
    topics += [""] * (tflat._bucket(len(topics), minimum=4) - len(topics))
    want = _jax_step(jm, topics)
    placed, _tables, salt = pm._compiled
    (arrays,) = placed.values()
    tok1, tok2, lengths, is_dollar, _ = tflat.tokenize_topics(topics, pm.max_levels, salt)
    tokens = torch.from_numpy(tflat.pack_tokens(tok1, tok2, lengths, is_dollar))
    S, K, bl = pm.n_shards, pm.out_slots, len(topics) // T
    out = torch.full((T, S, bl, K), 7, dtype=torch.int32)
    totals = torch.full((T, S, bl), 7, dtype=torch.int32)
    overflow = torch.zeros((T, S, bl), dtype=torch.bool)
    tsharded.sharded_step(*arrays, tokens, max_levels=pm.max_levels, out=out, totals=totals, overflow=overflow)
    got = [a.transpose(0, 1).reshape(S, len(topics), *a.shape[3:]).numpy() for a in (out, totals, overflow)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w)
    assert (want[0] >= 0).any()


def test_one_launch_step_equals_a_per_tile_loop(mesh_pair, monkeypatch):
    # on a mesh whose positions share one device the step is one call over
    # both tiles; its gathered buffers equal one call per tile
    _, pm, _, _ = mesh_pair
    assert pm._fused == [(torch.device("cpu"), 0, pm.n_batch)] and pm._split == []
    topics = mesh_topics(11, n=124)
    placed, _tables, salt = pm._compiled
    (arrays,) = placed.values()
    tok1, tok2, lengths, is_dollar, _ = tflat.tokenize_topics(topics, pm.max_levels, salt)
    host = torch.from_numpy(tflat.pack_tokens(tok1, tok2, lengths, is_dollar))
    bl = len(topics) // pm.n_batch
    calls = []

    def step(*args, **kwargs):
        calls.append(kwargs["out"].shape)
        tsharded.sharded_step_plain(*args, **kwargs)

    monkeypatch.setattr(tsharded, "sharded_step", step)
    ((g_out, g_tot, g_ovf),) = pm._step(placed, {d: host for d in pm._devices}, bl).values()
    assert calls == [(pm.n_batch, pm.n_shards, bl, pm.out_slots)]
    for t in range(pm.n_batch):
        want = (torch.empty_like(g_out[t]), torch.empty_like(g_tot[t]), torch.empty_like(g_ovf[t]))
        tsharded.sharded_step_plain(*arrays, host[t * bl : (t + 1) * bl], max_levels=pm.max_levels,
                                    out=want[0], totals=want[1], overflow=want[2])
        for g, w in zip((g_out[t], g_tot[t], g_ovf[t]), want):
            assert torch.equal(g, w)


def test_step_launch_plan_per_mesh_layout():
    # which tiles the step launches together: consecutive tiles of one
    # owner whose shards all lie on it; the rest per run of shards
    from mqtt_tpu_torch.parallel import Mesh

    c = [torch.device("cuda", i) for i in range(4)]
    layouts = {
        "one card": ([[c[0]] * 4, [c[0]] * 4], [(c[0], 0, 2)], []),
        "a card per tile": ([[c[0]] * 4, [c[1]] * 4], [(c[0], 0, 1), (c[1], 1, 1)], []),
        "4x1 per row": ([c, c], [], [0, 1]),
        "mixed": ([[c[0]] * 2, [c[0], c[1]], [c[0]] * 2], [(c[0], 0, 1), (c[0], 2, 1)], [1]),
    }
    for name, (grid, fused, split) in layouts.items():
        m = ShardedTorchMatcher(TopicsIndex(), mesh=Mesh(grid))
        try:
            assert (m._fused, m._split) == (fused, split), name
        finally:
            m.close()


# -- K9: the tile compaction ----------------------------------------------------------


def _jax_tile_compact(cap: int):
    return jax.jit(functools.partial(jsharded._tile_compact_core, cap_local=cap))


def _slot_inputs(seed: int, S: int, bl: int, K: int):
    """A gathered tile: per (shard, topic) a seeded total (some above K,
    many zero), the first min(total, K) slots holding sids, -1 after."""
    rng = np.random.default_rng(seed)
    totals = np.where(rng.random((S, bl)) < 0.5, 0, rng.integers(0, 2 * K, (S, bl))).astype(np.int32)
    out = rng.integers(0, 10_000, (S, bl, K)).astype(np.int32)
    out[np.arange(K)[None, None, :] >= np.minimum(totals, K)[..., None]] = -1
    overflow = rng.random((S, bl)) < 0.1
    return out, totals, overflow


def _negative_clip_slot(totals, K, cap) -> bool:
    """Whether the clip rule gives the tile's last slot a negative local
    slot: the last non-empty segment starts past cap-1 (n_hits > cap)."""
    t_flat = np.minimum(totals.T.reshape(-1), K).astype(np.int64)
    cum = np.cumsum(t_flat)
    last = np.nonzero(t_flat)[0][-1]
    return cum[-1] > cap and (cap - 1) - (cum[last] - t_flat[last]) < 0


@pytest.mark.parametrize("fit", ["slack", "exact", "below", "one", "negative"])
@pytest.mark.parametrize("S,bl,K", [(1, 32, 8), (4, 16, 8), (3, 64, 64)])
def test_tile_compact_plain_matches_jax(fit, S, bl, K):
    out, totals, overflow = _slot_inputs(S * 100 + bl + K, S, bl, K)
    n_hits = int(np.minimum(totals, K).sum())
    assert n_hits > 4
    t_flat = np.minimum(totals.T.reshape(-1), K)
    last_start = int(np.cumsum(t_flat)[np.nonzero(t_flat)[0][-1]] - t_flat[np.nonzero(t_flat)[0][-1]])
    cap = {"slack": n_hits + 29, "exact": n_hits, "below": n_hits // 2, "one": 1,
           "negative": max(1, last_start - K - 3)}[fit]
    if fit == "negative":
        assert _negative_clip_slot(totals, K, cap)
    want = np.asarray(_jax_tile_compact(cap)(jnp.asarray(out), jnp.asarray(totals), jnp.asarray(overflow)))
    got = tsharded.tile_compact(
        torch.from_numpy(out)[None], torch.from_numpy(totals)[None], torch.from_numpy(overflow)[None], cap
    )
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert int(want[0, 0]) == n_hits and bool(want[0, 1]) == (n_hits > cap)


def test_tile_compact_plain_on_step_output_matches_jax(mesh_pair):
    jm, pm, _, _ = mesh_pair
    topics = mesh_topics(9, n=124)
    out, totals, overflow = _jax_step(jm, topics)
    bl = len(topics) // pm.n_batch
    for t in range(pm.n_batch):
        tile = [a[:, t * bl : (t + 1) * bl] for a in (out, totals, overflow)]
        n_hits = int(np.minimum(tile[1], pm.out_slots).sum())
        for cap in (n_hits + 16, max(1, n_hits // 3)):
            want = np.asarray(_jax_tile_compact(cap)(*(jnp.asarray(a) for a in tile)))
            got = tsharded.tile_compact(*(torch.from_numpy(a.copy())[None] for a in tile), cap)
            assert np.array_equal(got.numpy(), want)


# -- shard_of, the matcher, the delta overlay and the stage ---------------------------


def test_shard_of_matches_jax():
    rng = random.Random(99)
    alphabet = "ab/+#$é\x00漢"
    kinds = [tflat.KIND_CLIENT, tflat.KIND_SHARED, tflat.KIND_INLINE, "sub", "inline"]
    for _ in range(10_000):
        kind = rng.choice(kinds)
        client = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 6)))
        flt = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
        ident = rng.randint(0, 1 << 20)
        n = rng.choice([1, 2, 3, 4, 8])
        assert shard_of(kind, client, flt, ident, n) == jsharded.shard_of(kind, client, flt, ident, n)


# the matchers' two result forms: lazy SubscribersView over the compact
# route's (shard, sid) stream, and eager Subscribers (ShardedTorchMatcher's
# default, and every result of the slot route)
LAZY = pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])


@LAZY
@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_sharded_matcher_matches_jax_and_both_tries(compact, lazy):
    jidx, tidx = twin_tries(mesh_corpus(7))
    topics = mesh_topics(8, n=200)
    pm = ShardedTorchMatcher(tidx, mesh=make_mesh(["cpu"] * 8), max_levels=MAX_LEVELS, compact=compact,
                             lazy=lazy)
    jm = ShardedTpuMatcher(jidx, mesh=jax_make_mesh(jax.devices()[:8]), max_levels=MAX_LEVELS,
                           compact=compact, lazy=False)
    try:
        got = pm.match_topics(topics)
        assert_same(topics, got, tidx, jidx, jm.match_topics(topics))
        # a pinned capacity far below the hits: the per-batch fallback
        pm.compact_capacity = jm.compact_capacity = 16 if compact else 0
        assert_same(topics, pm.match_topics(topics), tidx, jidx, jm.match_topics(topics))
        for key in ("batches", "topics", "host_fallbacks", "overflows", "compact_batches",
                    "compact_overflows", "d2h_bytes"):
            assert getattr(pm.stats, key) == getattr(jm.stats, key), key
        assert pm.stats.host_fallbacks < len(topics) // 4
        if compact:
            assert pm.stats.compact_overflows >= 1
            assert np.array_equal(pm.tile_hit_counts(), jm.tile_hit_counts())
            assert pm.device_skew_ratio() == pytest.approx(jm.device_skew_ratio())
        # a batch that fits its pair buffer: views come from the compact
        # route only (a batch that outgrew it re-runs on the eager slot
        # route, as both batches above did)
        pm.compact_capacity = 1 << 15 if compact else 0
        fallbacks = pm.stats.host_fallbacks
        got = pm.match_topics(topics)
        assert_same(topics, got, tidx, jidx)
        n_views = sum(type(r).__name__ == "SubscribersView" for r in got)
        device_rows = len(topics) - (pm.stats.host_fallbacks - fallbacks) - topics.count("")
        assert device_rows > len(topics) // 2
        assert n_views == (device_rows if lazy and compact else 0)
    finally:
        pm.close()
        jm.close()


@LAZY
def test_multi_shard_clients_merge_as_the_jax_package_does(lazy):
    """A client whose matching filters lie in different shards: its merged
    Subscription takes the first shard's fields (filter, identifier,
    retain flags) where the trie takes the walk's first — a fault of the
    JAX package's sharded matcher that the port keeps, result for result.
    Who is delivered, and at which QoS, is the trie's."""
    jidx, tidx = twin_tries(corpus_ops(10, n_subs=300))
    topics = corpus_topics(11, n=300)
    pm = ShardedTorchMatcher(tidx, mesh=make_mesh(["cpu"] * 8), max_levels=MAX_LEVELS, lazy=lazy)
    jm = ShardedTpuMatcher(jidx, mesh=jax_make_mesh(jax.devices()[:8]), max_levels=MAX_LEVELS, lazy=False)
    differ = 0
    try:
        for got, want, t in zip(pm.match_topics(topics), jm.match_topics(topics), topics):
            assert canon(got) == canon(want), t
            host = tidx.subscribers(t)
            assert {c: s.qos for c, s in got.subscriptions.items()} == {c: s.qos for c, s in host.subscriptions.items()}
            assert got.shared == host.shared and got.inline_subscriptions == host.inline_subscriptions
            differ += not subscribers_equal(got, host)
    finally:
        pm.close()
        jm.close()
    assert differ > 0, "the corpus must hold clients whose filters span shards"


def test_incremental_rebuild_touches_one_shard():
    _, tidx = twin_tries([("sub", f"cl{i}", f"t/{i % 10}/{i}", 0, 0, False) for i in range(100)])
    m = ShardedTorchMatcher(tidx, mesh=make_mesh(["cpu"] * 4))
    try:
        m.rebuild()
        assert m._dirty == [False] * m.n_shards
        before = list(m._flats)
        sizes_before = [f.n_subs for f in before]
        tidx.subscribe("fresh", Subscription(filter="t/3/fresh", qos=1))
        owner = shard_of("sub", "fresh", "t/3/fresh", 0, m.n_shards)
        assert [s for s in range(m.n_shards) if m._dirty[s]] == [owner]
        m.rebuild()
        # only the dirty shard was recompiled
        assert [f is g for f, g in zip(m._flats, before)] == [s != owner for s in range(m.n_shards)]
        assert [f.n_subs for f in m._flats] == [n + (s == owner) for s, n in enumerate(sizes_before)]
        assert set(m.subscribers("t/3/fresh").subscriptions) == {"fresh"}
        tidx.unsubscribe("t/3/fresh", "fresh")
        assert [s for s in range(m.n_shards) if m._dirty[s]] == [owner]
        m.rebuild()
        assert [f.n_subs for f in m._flats] == sizes_before
    finally:
        m.close()
    assert tidx._observers == []


@LAZY
def test_sharded_matcher_under_churn_matches_jax(lazy):
    rng = random.Random(4242)
    ops = mesh_corpus(5, n=150)
    jidx, tidx = twin_tries(ops)
    pm = ShardedTorchMatcher(tidx, mesh=make_mesh(["cpu"] * 8), max_levels=5, lazy=lazy)
    jm = ShardedTpuMatcher(jidx, mesh=jax_make_mesh(jax.devices()[:8]), max_levels=5, lazy=False)
    live = [(o[2], o[1]) for o in ops if o[0] == "sub"]
    pm.rebuild()
    jm.rebuild()
    try:
        for round_ in range(4):
            churn = []
            for _ in range(10):
                if rng.random() < 0.4:
                    flt, cl = live.pop(rng.randrange(len(live)))
                    churn.append(("unsub", cl, flt, 0, 0, False))
                else:
                    flt = "/".join(rng.choice(["a", "b", "+", "x"]) for _ in range(rng.randint(1, 4)))
                    cl = f"m{round_}x{rng.randint(0, 10**6)}"
                    churn.append(("sub", cl, flt, 1, 0, False))
                    live.append((flt, cl))
            apply_ops(churn, jidx, tidx)
            dirty = {shard_of("sub", c, f, 0, pm.n_shards) for _op, c, f, *_ in churn}
            assert {s for s in range(pm.n_shards) if pm._dirty[s]} == dirty
            topics = mesh_topics(100 + round_, n=60)
            assert_same(topics, pm.match_topics(topics), tidx, jidx, jm.match_topics(topics))
    finally:
        pm.close()
        jm.close()


@LAZY
def test_delta_matcher_over_mesh(lazy):
    ops = [("sub", f"cl{i}", f"room/{i % 6}/+", 0, 0, False) for i in range(60)]
    jidx, tidx = twin_tries(ops)
    dm = DeltaMatcher(tidx, background=False, mesh=make_mesh(["cpu"] * 4), lazy=lazy)
    try:
        topics = ["room/3/x", "room/0/y", "room/9/z"]
        assert_same(topics, dm.match_topics(topics), tidx, jidx)
        # post-snapshot mutations are visible at once (overlay -> host)
        apply_ops([("sub", "newbie", "room/3/#", 1, 0, False)], jidx, tidx)
        before = dm.stats.host_fallbacks
        assert "newbie" in dm.subscribers("room/3/x").subscriptions
        assert dm.stats.host_fallbacks == before + 1
        assert dm.pending_deltas == 1
        dm.flush()
        assert dm.pending_deltas == 0
        # folded into the sharded snapshot: served by the step now
        before = dm.stats.host_fallbacks
        assert_same(topics, dm.match_topics(topics), tidx, jidx)
        assert dm.stats.host_fallbacks == before
        assert dm.stats.rebuilds >= 2
    finally:
        dm.close()
    assert tidx._observers == []


@LAZY
def test_match_stage_over_a_mesh(lazy):
    ops = mesh_corpus(11)
    jidx, tidx = twin_tries(ops)
    dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, mesh=make_mesh(["cpu"] * 4), lazy=lazy)
    topics = mesh_topics(12, n=300)

    async def drive():
        stage = MatchStage(dm, tidx.subscribers, max_batch=64, latency_budget_s=None, max_pending=4096)
        stage.start()
        try:
            first = await asyncio.gather(*(stage.submit(t) for t in topics))
            check = [tidx.subscribers(t) for t in topics]
            apply_ops([("unsub", o[1], o[2], 0, 0, False) for o in ops[:30]], jidx, tidx)
            second = await asyncio.gather(*(stage.submit(t) for t in topics))
            dm.flush()
            third = await asyncio.gather(*(stage.submit(t) for t in topics))
            return first, check, second, third, stage
        finally:
            await stage.stop()

    try:
        first, check, second, third, stage = asyncio.run(drive())
    finally:
        dm.close()
    for got, want, t in zip(first, check, topics):
        assert subscribers_equal(got, want), t
    assert_same(topics, second, tidx, jidx)
    assert_same(topics, third, tidx, jidx)
    assert stage.admission_fallbacks == 0 and not stage.fallbacks
    assert dm.stats.compact_batches > 0
    assert tidx._observers == []


@pytest.mark.parametrize("kernel", ["sharded_step", "tile_compact"])
def test_a_kernel_failure_reaches_every_future(kernel, monkeypatch):
    def fail(*args, **kwargs):
        raise kernels.KernelError(f"{kernel} launch failed")

    _, tidx = twin_tries(mesh_corpus(13, n=80))
    dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, mesh=make_mesh(["cpu"] * 4))
    topics = [t for t in mesh_topics(14, n=150) if t]
    host_walks = []

    def host_fallback(topic):
        host_walks.append(topic)
        return tidx.subscribers(topic)

    async def drive():
        stage = MatchStage(dm, host_fallback, max_batch=32, latency_budget_s=None)
        stage.start()
        try:
            return await asyncio.gather(*(stage.submit(t) for t in topics), return_exceptions=True), stage
        finally:
            await stage.stop()

    monkeypatch.setattr(tsharded, kernel, fail)
    try:
        results, stage = asyncio.run(drive())
    finally:
        dm.close()
    assert all(isinstance(r, kernels.KernelError) for r in results)
    assert not host_walks and not stage.fallbacks and stage.admission_fallbacks == 0


def test_dryrun_multichip_on_cpu_positions():
    dryrun_multichip(8, device="cpu")


def test_mesh_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(["cuda:0"] * 2)
    index = TopicsIndex()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedTorchMatcher(index)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)
    assert index._observers == []


def test_sharded_kernel_wrappers_refuse_cpu_tensors():
    before = dict(kernels.LAUNCHES)
    out = torch.zeros((1, 2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.tile_compact(out, torch.zeros((1, 2, 4), dtype=torch.int32), torch.zeros((1, 2, 4), dtype=torch.bool), 8)
    table = torch.zeros((1024, 16), dtype=torch.int32)
    pats = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.flat_match_slots(table, pats, pats, pats, torch.zeros((4, 14), dtype=torch.int32), 6, 8)
    assert kernels.LAUNCHES == before
