"""The port's matcher chain against the JAX package and both host tries.

``TorchMatcher`` (device="cpu": the plain PyTorch kernels), ``DeltaMatcher``
under churn and ``MatchStage`` must give, for every topic, the subscriber
set of the port's own ``TopicsIndex.subscribers`` — and that set must equal
the JAX package's ``TpuMatcher`` result and its host trie's, compared in a
canonical form (the classes differ between the packages).
"""

import asyncio
import subprocess
import sys
import time

import numpy as np
import pytest

from mqtt_tpu.ops.matcher import TpuMatcher

from mqtt_tpu_torch import DeltaMatcher, MatchStage, Subscription, TorchMatcher, subscribers_equal
from mqtt_tpu_torch.ops import kernels

from test_torch_flat import apply_ops, twin_tries
from test_torch_topics import MAX_LEVELS, corpus_ops, corpus_topics, saturating_ops


def _sub_key(s):
    ids = None if s.identifiers is None else tuple(sorted(s.identifiers.items()))
    return (
        s.filter, tuple(s.share_name), s.identifier, ids, s.retain_handling,
        s.qos, s.retain_as_published, s.no_local, s.fwd_retained_flag,
    )


def canon(subs):
    """A package-neutral form of a Subscribers result: every field of every
    client subscription, the shared groups, and the inline set."""
    return (
        {c: _sub_key(s) for c, s in subs.subscriptions.items()},
        {g: {c: _sub_key(s) for c, s in m.items()} for g, m in subs.shared.items()},
        {i: (s.filter, s.identifier) for i, s in subs.inline_subscriptions.items()},
    )


def assert_same(topics, port_results, tidx, jidx=None, jax_results=None):
    assert len(port_results) == len(topics)
    for i, topic in enumerate(topics):
        host = tidx.subscribers(topic)
        assert subscribers_equal(port_results[i], host), topic
        if jidx is not None:
            assert canon(port_results[i]) == canon(jidx.subscribers(topic)), topic
        if jax_results is not None:
            assert canon(port_results[i]) == canon(jax_results[i]), topic


def churn_ops(seed: int, ops, n: int = 150) -> list[tuple]:
    """Seeded churn over an existing corpus: unsubscribes of live pairs,
    new clients on live paths, and fresh filters (some of new shapes)."""
    rng = np.random.default_rng(seed)
    live = [o for o in ops if o[0] == "sub"]
    out = []
    for k in range(n):
        op = live[int(rng.integers(0, len(live)))]
        roll = rng.random()
        if roll < 0.4:
            out.append(("unsub", op[1], op[2], 0, 0, False))
        elif roll < 0.8:
            out.append(("sub", f"churn{k}", op[2], int(rng.integers(0, 3)), k + 1, False))
        else:
            flt = f"new{k % 7}/+/{k}" if rng.random() < 0.5 else f"a/new{k}/#"
            out.append(("sub", f"churn{k}", flt, 1, 0, False))
    return out


# the matchers' two result forms: lazy SubscribersView (the default) and
# eager Subscribers, both from the C materializer
LAZY = pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])


@pytest.fixture(scope="module")
def corpus():
    return corpus_ops(7, n_subs=1500)


@LAZY
@pytest.mark.parametrize("compact", [False, True], ids=["packed", "compact"])
def test_torch_matcher_matches_jax_and_both_tries(corpus, compact, lazy):
    jidx, tidx = twin_tries(corpus)
    topics = corpus_topics(21, n=400)
    port = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=compact, compact_capacity=64 if compact else 0,
                        device="cpu", lazy=lazy)
    jaxm = TpuMatcher(jidx, max_levels=MAX_LEVELS, compact=compact, compact_capacity=64 if compact else 0, lazy=False)
    got = port.match_topics(topics)
    want = jaxm.match_topics(topics)
    assert_same(topics, got, tidx, jidx, want)
    # device-route rows are views when lazy; host-walked rows are plain
    n_views = sum(type(r).__name__ == "SubscribersView" for r in got)
    device_rows = len(topics) - port.stats.host_fallbacks - topics.count("")
    assert n_views == (device_rows if lazy else 0)
    assert port.stats.host_fallbacks == jaxm.stats.host_fallbacks
    assert port.stats.overflows == jaxm.stats.overflows
    assert port.stats.host_fallbacks > 0  # spilled path + over-deep topics
    if compact:
        # capacity 64 is far below this batch's hits: the overflow re-run
        assert port.stats.compact_overflows == jaxm.stats.compact_overflows == 1


def test_a_clients_filters_merge_in_probe_order_as_the_jax_package_does():
    """A client with two matching filters: the device merges them in probe
    (pattern) order, the trie in its walk's order, so the merged
    Subscription's filter and identifiers map differ from the trie's — a
    fault of the JAX package's matcher that the port keeps, result for
    result (ROADMAP Queue C). Delivery (the client, its QoS) is the
    trie's."""
    ops = [("sub", "c", "a/#", 1, 3, False), ("sub", "c", "a/+/b", 2, 0, False), ("sub", "d", "z/+", 0, 0, False)]
    jidx, tidx = twin_tries(ops)
    for compact in (False, True):
        got = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=compact, device="cpu").match_topics(["a/e/b"])[0]
        want = TpuMatcher(jidx, max_levels=MAX_LEVELS, compact=compact, lazy=False).match_topics(["a/e/b"])[0]
        assert canon(got) == canon(want)
        host = tidx.subscribers("a/e/b").subscriptions["c"]
        assert got.subscriptions["c"].qos == host.qos == 2
        assert (got.subscriptions["c"].filter, host.filter) == ("a/+/b", "a/#")
        assert (got.subscriptions["c"].identifiers, host.identifiers) == ({"a/+/b": 0, "a/#": 3}, {"a/#": 3})


@LAZY
def test_adaptive_pick_serves_both_paths(corpus, lazy):
    jidx, tidx = twin_tries(corpus)
    port = TorchMatcher(tidx, max_levels=MAX_LEVELS, hits_estimate=1.0, device="cpu", lazy=lazy)
    jaxm = TpuMatcher(jidx, max_levels=MAX_LEVELS, hits_estimate=1.0, lazy=False)
    for seed in range(4):
        topics = corpus_topics(30 + seed, n=100)
        assert_same(topics, port.match_topics(topics), tidx, jidx, jaxm.match_topics(topics))
    assert port.stats.as_dict() == jaxm.stats.as_dict() | {
        "rebuild_seconds": port.stats.as_dict()["rebuild_seconds"],
    }


@LAZY
def test_saturated_and_exact_only_indexes(lazy):
    ops = saturating_ops()
    jidx, tidx = twin_tries(ops)
    topics = [o[2] for o in ops] + ["plain/topic", "wild/x", "nothing"]
    port = TorchMatcher(tidx, max_levels=4, device="cpu", lazy=lazy)
    assert_same(topics, port.match_topics(topics), tidx, jidx)
    assert port.index.n_sat >= 1
    assert port.stats.overflows >= 6
    exact = [("sub", f"c{i}", f"a/{i % 50}/b", i % 3, 0, False) for i in range(300)]
    jidx, tidx = twin_tries(exact)
    port = TorchMatcher(tidx, device="cpu", lazy=lazy)
    topics = [f"a/{i}/b" for i in range(60)] + ["a/x", ""]
    assert_same(topics, port.match_topics(topics), tidx, jidx)
    assert port.stats.host_fast == len(topics) - 1


def test_stale_matcher_rebuilds_after_churn(corpus):
    jidx, tidx = twin_tries(corpus)
    port = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu")
    topics = corpus_topics(40, n=200)
    assert_same(topics, port.match_topics(topics), tidx, jidx)
    apply_ops(churn_ops(1, corpus), jidx, tidx)
    assert port.stale
    assert_same(topics, port.match_topics(topics), tidx, jidx)
    assert port.stats.rebuilds == 2


def test_fold_matches_jax_fold(corpus):
    jidx, tidx = twin_tries(corpus)
    port = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu")
    jaxm = TpuMatcher(jidx, max_levels=MAX_LEVELS, lazy=False)
    port.rebuild()
    jaxm.rebuild()
    churn = [o for o in churn_ops(2, corpus, n=60) if not o[2].startswith(("new", "a/new"))]
    apply_ops(churn, jidx, tidx)
    filters = {o[2] for o in churn}
    assert port.fold(filters) and jaxm.fold(filters)
    assert np.array_equal(port.index.table, jaxm.index.table)
    assert np.array_equal(port.device_arrays[0].numpy().view(np.uint32), np.asarray(jaxm.device_arrays[0]))
    for a, b in zip(port.device_arrays[1:], jaxm.device_arrays[1:]):
        assert np.array_equal(a.numpy(), np.asarray(b).view(np.int32))
    topics = corpus_topics(41, n=300) + sorted(filters)
    topics = [t for t in topics if "+" not in t and "#" not in t]
    assert_same(topics, port.match_topics(topics), tidx, jidx, jaxm.match_topics(topics))


@LAZY
def test_fold_between_issue_and_resolve_keeps_the_issued_snapshot(lazy):
    ops = [("sub", f"c{i}", f"room/{i % 4}/t", 1, 0, False) for i in range(40)]
    ops.append(("sub", "w", "room/+/t", 2, 0, False))
    jidx, tidx = twin_tries(ops)
    port = TorchMatcher(tidx, max_levels=4, device="cpu", lazy=lazy)
    topics = ["room/0/t", "room/1/t"]
    before = [tidx.subscribers(t) for t in topics]
    resolver = port.match_topics_async(topics)
    tidx.unsubscribe("room/0/t", "c0")
    tidx.subscribe("late", Subscription(filter="room/1/t"))
    assert port.fold({"room/0/t", "room/1/t"})
    got = resolver()
    for g, b in zip(got, before):
        assert subscribers_equal(g, b)
    after = port.match_topics(topics)
    for g, t in zip(after, topics):
        assert subscribers_equal(g, tidx.subscribers(t))


@LAZY
def test_delta_matcher_under_churn(corpus, lazy):
    jidx, tidx = twin_tries(corpus)
    dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, device="cpu", lazy=lazy)
    jaxm = TpuMatcher(jidx, max_levels=MAX_LEVELS, lazy=False)
    try:
        topics = corpus_topics(50, n=300)
        assert_same(topics, dm.match_topics(topics), tidx, jidx)
        churn = churn_ops(3, corpus)
        apply_ops(churn, jidx, tidx)
        touched = sorted({o[2] for o in churn if "+" not in o[2] and "#" not in o[2]})
        probe = topics + touched + ["new1/q/1", "a/new3/x/y"]
        # overlay routing: pending deltas re-walk the live trie
        assert dm.pending_deltas == len(churn)
        before = dm.stats.host_fallbacks
        assert_same(probe, dm.match_topics(probe), tidx, jidx, jaxm.match_topics(probe))
        assert dm.stats.host_fallbacks > before
        dm.flush()
        assert dm.pending_deltas == 0
        assert_same(probe, dm.match_topics(probe), tidx, jidx, jaxm.match_topics(probe))
        assert dm.stats.folds + dm.stats.rebuilds >= 2
    finally:
        dm.close()


def test_delta_matcher_background_fold():
    ops = [("sub", f"c{i}", f"k/{i % 30}/v", 0, 0, False) for i in range(200)] + [("sub", "w", "k/+/v", 1, 0, False)]
    jidx, tidx = twin_tries(ops)
    dm = DeltaMatcher(tidx, max_levels=4, rebuild_after=4, rebuild_interval=0.05, device="cpu")
    try:
        apply_ops([("sub", f"n{i}", f"k/{i}/v", 2, 0, False) for i in range(8)], jidx, tidx)
        for _ in range(200):
            if dm.pending_deltas == 0:
                break
            time.sleep(0.02)
        assert dm.pending_deltas == 0
        assert dm.stats.folds >= 1
        topics = [f"k/{i}/v" for i in range(32)]
        assert_same(topics, dm.match_topics(topics), tidx, jidx)
    finally:
        dm.close()


@LAZY
def test_match_stage_end_to_end(corpus, lazy):
    jidx, tidx = twin_tries(corpus)
    dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, device="cpu", lazy=lazy)
    jaxm = TpuMatcher(jidx, max_levels=MAX_LEVELS, lazy=False)
    topics = corpus_topics(60, n=700)

    async def drive():
        stage = MatchStage(dm, tidx.subscribers, max_batch=128, latency_budget_s=None, max_pending=4096)
        stage.start()
        try:
            first = await asyncio.gather(*(stage.submit(t) for t in topics))
            apply_ops(churn_ops(4, corpus, n=40), jidx, tidx)
            second = await asyncio.gather(*(stage.submit(t) for t in topics))
            dm.flush()
            third = await asyncio.gather(*(stage.submit(t) for t in topics))
            return first, second, third, stage
        finally:
            await stage.stop()

    try:
        first, second, third, stage = asyncio.run(drive())
    finally:
        dm.close()
    # the first wave ran against the pre-churn trie: hold it against JAX's
    # matcher on a fresh pre-churn twin
    j0, t0 = twin_tries(corpus)
    assert_same(topics, first, t0, j0, TpuMatcher(j0, max_levels=MAX_LEVELS, lazy=False).match_topics(topics))
    assert_same(topics, second, tidx, jidx, jaxm.match_topics(topics))
    assert_same(topics, third, tidx, jidx)
    assert stage.admission_fallbacks == 0 and not stage.fallbacks
    assert dm.stats.batches >= 3 * (len(topics) // 128)


class _FailingMatcher:
    """A matcher whose kernel fails on the issue leg or in the resolver."""

    def __init__(self, leg):
        self.leg = leg

    def match_topics_async(self, topics):
        if self.leg == "issue":
            raise kernels.KernelError("flat_probe_ranges launch failed")

        def resolve():
            raise kernels.KernelError("flat_match_compact launch failed")

        return resolve


async def _submit_all(stage, topics):
    stage.start()
    try:
        return await asyncio.gather(*(stage.submit(t) for t in topics), return_exceptions=True)
    finally:
        await stage.stop()


@pytest.mark.parametrize("leg", ["issue", "resolve"])
def test_stage_sets_a_kernel_failure_on_the_futures(leg):
    from mqtt_tpu_torch import TopicsIndex

    tidx = TopicsIndex()
    tidx.subscribe("c", Subscription(filter="a/+", qos=1))
    stage = MatchStage(_FailingMatcher(leg), tidx.subscribers, max_batch=16, latency_budget_s=None)
    results = asyncio.run(_submit_all(stage, [f"a/{i}" for i in range(40)]))
    assert all(isinstance(r, kernels.KernelError) for r in results)
    assert not stage.fallbacks and stage.admission_fallbacks == 0


def test_kernel_failure_in_the_matcher_chain_reaches_the_caller(corpus, monkeypatch):
    from mqtt_tpu_torch.ops import matcher as matcher_mod

    def fail(*args, **kwargs):
        raise kernels.KernelError("launch failed")

    jidx, tidx = twin_tries(corpus)
    dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, device="cpu")
    try:
        # a fold whose row scatter fails raises; no silent full rebuild
        monkeypatch.setattr(matcher_mod, "scatter_rows", fail)
        apply_ops(churn_ops(5, corpus, n=20), jidx, tidx)
        rebuilds = dm.stats.rebuilds
        with pytest.raises(kernels.KernelError):
            dm.flush()
        assert dm.stats.rebuilds == rebuilds
        # a match whose kernel fails reaches each publisher through the stage
        monkeypatch.setattr(matcher_mod, "flat_match_packed", fail)
        monkeypatch.setattr(matcher_mod, "flat_match_compact", fail)
        stage = MatchStage(dm, tidx.subscribers, max_batch=64, latency_budget_s=None)
        results = asyncio.run(_submit_all(stage, corpus_topics(61, n=200)))
        assert any(isinstance(r, kernels.KernelError) for r in results)
        assert all(isinstance(r, kernels.KernelError) or subscribers_equal(r, tidx.subscribers(t))
                   for r, t in zip(results, corpus_topics(61, n=200)))
        assert not stage.fallbacks and stage.admission_fallbacks == 0
    finally:
        dm.close()


def test_background_fold_kernel_failure_fails_the_next_match(monkeypatch):
    from mqtt_tpu_torch.ops import matcher as matcher_mod

    def fail(*args, **kwargs):
        raise kernels.KernelError("scatter_rows launch failed")

    ops = [("sub", f"c{i}", f"k/{i % 30}/v", 0, 0, False) for i in range(200)] + [("sub", "w", "k/+/v", 1, 0, False)]
    jidx, tidx = twin_tries(ops)
    dm = DeltaMatcher(tidx, max_levels=4, rebuild_after=4, rebuild_interval=0.05, device="cpu")
    try:
        monkeypatch.setattr(matcher_mod, "scatter_rows", fail)
        apply_ops([("sub", f"n{i}", f"k/{i}/v", 2, 0, False) for i in range(8)], jidx, tidx)
        dm._thread.join(timeout=10)
        assert not dm._thread.is_alive()
        with pytest.raises(kernels.KernelError):
            dm.match_topics(["k/1/v"])
        assert dm.stats.folds == 0
    finally:
        dm.close()


def test_entry_points_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from mqtt_tpu_torch import TopicsIndex

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchMatcher(TopicsIndex())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeltaMatcher(TopicsIndex(), background=False)


def test_cuda_kernel_wrappers_refuse_cpu_tensors():
    import torch

    t = torch.zeros((1024, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.scatter_rows(t, torch.zeros(8, dtype=torch.int32), torch.zeros((8, 16), dtype=torch.int32))
    assert kernels.LAUNCHES["scatter_rows"] == 0


def test_compact_scratch_per_stream_with_epochs_that_skip_zero(monkeypatch):
    # K2's status words are valid only under their launch's epoch; 0 is
    # what a freshly zeroed scratch holds, so no launch may use it. A
    # launch of another layout (block count) takes a zeroed scratch of its
    # own, and the stream's epochs go on across layouts
    import torch

    monkeypatch.setattr(kernels, "_compact_scratch", {})
    monkeypatch.setattr(kernels, "_compact_epochs", {})
    dev = torch.device("cpu")
    a, e1 = kernels._compact_scratch_for(dev, 7, 10)
    b, e2 = kernels._compact_scratch_for(dev, 7, 10)
    assert a is b and (e1, e2) == (1, 2) and not a.any()
    other, e = kernels._compact_scratch_for(dev, 8, 10)
    assert other is not a and e == 1
    grown, e = kernels._compact_scratch_for(dev, 7, 5000)
    assert grown is not a and e == 3 and grown.numel() == 5000 and not grown.any()
    again, e = kernels._compact_scratch_for(dev, 7, 10)
    assert again is a and e == 4
    kernels._compact_epochs[(None, 7)] = kernels._EPOCH_MASK
    again, e = kernels._compact_scratch_for(dev, 7, 5000)
    assert again is grown and e == 1
    # a warp probes 32 // P topics (one where P > 32); a batch that fits in
    # one block of 32 warps takes one block
    assert [kernels._compact_warps(P, 4096) for P in (2, 8, 2048, 4096, 16384)] == [8, 8, 8, 4, 1]
    assert [kernels._compact_warps(8, B) for B in (1, 4, 5, 16, 128, 129)] == [1, 1, 2, 4, 32, 8]
    assert kernels._compact_warps(1024, 32) == 8 and kernels._compact_warps(1024, 16) == 16
    for P in (32768, 3):
        with pytest.raises(ValueError, match="power-of-two pattern count"):
            kernels._compact_warps(P, 16)


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, mqtt_tpu_torch, mqtt_tpu_torch.ops.kernels, mqtt_tpu_torch.staging\n"
        "import mqtt_tpu_torch.parallel, mqtt_tpu_torch.parallel.sharded\n"
        "import mqtt_tpu_torch.telemetry, mqtt_tpu_torch.tracing, mqtt_tpu_torch.utils.locked\n"
        "import mqtt_tpu_torch.ops.devicestats\n"
        "import mqtt_tpu_torch.clients, mqtt_tpu_torch.server, mqtt_tpu_torch.hooks\n"
        "import mqtt_tpu_torch.inflight, mqtt_tpu_torch.system, mqtt_tpu_torch.packets.codec\n"
        "import mqtt_tpu_torch.utils.loopwitness, mqtt_tpu_torch.utils.mempool, mqtt_tpu_torch.utils.proc\n"
        "import mqtt_tpu_torch.hooks.auth, mqtt_tpu_torch.hooks.auth.ledger, mqtt_tpu_torch.hooks.auth.auth\n"
        "import mqtt_tpu_torch.hooks.auth.allow_all, mqtt_tpu_torch.hooks.storage\n"
        "import mqtt_tpu_torch.hooks.storage.base, mqtt_tpu_torch.hooks.storage.memory\n"
        "import mqtt_tpu_torch.listeners, mqtt_tpu_torch.listeners.tcp, mqtt_tpu_torch.listeners.net\n"
        "import mqtt_tpu_torch.listeners.unixsock, mqtt_tpu_torch.listeners.mock\n"
        "import mqtt_tpu_torch.faults, mqtt_tpu_torch.hooks.chaos, mqtt_tpu_torch.scenarios\n"
        "import mqtt_tpu_torch.stress\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mqtt_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""


def test_match_tokens_matches_jax(corpus):
    import jax.numpy as jnp
    import torch

    from mqtt_tpu_torch.ops.hashing import tokenize_topics

    jidx, tidx = twin_tries(corpus)
    port = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu")
    jaxm = TpuMatcher(jidx, max_levels=MAX_LEVELS, lazy=False)
    tok1, tok2, lengths, is_dollar, _ = tokenize_topics(corpus_topics(70, n=240), MAX_LEVELS)
    got = port.match_tokens(
        torch.from_numpy(tok1.view(np.int32)), torch.from_numpy(tok2.view(np.int32)),
        torch.from_numpy(lengths), torch.from_numpy(is_dollar),
    )
    want = jaxm.match_tokens(jnp.asarray(tok1), jnp.asarray(tok2), jnp.asarray(lengths), jnp.asarray(is_dollar))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
