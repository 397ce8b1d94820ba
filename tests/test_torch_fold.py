"""The fold's device table on the CPU: two buffers written in place.

``TorchMatcher`` keeps its bucket table in two buffers, live and a standby
one fold behind, and a fold writes its rows (and the previous fold's) into
the standby in place (K3 ``scatter_rows``, its plain version here), where
the JAX package's fold makes a new table. These tests hold the live table
after each fold to the JAX fold's, bit for bit; show that a batch issued
before one or two folds resolves to the snapshot it was issued against,
on the ranges path, the compact path and the compact path's re-run, while
a batch after them equals the trie's walk; that a standby a batch still
pins takes the counted copy; and that a thread folding while another
matches leaves every answer equal to the trie's.
"""

import sys
import threading
import time

import numpy as np
import pytest

from mqtt_tpu.ops.matcher import TpuMatcher

from mqtt_tpu_torch import DeltaMatcher, Subscription, TopicsIndex, TorchMatcher, subscribers_equal

from test_torch_flat import apply_ops, twin_tries
from test_torch_matcher import churn_ops
from test_torch_topics import MAX_LEVELS, corpus_ops


def _tables(m):
    """The live and standby buffers' tables, as u32 numpy arrays."""
    return [b.table.numpy().view(np.uint32).copy() for b in m._tables]


@pytest.mark.parametrize("seed", [3, 11, 19])
def test_in_place_fold_equals_the_jax_fold_after_each_of_three(seed):
    ops = corpus_ops(seed, n_subs=1500)
    jidx, tidx = twin_tries(ops)
    port = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu")
    jaxm = TpuMatcher(jidx, max_levels=MAX_LEVELS, lazy=False)
    port.rebuild()
    jaxm.rebuild()
    live, standby = _tables(port)
    assert np.array_equal(live, standby)
    for r in range(3):
        churn = [o for o in churn_ops(seed * 10 + r, ops, n=60) if not o[2].startswith(("new", "a/new"))]
        apply_ops(churn, jidx, tidx)
        previous = live
        filters = {o[2] for o in churn}
        assert port.fold(filters) and jaxm.fold(filters)
        live, standby = _tables(port)
        assert np.array_equal(live, np.asarray(jaxm.device_arrays[0])), f"fold {r + 1}"
        assert np.array_equal(live, port.index.table)
        # the standby is the table one fold behind
        assert np.array_equal(standby, previous), f"fold {r + 1}"
        for a, b in zip(port.device_arrays[1:], jaxm.device_arrays[1:]):
            assert np.array_equal(a.numpy(), np.asarray(b).view(np.int32))
    assert port.stats.folds == 3 and port.stats.fold_copies == 0
    assert all(b.pins == 0 for b in port._tables)


def _room_index():
    ops = [("sub", f"c{i}", f"room/{i % 4}/t", 1, 0, False) for i in range(40)]
    ops.append(("sub", "w", "room/+/t", 2, 0, False))
    return twin_tries(ops)[1]


# the batch's route: ranges (K1), compact (K2) and a compact batch whose
# hits outgrow its buffer, re-run on the ranges path by its resolver
ROUTES = pytest.mark.parametrize("route", ["ranges", "compact", "compact-rerun"])


def _matcher(tidx, route, lazy=True):
    cap = {"ranges": 0, "compact": 64, "compact-rerun": 4}[route]
    return TorchMatcher(tidx, max_levels=4, compact=route != "ranges", compact_capacity=cap, device="cpu",
                        lazy=lazy)


@ROUTES
@pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])
def test_two_folds_between_issue_and_resolve_keep_the_issued_snapshot(route, lazy):
    tidx = _room_index()
    port = _matcher(tidx, route, lazy)
    topics = ["room/0/t", "room/1/t", "room/2/t"]
    before = [tidx.subscribers(t) for t in topics]
    resolver = port.match_topics_async(topics)
    tidx.unsubscribe("room/0/t", "c0")
    tidx.subscribe("late", Subscription(filter="room/1/t"))
    assert port.fold({"room/0/t", "room/1/t"})
    tidx.unsubscribe("room/2/t", "c2")
    tidx.subscribe("later", Subscription(filter="room/0/t", qos=2))
    assert port.fold({"room/2/t", "room/0/t"})
    for g, b, t in zip(resolver(), before, topics):
        assert subscribers_equal(g, b), t
    # only a compact batch holds its buffer until it resolves: the second
    # fold found it as the standby and wrote a fresh copy
    assert port.stats.fold_copies == (0 if route == "ranges" else 1)
    assert port.stats.compact_overflows == (route == "compact-rerun")
    assert all(b.pins == 0 for b in port._tables)
    assert np.array_equal(port.device_arrays[0].numpy().view(np.uint32), port.index.table)
    for g, t in zip(port.match_topics(topics), topics):
        assert subscribers_equal(g, tidx.subscribers(t)), t
    assert port.stats.host_fallbacks == 0


@ROUTES
def test_a_pinned_standby_takes_the_counted_copy(route):
    tidx = _room_index()
    port = _matcher(tidx, route)
    topics = ["room/0/t", "room/3/t"]
    before = [tidx.subscribers(t) for t in topics]
    port.rebuild()
    issued = port._tables[0]
    resolver = port.match_topics_async(topics)
    # a batch left unresolved: on the compact path it keeps its pin
    port.match_topics_async(topics)
    assert issued.pins == (0 if route == "ranges" else 2)
    for k in range(4):
        tidx.subscribe(f"x{k}", Subscription(filter=f"room/{k % 4}/t", qos=k % 3))
        assert port.fold({f"room/{k % 4}/t"})
        assert np.array_equal(port.device_arrays[0].numpy().view(np.uint32), port.index.table), k
    # the pinned buffer left the pair at the second fold, and stays out
    copies = 0 if route == "ranges" else 1
    assert port.stats.fold_copies == copies and port.stats.folds == 4
    assert (issued in port._tables) == (route == "ranges")
    for g, b, t in zip(resolver(), before, topics):
        assert subscribers_equal(g, b), t
    assert issued.pins == (0 if route == "ranges" else 1)
    for g, t in zip(port.match_topics(topics), topics):
        assert subscribers_equal(g, tidx.subscribers(t)), t
    assert all(b.pins == 0 for b in port._tables)
    # a rebuild uploads both buffers anew; the folds go on in place
    port.rebuild()
    live, standby = _tables(port)
    assert np.array_equal(live, standby) and np.array_equal(live, port.index.table)
    tidx.subscribe("y", Subscription(filter="room/2/t"))
    assert port.fold({"room/2/t"})
    assert port.stats.fold_copies == copies
    assert np.array_equal(port.device_arrays[0].numpy().view(np.uint32), port.index.table)


def test_a_failed_fold_leaves_both_buffers_to_the_rebuild(monkeypatch):
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.ops import matcher as matcher_mod

    def fail(*args, **kwargs):
        raise kernels.KernelError("scatter_rows launch failed")

    tidx = _room_index()
    port = _matcher(tidx, "ranges")
    port.rebuild()
    live = port.device_arrays[0].clone()
    pair = list(port._tables)
    tidx.subscribe("z", Subscription(filter="room/1/t"))
    monkeypatch.setattr(matcher_mod, "scatter_rows", fail)
    with pytest.raises(kernels.KernelError):
        port.fold({"room/1/t"})
    monkeypatch.undo()
    # the live table and the pair are untouched, and folding is poisoned
    # (read off the state: the stale matcher's device_arrays would rebuild)
    assert port._tables == pair and port._state[1][0] is pair[0].table
    assert np.array_equal(pair[0].table.numpy(), live.numpy())
    assert not port.fold({"room/1/t"})
    port.rebuild()
    assert port._tables != pair
    for g, t in zip(port.match_topics(["room/1/t"]), ["room/1/t"]):
        assert subscribers_equal(g, tidx.subscribers(t))


@pytest.mark.parametrize("route", ["ranges", "compact-rerun"])
def test_a_thread_folding_while_another_matches_equals_the_trie(route):
    # one thread mutates the trie and folds; the other issues batches and
    # resolves them, and holds the trie still while a batch is in flight
    # and checked. The folds run during the batches.
    paths = [f"s/{p}/v" for p in range(24)]
    tidx = TopicsIndex()
    for i in range(240):
        tidx.subscribe(f"c{i}", Subscription(filter=paths[i % 24], qos=i % 3))
    tidx.subscribe("w", Subscription(filter="s/+/v", qos=1))
    cap = 0 if route == "ranges" else 8
    # a window of 63 ids a path keeps every path on the device as it grows
    dm = DeltaMatcher(tidx, max_levels=4, background=False, window=63, compact=route != "ranges",
                      compact_capacity=cap, device="cpu")
    topics = (paths + ["s/x/v", "s/1/w"]) * 20
    trie = threading.Lock()
    stop = threading.Event()
    errors = []

    def folder():
        rng = np.random.default_rng(4)
        try:
            for r in range(60):
                with trie:
                    for _ in range(4):
                        p = paths[int(rng.integers(0, 24))]
                        cid = f"c{int(rng.integers(0, 240))}"
                        if rng.random() < 0.5:
                            tidx.unsubscribe(p, cid)
                        else:
                            tidx.subscribe(cid, Subscription(filter=p, qos=r % 3))
                dm.flush()
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)
        finally:
            stop.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=folder)
    batches = 0
    try:
        t.start()
        while not stop.is_set() or batches < 20:
            with trie:
                resolver = dm.match_topics_async(topics)
                got = resolver()
                for g, tp in zip(got, topics):
                    assert subscribers_equal(g, tidx.subscribers(tp)), tp
            batches += 1
            time.sleep(0.0002)  # the lock is not fair: let the folder take it
        t.join()
    finally:
        sys.setswitchinterval(old)
        stop.set()
        t.join()
        dm.close()
    assert not errors, errors
    assert dm.stats.folds >= 30 and dm.stats.rebuilds == 1
    assert all(b.pins == 0 for b in dm.snapshot._tables)
    assert np.array_equal(dm.snapshot.device_arrays[0].numpy().view(np.uint32), dm.snapshot.index.table)
