"""The port's fault injector (``mqtt_tpu_torch.faults``) held against the
JAX package's ``mqtt_tpu.faults`` on the CPU, with tolerance 0.

The same plans and inputs give the same results in both packages: the
``FaultPlan`` draw sequences, the entry a ``corrupt`` fault falsifies, the
reopened LogKV map after every named crash point and a torn append (and
after ``lose_unsynced``, ``tear_tail`` and ``dup_last_segment``), the
``StormPlan`` schedule and the bytes ``drive_storm`` writes, the frame
decisions of ``FlapPlan``, ``lose_gossip``, ``partition_peers`` and
``LinkShape``, and the victims of ``drop_fleet``.

Then the port's one departure: on ``TorchMatcher``'s compact route a
batch keeps its table buffer pinned until its resolver runs. The JAX
injector's ``error`` fault never runs the resolver, so that injector,
verbatim over the port's matcher, leaves the pin behind and every later
fold copies the table; the port's injector runs the resolver before it
raises.
"""

import asyncio
import random
import types

import pytest

import mqtt_tpu.faults as jfaults
import mqtt_tpu_torch.faults as tfaults
from mqtt_tpu.hooks.storage import logkv as jlogkv
from mqtt_tpu.topics import Subscribers as JSubscribers

from mqtt_tpu_torch import Subscription, TorchMatcher, subscribers_equal
from mqtt_tpu_torch.hooks.storage import logkv as tlogkv
from mqtt_tpu_torch.topics import Subscribers as TSubscribers

from test_torch_flat import twin_tries
from test_torch_matcher import canon
from test_torch_topics import corpus_ops, corpus_topics

PKGS = {"jax": (jfaults, jlogkv), "torch": (tfaults, tlogkv)}


# -- the dispatch schedule -----------------------------------------------------------

PLANS = {
    "rates": dict(seed=7, hang_rate=0.05, error_rate=0.2, issue_error_rate=0.1, corrupt_rate=0.1, slow_rate=0.15),
    "pinned": dict(seed=3, error_rate=0.3, at={0: "hang", 4: "corrupt", 9: "issue_error", 10: "slow"}),
    "quiet": dict(seed=11),
    "all-error": dict(seed=1, error_rate=1.0),
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_fault_plans_draw_the_jax_sequence(plan):
    runs = [[[p.draw(i) for i in range(300)] for p in [mod.FaultPlan(**PLANS[plan])]][0]
            for mod, _ in list(PKGS.values()) * 2]
    seqs = runs[:2]
    assert seqs[1] == seqs[0] == runs[2] == runs[3]  # one seed, one schedule, run after run
    if plan == "pinned":
        assert [seqs[1][i] for i in (0, 4, 9, 10)] == ["hang", "corrupt", "issue_error", "slow"]
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS and tfaults.CHAOS_CLIENT == jfaults.CHAOS_CLIENT
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultPlan(at={1: "melt"})


class HostBatchMatcher:
    """A 'device' matcher that walks the host trie."""

    def __init__(self, index, empty) -> None:
        self.index, self.empty = index, empty
        self.dispatches = 0

    def match_topics_async(self, topics):
        self.dispatches += 1
        return lambda: [self.index.subscribers(t) if t else self.empty() for t in topics]


@pytest.mark.parametrize("seed", [3, 8])
def test_corrupt_falsifies_the_entry_the_jax_injector_falsifies(seed):
    ops = corpus_ops(seed, n_subs=300)
    jidx, tidx = twin_tries(ops)
    topics = corpus_topics(seed + 1, n=24)
    got = {}
    for name, index, empty in (("jax", jidx, JSubscribers), ("torch", tidx, TSubscribers)):
        mod = PKGS[name][0]
        fm = mod.FaultyMatcher(HostBatchMatcher(index, empty), mod.FaultPlan(seed=seed, corrupt_rate=0.5,
                                                                                at={0: "corrupt", 1: "error"}))
        out = []
        for i in range(12):
            try:
                res = fm.match_topics(topics[i:] + topics[:i])
                out.append([canon(r) for r in res])
            except mod.DeviceFault as e:
                out.append(str(e))
        got[name] = (out, fm.injected, fm.dispatches)
    assert got["torch"] == got["jax"]
    out, injected, _ = got["torch"]
    assert injected["corrupt"] >= 1 and out[1] == "injected resolve failure (dispatch 1)"
    planted = [c for r in out[0] for c in r[0] if c == tfaults.CHAOS_CLIENT]
    assert planted == [tfaults.CHAOS_CLIENT]


def test_issue_error_slow_and_hang_as_the_jax_injector():
    for name in PKGS:
        mod = PKGS[name][0]
        _j, tidx = twin_tries(corpus_ops(2, n_subs=100))
        inner = HostBatchMatcher(tidx, TSubscribers)
        fm = mod.FaultyMatcher(inner, mod.FaultPlan(at={0: "issue_error", 1: "slow", 2: "hang"}, slow_s=0.01,
                                                    hang_s=5.0))
        with pytest.raises(mod.DeviceFault, match="injected issue failure"):
            fm.match_topics_async(["a/b"])
        assert inner.dispatches == 0  # never issued
        assert len(fm.match_topics(["a/b"])) == 1
        hung = fm.match_topics_async(["a/b"])
        fm.release.set()
        assert len(hung()) == 1
        assert fm.injected == {"issue_error": 1, "slow": 1, "hang": 1} and fm.dispatches == 3
        assert fm.index is tidx  # attribute reads fall through to the wrapped matcher
    assert tfaults.FaultyMatcher(HostBatchMatcher(tidx, TSubscribers), tfaults.FaultPlan()).wait_released(0.0)


# -- the pin a failed compact batch must not leave (the port's one departure) ----------


def _room_index():
    ops = [("sub", f"c{i}", f"room/{i % 4}/t", 1, 0, False) for i in range(40)]
    ops.append(("sub", "w", "room/+/t", 2, 0, False))
    return twin_tries(ops)[1]


@pytest.mark.parametrize("route", ["compact", "ranges"])
@pytest.mark.parametrize("injector", ["jax-verbatim", "port"])
def test_an_injected_error_leaves_no_table_pin(injector, route):
    """The compact route, an ``error`` at dispatch 0, then two folds. The
    JAX injector, verbatim over the port's matcher, never runs the
    resolver: the batch's pin stays and the second fold copies the table
    (``fold_copies``). The port's injector runs it and raises the same
    failure: no pin, no copy. The ranges route drops its pin at launch."""
    mod = jfaults if injector == "jax-verbatim" else tfaults
    tidx = _room_index()
    port = TorchMatcher(tidx, max_levels=4, compact=route == "compact", compact_capacity=64 if route == "compact"
                        else 0, device="cpu")
    port.rebuild()
    issued = port._tables[0]
    fm = mod.FaultyMatcher(port, mod.FaultPlan(at={0: "error"}))
    resolver = fm.match_topics_async(["room/0/t", "room/3/t"])
    with pytest.raises(mod.DeviceFault, match=r"injected resolve failure \(dispatch 0\)"):
        resolver()
    for k in range(2):
        tidx.subscribe(f"x{k}", Subscription(filter=f"room/{k}/t"))
        assert port.fold({f"room/{k}/t"})
    leaked = injector == "jax-verbatim" and route == "compact"
    assert issued.pins == (1 if leaked else 0)
    assert port.stats.fold_copies == (1 if leaked else 0) and port.stats.folds == 2
    assert fm.injected == {"error": 1}
    topics = [f"room/{k}/t" for k in range(4)]
    for g, t in zip(fm.match_topics(topics), topics):
        assert subscribers_equal(g, tidx.subscribers(t)), t
    if not leaked:
        assert all(b.pins == 0 for b in port._tables)


def test_a_released_hang_drops_its_pin_before_wait_released_returns():
    import threading

    tidx = _room_index()
    port = TorchMatcher(tidx, max_levels=4, compact=True, compact_capacity=64, device="cpu")
    port.rebuild()
    fm = tfaults.FaultyMatcher(port, tfaults.FaultPlan(at={0: "hang"}, hang_s=30.0))
    resolver = fm.match_topics_async(["room/1/t"])
    out = []
    t = threading.Thread(target=lambda: out.append(resolver()))
    t.start()
    assert not fm.wait_released(0.05)  # the guard thread is hung, holding its pin
    assert port._tables[0].pins == 1
    fm.release.set()
    assert fm.wait_released(5.0)
    t.join(5.0)
    assert all(b.pins == 0 for b in port._tables)
    assert subscribers_equal(out[0][0], tidx.subscribers("room/1/t"))


# -- the durable store's crash plans ------------------------------------------------


def _ops(seed, n):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        k = f"CL_{rng.randrange(40)}"
        if rng.random() < 0.2:
            out.append(("del", k, b""))
        else:
            out.append(("set", k, bytes([rng.randrange(256)]) * rng.randrange(1, 24)))
    return out


def _apply(s, kind, k, v):
    if kind == "set":
        s._set(k, v)
    else:
        s._del(k)


def _reopen(logkv, path):
    s = logkv.LogKVStore()
    s.init(logkv.LogKVOptions(path=path, gc_interval=0))
    out = (dict(s._map), s.replay_corruptions)
    s.stop()
    return out


CRASHES = [("point", p) for p in jfaults.STORAGE_CRASH_POINTS] + [
    ("append", (5, False)), ("append", (57, True)), ("append", (123, True))]


@pytest.mark.parametrize("kind,arg", CRASHES, ids=[f"{k}-{a}" for k, a in CRASHES])
def test_crash_plans_reopen_to_the_jax_map(kind, arg, tmp_path):
    assert tfaults.STORAGE_CRASH_POINTS == jfaults.STORAGE_CRASH_POINTS
    got = {}
    for name, (mod, logkv) in PKGS.items():
        path = str(tmp_path / name)
        s = logkv.LogKVStore()
        rotate = kind == "point" and arg == "rotate"
        s.init(logkv.LogKVOptions(path=path, gc_interval=0, durability_fsync="always",
                                  max_segment_bytes=512 if rotate else 1 << 20))
        if rotate:
            s.crash_plan = mod.StorageCrashPlan(crash_point="rotate")
        elif kind == "append":
            s.crash_plan = mod.StorageCrashPlan(seed=arg[0], crash_at_op=arg[0], torn=arg[1])
        fired = False
        for op in _ops(1234 if kind == "point" else 99, 300 if kind == "point" else 200):
            try:
                _apply(s, *op)
            except logkv.SimulatedCrash as e:
                fired = str(e)
                break
        if kind == "point" and not rotate:
            s.crash_plan = mod.StorageCrashPlan(crash_point=arg)
            with pytest.raises(logkv.SimulatedCrash) as e:
                s.snapshot() if arg.startswith("snapshot") else s.compact(0.0)
            fired = str(e.value)
        assert fired
        plan = s.crash_plan
        if s._file is not None:
            s._file.close()
        sizes = sorted((n, (tmp_path / name / n).stat().st_size) for n in __import__("os").listdir(path))
        got[name] = (_reopen(logkv, path), _reopen(logkv, path), fired, sizes, plan.appends_seen,
                     plan.points_seen)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][1] == 0  # a torn tail is a crash artifact, not corruption


@pytest.mark.parametrize("mutation", ["dup_last_segment", "tear_tail", "lose_unsynced"])
def test_segment_mutations_reopen_to_the_jax_map(mutation, tmp_path):
    got = {}
    for name, (mod, logkv) in PKGS.items():
        path = str(tmp_path / name)
        s = logkv.LogKVStore()
        s.init(logkv.LogKVOptions(path=path, gc_interval=0, max_segment_bytes=700,
                                  durability_fsync="off" if mutation == "lose_unsynced" else "always"))
        for i, op in enumerate(_ops(41, 150)):
            _apply(s, *op)
            if mutation == "lose_unsynced" and i == 90:
                s.sync()
        if mutation == "lose_unsynced":
            ret = mod.lose_unsynced(s)
        else:
            s.stop()
            ret = mod.dup_last_segment(path) if mutation == "dup_last_segment" else mod.tear_tail(path, seed=3)
        got[name] = (ret, _reopen(logkv, path), sorted(__import__("os").listdir(path)))
    assert got["torch"] == got["jax"]
    assert got["torch"][0]


# -- publish storms ------------------------------------------------------------------


class MemWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.drains = 0

    def write(self, b) -> None:
        self.buf += b

    async def drain(self) -> None:
        self.drains += 1


@pytest.mark.parametrize("kw", [dict(seed=7, publishers=4, msgs_per_publisher=300, payload_pad=32),
                                dict(seed=3, publishers=2, msgs_per_publisher=50, qos1_fraction=0.9,
                                     topic_space=3, topic_prefix="x/y")])
@pytest.mark.parametrize("version", [4, 5])
def test_storm_schedule_and_bytes_equal_the_jax_storm(kw, version):
    got = {}
    for name, (mod, _) in PKGS.items():
        plan = mod.StormPlan(**kw)
        writers = [MemWriter() for _ in range(plan.publishers)]
        stamps: dict = {}
        offered = asyncio.run(mod.drive_storm(writers, plan, burst=16, version=version, stamp_times=stamps))
        got[name] = (plan.schedule(), offered, [bytes(w.buf) for w in writers], [w.drains for w in writers],
                     sorted(stamps))
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["total"] == kw["publishers"] * kw["msgs_per_publisher"]


# -- the mesh helpers ----------------------------------------------------------------


class FakeTransport:
    def __init__(self, log, peer) -> None:
        self.log, self.peer = log, peer

    def abort(self) -> None:
        self.log.append(self.peer)


class FakeCluster:
    """The attributes the mesh helpers touch on a ``Cluster``."""

    def __init__(self, worker_id: int = 1, peers=(0, 2, 3, 4)) -> None:
        self.worker_id = worker_id
        self.severed: list = []
        self._writers = {p: types.SimpleNamespace(transport=FakeTransport(self.severed, p)) for p in peers}
        self._rx_filter = None
        self._rx_shaper = None
        self._stopping = False
        self.dispatched: list = []

    def _rx_dispatch(self, p, mtype, payload) -> None:
        self.dispatched.append((p, mtype, payload))


def _frames(mod_cluster, n: int, seed: int) -> list:
    rng = random.Random(seed)
    types_ = [mod_cluster._T_GOSSIP, 0x50, 0x46] + sorted(mod_cluster._CONTROL_TYPES)
    return [(rng.choice((0, 2, 3, 4)), rng.choice(types_), bytes([i % 256]) * (1 + i % 40)) for i in range(n)]


def test_gossip_loss_and_partitions_decide_as_the_jax_helpers():
    from mqtt_tpu import cluster as jcluster
    from mqtt_tpu_torch import cluster as tcluster

    got = {}
    for name, cl_mod in (("jax", jcluster), ("torch", tcluster)):
        mod = PKGS[name][0]
        frames = _frames(cl_mod, 400, 5)
        c = FakeCluster()
        rel_g = mod.lose_gossip(c, 0.4, seed=9)
        gossip = [c._rx_filter(*f) for f in frames]
        rel_p = mod.partition_peers(c, {2, 4})
        cut = [c._rx_filter(*f) for f in frames]
        rel_a = mod.asymmetric_partition(c, 0)
        asym = [c._rx_filter(*f) for f in frames]
        rel_a(), rel_p()
        after = [c._rx_filter(*f) for f in frames]
        rel_g()
        assert c._rx_filter is None
        severed = [mod.sever_peer_link(c, p) for p in (0, 9, 3)]
        got[name] = (gossip, cut, asym, after, severed, c.severed)
    assert got["torch"] == got["jax"]
    gossip = got["torch"][0]
    assert 0 < gossip.count(False) < len(gossip)


def test_flap_plans_decide_as_the_jax_schedule(monkeypatch):
    """``drive_link_flaps`` on a fake clock: the same peers severed, cut
    and healed, in the same order, and the same rx decisions meanwhile."""
    got = {}
    for name in PKGS:
        mod = PKGS[name][0]
        clock = [100.0]
        c = FakeCluster()
        decisions: list = []

        async def sleep(s, c=c, clock=clock, decisions=decisions):
            clock[0] += s
            if c._rx_filter is not None:
                decisions.append(tuple(c._rx_filter(p, 0x50, b"x") for p in (0, 2, 3, 4)))
            await asyncio.sleep(0)

        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda clock=clock: clock[0]))
        monkeypatch.setattr(mod, "_asyncio_sleep", sleep)
        plan = mod.FlapPlan(seed=21, interval_s=0.5, duration_s=8.0, partition_rate=0.4, partition_hold_s=1.3)
        n = asyncio.run(mod.drive_link_flaps(c, plan))
        got[name] = (n, c.severed, decisions, c._rx_filter)
    assert got["torch"] == got["jax"]
    n, severed, decisions, rx = got["torch"]
    assert n == len(severed) > 5 and rx is None and any(False in d for d in decisions)


def _data_frames(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [(rng.choice((0, 2, 3, 4)), rng.choice((0x50, 0x46)), bytes([i % 256]) * (1 + i % 40)) for i in range(n)]


@pytest.mark.parametrize("shape", [dict(seed=4, loss=0.3), dict(seed=5, loss=0.2, delay_s=0.002, jitter_s=0.001),
                                   dict(seed=6, rate_bytes_s=2e6, loss=0.1)])
def test_link_shapes_decide_as_the_jax_shaper(shape):
    """A loss-only shape drops control frames (no delay otherwise) and
    delays lost data frames; a delayed shape is fed data frames only, so
    every frame it holds back is delivered later, in order."""
    from mqtt_tpu import cluster as jcluster
    from mqtt_tpu_torch import cluster as tcluster

    delayed = bool(shape.get("delay_s") or shape.get("rate_bytes_s"))
    got = {}
    for name, cl_mod in (("jax", jcluster), ("torch", tcluster)):
        mod = PKGS[name][0]
        frames = _data_frames(300, 8) if delayed else _frames(cl_mod, 300, 8)

        async def drive(mod=mod, frames=frames, control=cl_mod._CONTROL_TYPES):
            c = FakeCluster(worker_id=2)
            release = mod.shape_cluster_links(c, mod.LinkShape(**shape), peers=[0, 3, 4])
            verdicts = [await c._rx_shaper(*f) for f in frames]
            want = sum(1 for f, v in zip(frames, verdicts) if not v and f[1] not in control)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 20.0
            while len(c.dispatched) < want and loop.time() < deadline:
                await asyncio.sleep(0.005)
            release()
            # each link delivers in order; links interleave by the clock
            return verdicts, {p: [d for d in c.dispatched if d[0] == p] for p in (0, 2, 3, 4)}

        got[name] = asyncio.run(drive())
    assert got["torch"] == got["jax"]
    verdicts, dispatched = got["torch"]
    assert False in verdicts and sum(map(len, dispatched.values())) > 0


@pytest.mark.parametrize("n,k,seed", [(40, 30, 7), (10, 0, 1), (5, 9, 3), (100, 17, 12345)])
def test_drop_fleet_aborts_the_jax_victims(n, k, seed):
    got = {}
    for name in PKGS:
        mod = PKGS[name][0]
        log: list = []
        writers = [types.SimpleNamespace(transport=FakeTransport(log, i)) for i in range(n)]
        got[name] = (mod.drop_fleet(writers, k, seed), log)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == sorted(got["torch"][1]) and len(got["torch"][0]) == min(k, n)
