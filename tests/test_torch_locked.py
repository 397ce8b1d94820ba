"""The port's lock plane (``mqtt_tpu_torch.utils.locked``) against the JAX
package's (``mqtt_tpu.utils.locked``), on the CPU.

Every scenario runs the same acquisitions on a FRESH ``LockPlane()`` of
each package, with locks bound to that plane; neither package's
``DEFAULT_PLANE`` is armed or read here, and no JAX lock is nested by hand
outside such a fresh plane. The witness's ``edges`` (with their evidence:
thread name and held stack) and ``violations`` must be identical, as must
the ``LockStats`` counts (acquisitions, contended acquisitions, holds
recorded) and a seeded ``PreemptionInjector``'s per-thread decision trace.
Scenarios: a cycle of two and of three names, a re-entrant acquire of an
``RLock`` under another lock (no edge from the re-entry), a non-blocking
miss, the raising tripwire, and named threads run one after another under
the injector. Then the port's own locks: the trie, the retained store,
``PredicateEngine``, ``TenantPlane`` and ``KeyRegistry`` take instrumented
locks under the JAX package's names, on the port's own plane.
"""

import threading

import pytest

from mqtt_tpu.utils import locked as jlocked

from mqtt_tpu_torch import KeyRegistry, PredicateEngine, TenantPlane, TopicsIndex
from mqtt_tpu_torch.packets import PUBLISH, FixedHeader, Packet
from mqtt_tpu_torch.utils import locked as tlocked

PACKAGES = (jlocked, tlocked)


def _plane(pkg, witness=True, stats=True, raise_on_cycle=False):
    plane = pkg.LockPlane()
    if stats:
        plane.arm()
    if witness:
        plane.arm_witness(raise_on_cycle=raise_on_cycle)
    return plane


def _stats(plane) -> dict:
    return {
        st.name: (st.acquisitions, st.contended, st.hold_hist.count, st.wait_hist.count)
        for st in plane.snapshot()
    }


def _run_named(name: str, fn) -> None:
    """Run ``fn`` on a thread named ``name`` and wait for it."""
    err = []

    def body():
        try:
            fn()
        except BaseException as e:  # surfaced below
            err.append(e)

    t = threading.Thread(target=body, name=name)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    if err:
        raise err[0]


def _cycle_two(pkg, plane):
    a = pkg.InstrumentedLock("a", plane=plane)
    b = pkg.InstrumentedLock("b", plane=plane)
    with a, b:
        pass
    with b, a:
        pass


def _cycle_three(pkg, plane):
    x, y, z = (pkg.InstrumentedLock(n, plane=plane) for n in "xyz")
    for first, second in ((x, y), (y, z), (z, x)):
        with first, second:
            pass


def _reentrant(pkg, plane):
    r = pkg.InstrumentedLock("topics_trie", rlock=True, plane=plane)
    m = pkg.InstrumentedLock("metrics_registry", plane=plane)
    with r:
        with m:
            with r:  # re-entrant: no (metrics_registry, topics_trie) edge
                with r:
                    pass
        with r:
            pass
    held = pkg.InstrumentedLock("retained", plane=plane)
    held.acquire()
    try:
        missed = []
        # a non-blocking miss from another thread counts nothing
        _run_named("prober", lambda: missed.append(held.acquire(blocking=False)))
        assert missed == [False]
    finally:
        held.release()


def _diamond(pkg, plane):
    top, left, right, bottom = (pkg.InstrumentedLock(n, plane=plane) for n in ("top", "left", "right", "bottom"))
    for mid in (left, right):
        with top, mid, bottom:
            pass


SCENARIOS = {"cycle_two": _cycle_two, "cycle_three": _cycle_three, "reentrant": _reentrant, "diamond": _diamond}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_witness_edges_violations_and_stats_match(name):
    got = []
    for pkg in PACKAGES:
        plane = _plane(pkg)
        _run_named(f"scenario-{name}", lambda: SCENARIOS[name](pkg, plane))
        w = plane.witness
        got.append((dict(w.edges), list(w.violations), _stats(plane), w.held()))
    assert got[1] == got[0]
    edges, violations, _stats_, _ = got[1]
    if name == "cycle_two":
        assert len(violations) == 1 and set(edges) == {("a", "b"), ("b", "a")}
    elif name == "cycle_three":
        assert len(violations) == 1 and "x" in violations[0]
    elif name == "reentrant":
        assert set(edges) == {("topics_trie", "metrics_registry")} and not violations
        assert _stats_["topics_trie"][:3] == (1, 0, 1)  # the outermost acquire only
    else:
        assert not violations and len(edges) == 5


def test_raising_tripwire_fails_the_closing_acquire_alike():
    outcomes = []
    for pkg in PACKAGES:
        plane = _plane(pkg, raise_on_cycle=True)
        a = pkg.InstrumentedLock("a", plane=plane)
        b = pkg.InstrumentedLock("b", plane=plane)
        with a, b:
            pass
        with b:
            with pytest.raises(AssertionError) as exc:
                a.acquire()
            assert isinstance(exc.value, pkg.LockOrderViolation)
        # the refused acquire left nothing held: both are free again
        assert not a.locked() and not b.locked()
        outcomes.append((str(exc.value), list(plane.witness.violations), _stats(plane)))
    assert outcomes[1] == outcomes[0]


def test_disarmed_and_witness_only_planes_match():
    rows = []
    for pkg in PACKAGES:
        quiet = _plane(pkg, witness=False, stats=False)
        witness_only = _plane(pkg, stats=False)
        for plane in (quiet, witness_only):
            a = pkg.InstrumentedLock("a", plane=plane)
            b = pkg.InstrumentedLock("b", plane=plane)
            with a, b:
                pass
        rows.append((quiet.active, witness_only.active, _stats(quiet), _stats(witness_only),
                     dict(witness_only.witness.edges)))
    assert rows[1] == rows[0]
    assert rows[1][:2] == (False, True) and rows[1][2] == rows[1][3] == {"a": (0, 0, 0, 0), "b": (0, 0, 0, 0)}


@pytest.mark.parametrize("seed", [3, 11])
def test_seeded_preemption_trace_matches(seed):
    traces = []
    for pkg in PACKAGES:
        plane = _plane(pkg)
        inj = pkg.PreemptionInjector(seed, rate=0.5, pause_s=0.0, names=frozenset({"tenants", "topics_trie"}))
        plane.arm_fuzz(inj)
        locks = {n: pkg.InstrumentedLock(n, rlock=n == "topics_trie", plane=plane)
                 for n in ("tenants", "topics_trie", "recrypt_keys")}

        def work(order):
            for rounds in range(3):
                for n in order:
                    with locks[n]:
                        if n == "topics_trie":
                            with locks["recrypt_keys"]:
                                pass

        for k, order in enumerate((("tenants", "topics_trie"), ("topics_trie",), ("recrypt_keys", "tenants"))):
            _run_named(f"fuzz-{k}", lambda order=order: work(order))
        plane.disarm_fuzz()
        traces.append((inj.trace(), dict(plane.witness.edges), list(plane.witness.violations), _stats(plane)))
    assert traces[1] == traces[0]
    trace = traces[1][0]
    assert set(trace) == {"fuzz-0", "fuzz-1", "fuzz-2"}
    assert any(hit for ops in trace.values() for *_, hit in ops)
    assert all(name in ("tenants", "topics_trie") for ops in trace.values() for _, name, _, _ in ops)


def test_lock_stats_records_and_reset_match():
    rows = []
    for pkg in PACKAGES:
        plane = _plane(pkg, witness=False)
        lock = pkg.InstrumentedLock("clients", plane=plane)
        for _ in range(5):
            with lock:
                pass
        st = plane.stats("clients")
        before = (st.acquisitions, st.contended, st.hold_hist.count, sorted(st.as_dict()))
        plane.reset()
        after = (st.acquisitions, st.contended, st.hold_hist.count, st is plane.stats("clients"))
        rows.append((before, after, plane.top_contended(), plane.wait_share("clients")))
    assert rows[1] == rows[0]
    assert rows[1][0][:3] == (5, 0, 5) and rows[1][1] == (0, 0, 0, True)


def test_lock_names_are_the_jax_packages():
    assert tlocked.LOCK_NAMES == jlocked.LOCK_NAMES
    # the port's plane is an object of its own module
    assert type(tlocked.DEFAULT_PLANE).__module__ == "mqtt_tpu_torch.utils.locked"


def _lock_name(lock):
    assert isinstance(lock, tlocked.InstrumentedLock), type(lock)
    assert lock._plane is tlocked.DEFAULT_PLANE
    return lock.stats.name


def test_port_takes_instrumented_locks_under_the_jax_names():
    index = TopicsIndex()
    assert _lock_name(index._lock) == "topics_trie"
    assert index._lock._inner.__class__ is threading.RLock().__class__
    assert _lock_name(TopicsIndex(lock_name="cluster_remote_trie")._lock) == "cluster_remote_trie"
    assert _lock_name(index.retained._lock) == "retained"
    assert _lock_name(PredicateEngine(device="cpu")._lock) == "predicate_rules"
    plane = TenantPlane()
    assert _lock_name(plane._lock) == "tenants"
    assert _lock_name(plane.keys._lock) == "recrypt_keys"
    assert _lock_name(KeyRegistry()._lock) == "recrypt_keys"
    # the trie's per-node containers keep a bare lock
    index.subscribe("c", __import__("mqtt_tpu_torch").Subscription(filter="a/+", qos=1))
    node = index.root.particles["a"].particles["+"]
    assert not isinstance(node.subscriptions._lock, tlocked.InstrumentedLock)


def test_port_plane_witnesses_the_retain_path():
    """Armed, the port's own plane sees the trie's lock taken around the
    retained store's, the order the JAX package's static graph has, and
    no violation; the re-entrant trie lock records no self-edge."""
    plane = tlocked.DEFAULT_PLANE
    w = plane.arm_witness()
    plane.arm()
    try:
        index = TopicsIndex()
        pk = Packet(fixed_header=FixedHeader(type=PUBLISH, retain=True), topic_name="a/b", payload=b"x")
        _run_named("retainer", lambda: index.retain_message(pk))
        _run_named("reader", lambda: index.messages("a/+"))
        assert ("topics_trie", "retained") in w.edges
        assert all(a != b for a, b in w.edges)
        assert not w.violations
        assert plane.stats("topics_trie").acquisitions >= 1 and plane.stats("retained").acquisitions >= 2
    finally:
        plane.disarm()
        plane.disarm_witness()
    assert not plane.active
