"""The port's breaker (``mqtt_tpu_torch.resilience``) held against the JAX
package's ``mqtt_tpu.resilience`` on the CPU.

The unit cases of ``tests/test_resilience.py`` (the backoff schedule, the
breaker's state machine, the guard pool's wedge accounting, and the
matcher wrapper under injected faults) run in both packages on the same
inputs and must agree: the same delays, the same breaker dictionaries, the
same results and counters. Each package's wrapper runs over its own
package's injector (``faults.FaultyMatcher`` with the same seeded
``FaultPlan``) around its own host-walking double.

Then the port's own concerns: four threads issuing into one
``TorchMatcher`` at once give the serial results (the breaker's guard
threads issue concurrently), and on a seeded corpus whose clients hold
several filters matching one topic (the device merges them in probe order,
the trie in walk order: ROADMAP Queue C), the port's wrapper over
``TorchMatcher`` flags exactly the batches the JAX wrapper over
``TpuMatcher`` flags.
"""

import sys
import threading
import time

import pytest

from mqtt_tpu import resilience as jres
from mqtt_tpu import faults as jfaults
from mqtt_tpu.ops.matcher import TpuMatcher, subscribers_equal as jequal
from mqtt_tpu.topics import Subscribers as JSubscribers

from mqtt_tpu_torch import DeltaMatcher, Subscription, TorchMatcher
from mqtt_tpu_torch import faults as tfaults
from mqtt_tpu_torch import resilience as tres
from mqtt_tpu_torch.ops.matcher import subscribers_equal as tequal
from mqtt_tpu_torch.topics import Subscribers as TSubscribers

from test_torch_flat import apply_ops, twin_tries
from test_torch_matcher import canon
from test_torch_topics import MAX_LEVELS, corpus_ops, corpus_topics

PACKAGES = {"jax": (jres, JSubscribers, jequal), "torch": (tres, TSubscribers, tequal)}
FAULTS = {"jax": jfaults, "torch": tfaults}
FaultPlan, FaultyMatcher = tfaults.FaultPlan, tfaults.FaultyMatcher  # the port's side


class HostBatchMatcher:
    """A 'device' matcher that walks the host trie (the JAX suite's
    double): healthy dispatches equal the walk by construction, so any
    divergence is the injected fault."""

    def __init__(self, index, empty) -> None:
        self.index = index
        self.empty = empty
        self.dispatches = 0

    def match_topics_async(self, topics):
        self.dispatches += 1
        index, empty = self.index, self.empty

        def resolve():
            return [index.subscribers(t) if t else empty() for t in topics]

        return resolve

    def close(self) -> None:
        pass


SMALL = [("sub", "alice", "a/+", 1, 0, False), ("sub", "bob", "a/b", 0, 0, False),
         ("sub", "carol", "c/#", 0, 0, False)]
TOPICS = ["a/b", "a/x", "c/d/e", "nope"]


def fast_config(mod, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("watchdog_s", 0.2)
    kw.setdefault("probe_backoff_s", 0.03)
    kw.setdefault("probe_backoff_max_s", 0.2)
    kw.setdefault("probe_jitter", 0.0)
    kw.setdefault("probe_successes", 1)
    kw.setdefault("verify_sample", 8)
    kw.setdefault("seed", 7)
    return mod.BreakerConfig(**kw)


def breaker_view(d: dict) -> dict:
    """A breaker dictionary without the wedged-thread gauge (a thread count)."""
    return {k: v for k, v in d.items() if k != "wedged_workers"}


# -- the backoff schedule and the breaker's state machine --------------------------


@pytest.mark.parametrize("seed", [0, 5, 7, 42])
@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_backoff_schedule_equals_the_jax_package(seed, jitter):
    got = []
    for name in ("jax", "torch"):
        mod = PACKAGES[name][0]
        a = mod.Backoff(initial=0.1, maximum=1.0, jitter=jitter, seed=seed)
        seq = [a.next() for _ in range(8)]
        a.reset()
        seq.append(a.next())
        huge = mod.Backoff(initial=0.05, maximum=2.0, jitter=0.0)
        seq.append(max(huge.next() for _ in range(1200)))  # the exponent is clamped
        got.append(seq)
    assert got[0] == got[1]
    seq = got[1]
    assert seq[0] < seq[2] < seq[4] and all(d <= 1.0 * (1 + jitter) + 1e-9 for d in seq[:8])
    assert seq[-1] == 2.0


def test_backoff_jitter_desyncs_seeds():
    seqs = {tuple(round(tres.Backoff(0.1, 1.0, seed=s).next(), 6) for _ in range(4)) for s in range(5)}
    assert len(seqs) > 1


def _breaker_script(mod, case):
    """One of the JAX suite's breaker scenarios on a fake clock; the
    breaker's dictionary and state after every step."""
    t = [0.0]
    kw = {"trips": dict(failure_threshold=3), "half_open": dict(failure_threshold=1, probe_successes=2),
          "slot": dict(failure_threshold=1), "stale": dict(failure_threshold=1, probe_successes=1)}[case]
    br = mod.CircuitBreaker(clock=lambda: t[0], backoff=mod.Backoff(initial=1.0, maximum=8.0, jitter=0.0), **kw)
    steps = {
        "trips": [br.record_failure, br.record_failure, br.record_success, br.record_failure,
                  br.record_failure, br.allow, br.record_failure, br.allow],
        "half_open": [lambda: br.record_failure("hang"), br.acquire_probe, br.seconds_until_probe,
                      lambda: t.__setitem__(0, 1.5), br.acquire_probe, lambda: br.record_probe_failure("error"),
                      br.seconds_until_probe, lambda: t.__setitem__(0, 10.0), br.acquire_probe,
                      br.record_probe_success, lambda: t.__setitem__(0, 20.0), br.acquire_probe,
                      br.record_probe_success, br.allow],
        "slot": [br.record_failure, lambda: t.__setitem__(0, 5.0), br.acquire_probe, br.acquire_probe,
                 lambda: br.acquire_probe(force=True)],
        "stale": [br.record_failure, lambda: t.__setitem__(0, 5.0), br.acquire_probe, br.record_success,
                  br.acquire_probe, lambda: br.record_failure("hang"), br.record_probe_success],
    }[case]
    trace = []
    for step in steps:
        trace.append((step(), br.state, br.as_dict()))
    return trace


@pytest.mark.parametrize("case", ["trips", "half_open", "slot", "stale"])
def test_breaker_state_machine_equals_the_jax_package(case):
    j, t = _breaker_script(jres, case), _breaker_script(tres, case)
    assert t == j
    final = t[-1][2]
    if case == "trips":
        assert final["state"] == "open" and final["trips"] == 1
    elif case == "half_open":
        assert final["state"] == "closed" and final["trips"] == 2 and final["probes"] == 3
        assert final["failures_hang"] == 1 and final["failures_error"] == 1
    elif case == "slot":
        assert [s[0] for s in t[2:]] == [True, False, True]
    else:
        assert final["state"] == "closed" and final["probe_failures"] == 0


def test_breaker_trip_observer_runs_outside_its_lock():
    seen = []
    br = tres.CircuitBreaker(failure_threshold=1, on_trip=lambda: seen.append(br._lock.locked()))
    br.record_failure()
    assert seen == [False] and br.state == "open"


# -- the guard pool ----------------------------------------------------------------


def test_guard_pool_abandons_a_hang_and_recovers_capacity():
    pool = tres.GuardPool(workers=1)
    release = threading.Event()
    task = pool.submit(lambda: (release.wait(5), "late")[1])
    with pytest.raises(tres.GuardTimeout):
        task.wait(0.05)
    pool.report_wedged(task)
    assert pool.wedged == 1
    assert pool.submit(lambda: "fresh").wait(2) == "fresh"
    release.set()
    deadline = time.monotonic() + 2
    while pool.wedged and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.wedged == 0
    pool.close()


def test_guard_pool_completion_racing_the_report_is_not_a_wedge():
    pool = tres.GuardPool(workers=1)
    release = threading.Event()
    task = pool.submit(lambda: (release.wait(5), "late")[1])
    with pytest.raises(tres.GuardTimeout):
        task.wait(0.05)
    release.set()
    task._done.wait(2)
    pool.report_wedged(task)
    assert pool.wedged == 0
    assert pool.submit(lambda: "still-served").wait(2) == "still-served"
    assert pool.live_unwedged == 1
    pool.close()


def test_guard_pool_wedges_past_the_cap_bound_threads_and_recover():
    pool = tres.GuardPool(workers=1)
    pool.MAX_WEDGED = 2
    releases = []
    for _ in range(4):
        ev = threading.Event()
        releases.append(ev)
        task = pool.submit(lambda ev=ev: ev.wait(10))
        with pytest.raises(tres.GuardTimeout):
            task.wait(0.1)
        pool.report_wedged(task)
    assert pool.wedged == 4 and pool.live_unwedged <= 0
    for ev in releases:
        ev.set()
    deadline = time.monotonic() + 3
    while pool.wedged and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.wedged == 0
    assert pool.submit(lambda: "after").wait(2) == "after"
    assert pool.live_unwedged >= 1
    pool.close()


def test_guard_pool_ferries_exceptions_to_the_waiter():
    pool = tres.GuardPool(workers=1)
    with pytest.raises(ZeroDivisionError):
        pool.submit(lambda: 1 / 0).wait(2)
    pool.close()


# -- the wrapper under injected faults, in both packages -----------------------------

FAULT_CASES = {
    # plan kwargs, breaker kwargs, batches
    "error-trips": (dict(at={0: "error", 1: "error", 2: "error"}), dict(probe_backoff_s=30.0,
                                                                          probe_backoff_max_s=60.0), 4),
    "issue-error": (dict(at={0: "issue_error"}), dict(failure_threshold=1, probe_backoff_s=30.0,
                                                      probe_backoff_max_s=60.0), 1),
    "corrupt": (dict(at={0: "corrupt"}), dict(failure_threshold=1, probe_backoff_s=30.0,
                                              probe_backoff_max_s=60.0), 2),
    "slow": (dict(at={0: "slow"}, slow_s=0.05), dict(watchdog_s=1.0), 2),
    "hang": (dict(at={0: "hang"}, hang_s=10.0), dict(failure_threshold=1, probe_backoff_s=30.0,
                                                     probe_backoff_max_s=60.0), 1),
    "seeded": (dict(seed=3, error_rate=0.3, corrupt_rate=0.2), dict(failure_threshold=5, probe_backoff_s=30.0,
                                                                     probe_backoff_max_s=60.0), 12),
}


def _faults_run(name, case):
    mod, Empty, equal = PACKAGES[name]
    plan_kw, cfg_kw, n = FAULT_CASES[case]
    jidx, tidx = twin_tries(SMALL)
    index = jidx if name == "jax" else tidx
    inner = HostBatchMatcher(index, Empty)
    faults = FAULTS[name]
    faulty = faults.FaultyMatcher(inner, faults.FaultPlan(**plan_kw))
    rm = mod.ResilientMatcher(faulty, index, fast_config(mod, **cfg_kw))
    try:
        out = []
        for _ in range(n):
            t0 = time.monotonic()
            res = rm.match_topics(TOPICS)
            assert time.monotonic() - t0 < 2.0  # never past the watchdog's reach
            out.append([canon(r) for r in res])
            assert all(equal(r, index.subscribers(t)) for t, r in zip(TOPICS, res))  # the walk's answer
        return out, breaker_view(rm.breaker_gauges()), inner.dispatches, rm.pool.wedged, faulty.injected
    finally:
        faulty.release.set()
        rm.close()


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_faults_resolve_as_the_jax_wrapper_does(case):
    j, t = _faults_run("jax", case), _faults_run("torch", case)
    assert t == j
    gauges = t[1]
    if case in ("error-trips", "issue-error", "corrupt", "hang"):
        assert gauges["state"] == "open" and gauges["fallback_batches"] >= 1
    if case == "error-trips":
        assert gauges["failures_error"] == 3 and t[2] == 3  # OPEN: the device is not dispatched
    if case == "hang":
        assert gauges["failures_hang"] == 1 and t[3] == 1
    if case == "slow":
        assert gauges["state"] == "closed" and gauges["failures"] == 0
    if case == "seeded":
        assert gauges["failures"] > 0 and gauges["verified_batches"] > 0


def test_half_open_recovery_readmits_the_device():
    jidx, tidx = twin_tries(SMALL)
    inner = HostBatchMatcher(tidx, TSubscribers)
    rm = tres.ResilientMatcher(FaultyMatcher(inner, FaultPlan(at={0: "error", 1: "error", 2: "error"})),
                               tidx, fast_config(tres))
    try:
        for _ in range(3):
            rm.match_topics(TOPICS)
        assert rm.breaker.state == "open"
        deadline = time.monotonic() + 5
        while rm.breaker.state != "closed" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rm.breaker.state == "closed" and rm.breaker.probes >= 1
        seen = inner.dispatches
        rm.match_topics(TOPICS)
        assert inner.dispatches == seen + 1
    finally:
        rm.close()


def test_probe_now_requires_verified_health_and_churn_is_not_corruption():
    _jidx, tidx = twin_tries(SMALL)
    rm = tres.ResilientMatcher(FaultyMatcher(HostBatchMatcher(tidx, TSubscribers), FaultPlan(corrupt_rate=1.0)),
                               tidx, fast_config(tres, failure_threshold=1, probe_backoff_s=30.0,
                                                 probe_backoff_max_s=60.0))
    try:
        rm.match_topics(TOPICS)
        assert rm.breaker.state == "open" and rm.probe_now() is False and rm.breaker.probe_failures >= 1
    finally:
        rm.close()

    class Churning(HostBatchMatcher):
        def match_topics_async(self, topics):
            resolver = super().match_topics_async(topics)

            def resolve():
                results = resolver()
                self.index.subscribe(f"late{self.dispatches}", Subscription(filter="a/+"))
                return results

            return resolve

    _jidx, tidx = twin_tries(SMALL)
    rm = tres.ResilientMatcher(Churning(tidx, TSubscribers), tidx, fast_config(tres, failure_threshold=1))
    try:
        for _ in range(3):
            rm.match_topics(["a/b", "a/x"])
        assert rm.breaker.state == "closed" and "corrupt" not in rm.breaker.failure_kinds
    finally:
        rm.close()


# -- concurrent issue into one matcher ----------------------------------------------


@pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "ranges"])
def test_four_threads_issuing_at_once_give_the_serial_results(compact, lazy):
    """The breaker's guard threads issue and resolve batches into one
    ``TorchMatcher`` concurrently: four threads at a time, released by a
    barrier with a short switch interval, must give every batch the
    result it gets alone, and the serial run's batch, topic and host-route
    counts."""
    _jidx, tidx = twin_tries(corpus_ops(5, n_subs=300))
    batches = [corpus_topics(100 + k, n=96) for k in range(16)]
    serial_m = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=compact, device="cpu", lazy=lazy)
    serial = [[canon(r) for r in serial_m.match_topics(b)] for b in batches]
    m = TorchMatcher(tidx, max_levels=MAX_LEVELS, compact=compact, device="cpu", lazy=lazy)
    got: dict = {}
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for round_ in range(0, len(batches), 4):
            barrier = threading.Barrier(4)

            def work(k):
                try:
                    barrier.wait(10)
                    resolver = m.match_topics_async(batches[k])
                    got[k] = [canon(r) for r in resolver()]
                except Exception as e:  # reported below
                    errors.append(e)

            threads = [threading.Thread(target=work, args=(k,)) for k in range(round_, round_ + 4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(30)
                assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert [got[k] for k in range(len(batches))] == serial
    keys = ("batches", "topics", "host_fallbacks", "overflows")
    assert {k: m.stats.as_dict()[k] for k in keys} == {k: serial_m.stats.as_dict()[k] for k in keys}
    # a batch issued before the capacity learned the corpus's hits
    # outgrows its pair buffer and re-runs on the ranges path, so the
    # compact route's split depends on the interleaving; its sum does not
    routed = m.stats.compact_batches + m.stats.compact_overflows
    assert m.stats.batches == 16 and routed == (16 if compact else 0)
    assert all(b.pins == 0 for b in m._tables)  # every batch dropped its pin


def test_the_wrapper_over_the_delta_matcher_gives_the_trie():
    """The server's chain: ``ResilientMatcher`` over ``DeltaMatcher`` with
    its four guard threads, 16 batches issued before the first resolves,
    a fold between rounds; every result the trie's, the breaker closed,
    every batch verified."""
    jidx, tidx = twin_tries(corpus_ops(5, n_subs=300))
    dm = DeltaMatcher(tidx, max_levels=MAX_LEVELS, background=False, device="cpu")
    rm = tres.ResilientMatcher(dm, tidx, tres.BreakerConfig(seed=1, verify_sample=0))
    try:
        for round_ in range(2):
            batches = [corpus_topics(200 + 16 * round_ + k, n=64) for k in range(16)]
            resolvers = [rm.match_topics_async(b) for b in batches]
            for b, r in zip(batches, resolvers):
                assert [canon(x) for x in r()] == [canon(tidx.subscribers(t)) for t in b]
            apply_ops([("sub", "late", "a/+", 1, 0, False)], jidx, tidx)
            rm.flush()
        g = rm.breaker_gauges()
        assert g["state"] == "closed" and g["failures"] == 0 and g["fallback_batches"] == 0
        assert dm.stats.batches == 32
    finally:
        rm.close()


# -- the verify sample on multi-filter clients --------------------------------------


MULTI = [op for i in range(24) for op in (("sub", f"m{i}", f"m{i}/#", 1, 3, False),
                                          ("sub", f"m{i}", f"m{i}/+/b", 2, 0, False))]


@pytest.mark.parametrize("multi", [False, True], ids=["corpus-topics", "multi-topics"])
@pytest.mark.parametrize("seed", [3, 7])  # corpora whose m<i>/e/b topics take the device route
def test_the_verify_sample_flags_what_the_jax_wrapper_flags(seed, multi):
    """A client holding two filters that match one topic merges them in
    probe order on the device and in walk order on the trie, and
    ``subscribers_equal`` (which compares the merged filter) reads that as
    ``corrupt`` (ROADMAP Queue C, kept in both packages). Both wrappers,
    each over its package's device matcher, on the same seeded corpus and
    batches with the same seed: the same failure kinds, fallback and
    verified batches, breaker state, and results. ``corpus_ops``' clients
    hold about three filters each; beside them, 24 clients on ``m<i>/#``
    and ``m<i>/+/b``. Batches of ``corpus_topics`` flag what they flag in
    both packages (a sampled topic on a multi-filter client); batches of
    ``m<i>/e/b`` alone are flagged every time, three in a row trip the
    breaker, and the rest are served by the walk, in both packages."""
    jidx, tidx = twin_tries(corpus_ops(seed, n_subs=300) + MULTI)
    if multi:
        batches = [[f"m{(k + j) % 24}/e/b" for j in range(32)] for k in range(12)]
    else:
        batches = [corpus_topics(seed * 100 + k, n=32) for k in range(12)]
    kw = dict(failure_threshold=3, watchdog_s=30.0, probe_backoff_s=60.0, probe_backoff_max_s=120.0,
              probe_jitter=0.0, verify_sample=1, seed=seed)
    out = {}
    for name in ("jax", "torch"):
        mod = PACKAGES[name][0]
        if name == "jax":
            inner = TpuMatcher(jidx, max_levels=MAX_LEVELS, lazy=False)
            index = jidx
        else:
            inner = TorchMatcher(tidx, max_levels=MAX_LEVELS, device="cpu", lazy=False)
            index = tidx
        rm = mod.ResilientMatcher(inner, index, mod.BreakerConfig(**kw))
        try:
            res = [[canon(r) for r in rm.match_topics(b)] for b in batches]
            g = breaker_view(rm.breaker_gauges())
        finally:
            rm.close()
        out[name] = (res, g)
    assert out["torch"] == out["jax"]
    g = out["torch"][1]
    assert "failures_error" not in g and "failures_hang" not in g
    if multi:
        assert (g["failures_corrupt"], g["state"], g["fallback_batches"], g["verified_batches"]) == (3, "open", 12, 0)
    else:
        assert g.get("failures_corrupt", 0) + g["verified_batches"] == 12
