"""The port's overload governor (``mqtt_tpu_torch.overload``) against the JAX
package's (``mqtt_tpu.overload``), on the CPU.

The same seeded pressure series drives an ``OverloadGovernor`` of each
package under an injected clock (nothing sleeps): calm, a climb through
THROTTLE into SHED, dwell-bounded recovery and a flap around the bands.
At every step both governors take the same calls: ``evaluate``, per-client
``admit`` and ``read_delay`` for clients of three priority classes (their
publish counts bumped as the read loop bumps them), ``admit_connect`` for
an admin and a plain client, ``evict_due`` for a backlog clock, and
``note_eviction``. Every verdict, every state and every ``gauges()`` map
must be equal, transition callbacks included. Tolerance 0.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from mqtt_tpu import overload as jov

from mqtt_tpu_torch import overload as tov


def _pressures(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k < 60:
            base = 0.2
        elif k < 140:
            base = 0.2 + (k - 60) * 0.012  # climb past throttle into shed
        elif k < 220:
            base = 0.95
        elif k < 300:
            base = 0.6 if (k // 7) % 2 else 0.72  # flap around the throttle bands
        else:
            base = 0.3
        out.append(max(0.0, base + float(rng.normal(0, 0.03))))
    return out


def _drive(mod, seed: int) -> list:
    t = {"now": 100.0}
    cfg = mod.OverloadConfig(min_dwell_s=0.5, eval_interval_s=0.25, quota_window_s=1.0, publish_quota=20,
                             shed_quota=8, eviction_grace_s=2.0, admission_reserve=2,
                             priority_weights={"gold": 4.0, "bulk": 0.0})
    gov = mod.OverloadGovernor(cfg, clock=lambda: t["now"])
    transitions = []
    gov.on_transition = lambda old, new: transitions.append((t["now"], old, new))
    signal = {"p": 0.0}
    gov.add_source("staging", lambda: signal["p"])
    gov.add_source("outbound", lambda: signal["p"] * 0.5)
    clients = [SimpleNamespace(id=f"c{i}", _pub_epoch=-1, _pub_count=0,
                               priority_weight={0: 1.0, 1: 4.0, 2: 0.0}[i % 3]) for i in range(6)]
    rng = np.random.default_rng(seed + 1000)
    log = []
    backlog_since = None
    for k, p in enumerate(_pressures(seed)):
        t["now"] += float(rng.choice([0.05, 0.1, 0.3]))
        signal["p"] = p
        row = [gov.evaluate(force=(k % 5 == 0))]
        for cl in clients:
            for _ in range(int(rng.integers(0, 5))):
                cl._pub_count += 1
                row.append(gov.admit(cl))
            row.append(gov.read_delay(cl))
        row.append(gov.admit_connect(admin=(k % 3 == 0)))
        row.append(gov.admit_connect(admin=lambda: True))
        if p > 0.9 and backlog_since is None:
            backlog_since = t["now"]
        if p < 0.5:
            backlog_since = None
        due = gov.evict_due(backlog_since)
        row.append(due)
        if due:
            gov.note_eviction()
            backlog_since = None
        row.append(gov.state)
        row.append(gov.gauges())
        log.append(row)
    log.append(transitions)
    return log


@pytest.mark.parametrize("seed", [0, 5, 13])
def test_same_pressure_series_gives_the_same_governor(seed):
    j, t = _drive(jov, seed), _drive(tov, seed)
    assert t == j
    states = {row[-2] for row in t[:-1]}
    assert states == {"normal", "throttle", "shed"}
    g = t[-2][-1]
    assert g["sheds"] > 0 and g["throttled"] > 0 and g["connects_refused"] > 0 and g["reserve_admits"] > 0
    assert g["evictions"] > 0 and g["transitions"] == len(t[-1]) >= 4


def test_the_peer_signal_stays_inert_until_a_cluster_enables_it():
    """The peers signal exists unregistered in a lone broker's governor
    (no ``peers`` rows, the mesh reserve the local one) in both packages.
    A worker of the cluster turns it on: ``Cluster(...)`` over each
    package's ``Server`` (not started) enables federation with the
    options' weight and TTL and registers the ``cluster`` and ``peers``
    sources; the same peer adverts, gossip payloads and reserve spends
    then give equal signals, gauges and verdicts."""
    import tempfile

    from mqtt_tpu.cluster import Cluster as JCluster
    from mqtt_tpu.server import Options as JOpts, Server as JServer
    from mqtt_tpu_torch.cluster import Cluster as TCluster
    from mqtt_tpu_torch.server import Options as TOpts, Server as TServer

    for mod in (jov, tov):
        gov = mod.OverloadGovernor(clock=lambda: 0.0)
        assert gov.peer_signal is None
        g = gov.gauges()
        assert not any(k.startswith(("peers", "signal/peers")) for k in g)
        assert g["reserve_spent_mesh"] == g["reserve_spent_local"] == 0
    tsig = tov.OverloadGovernor(clock=lambda: 0.0).enable_federation(weight=0.9, ttl_s=15.0)
    jsig = jov.OverloadGovernor(clock=lambda: 0.0).enable_federation(weight=0.9, ttl_s=15.0)
    for sig in (tsig, jsig):
        sig.observe(3, 2, 0.4, {"staging": 0.4})
    assert tsig.value() == jsig.value() and tsig.signal_values() == jsig.signal_values()

    kw = dict(overload_federation_weight=0.5, overload_federation_ttl_ms=4000.0, telemetry=False, profile=False,
              slo=False, device_stats=False, gc_tuning=False, predicate_filters=False)
    out = []
    with tempfile.TemporaryDirectory() as d:
        for Srv, Opts, Cl, extra in ((JServer, JOpts, JCluster, {}), (TServer, TOpts, TCluster, {"device": "cpu"})):
            srv = Srv(Opts(**kw, **extra))
            gov = srv.overload
            assert gov.peer_signal is None
            Cl(srv, 0, 3, d)
            sig = gov.peer_signal
            assert sig is not None and sig.weight == 0.5 and sig.ttl_s == 4.0
            sig.clock = lambda: 10.0
            c = srv._cluster
            c._on_gossip(1, json.dumps({"s": 2, "p": 0.8, "sig": {"staging": 0.8}, "r": 1}).encode())
            c._on_gossip(2, json.dumps({"s": 1, "p": 0.3, "sig": {"outbound": 0.3}}).encode())
            gov.evaluate(force=True)
            g = gov.gauges()
            out.append((round(sig.value(), 9), sig.signal_values(), sorted(gov._sources),
                        {k: v for k, v in g.items() if k.startswith(("peers", "reserve"))}, gov.state))
    assert out[1] == out[0]
    assert out[1][0] > 0 and "peers" in out[1][2] and "cluster" in out[1][2]
