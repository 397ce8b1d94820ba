"""The port's SLO engine (``mqtt_tpu_torch.slo``) against the JAX package's
(``mqtt_tpu.slo``), on the CPU.

- The objective grammar: the same specs parse to equal objectives in
  both packages (latency, ratio and gauge kinds, labels, windows,
  duplicates), and the same lines are refused.
- The engine: the same seeded series of delivery latencies, dropped and
  received counts and a device-memory gauge go into a ``Telemetry`` of
  each package, one evaluation tick at a time under an injected clock
  (``evaluate(now=...)``, nothing sleeps). Every tick's ``state()``, the
  transitions published, the breach counter and the exposition text must
  be equal. Tolerance 0.
"""

import dataclasses

import numpy as np
import pytest

from mqtt_tpu import slo as jslo
from mqtt_tpu import telemetry as jtel

from mqtt_tpu_torch import slo as tslo
from mqtt_tpu_torch import telemetry as ttel

SPECS = [
    "p99 delivery < 50ms over 5m",
    "p99 delivery{tenant=acme} < 20ms over 30s/2m",
    "p95 stage < 5ms",
    "shed ratio < 0.1% over 1m",
    "messages_dropped/messages_received ratio < 0.5%",
    "hbm ratio < 0.9 over 1m",
    "shard skew < 2.0 over 45s/3m",
    "p99 delivery < 50ms over 5m",  # a duplicate: suffixed
    "p99 nonsense",
    "latency < fast",
    "",
]


def test_objectives_parse_alike():
    j, t = jslo.parse_objectives(SPECS), tslo.parse_objectives(SPECS)
    assert [dataclasses.asdict(o) for o in t] == [dataclasses.asdict(o) for o in j]
    assert len(t) == 8
    for bad in ("p99 nonsense", "latency < fast", "p99 delivery < 5 over 5m"):
        with pytest.raises(ValueError):
            jslo.parse_objective(bad)
        with pytest.raises(ValueError):
            tslo.parse_objective(bad)


def _series(seed: int, ticks: int = 240) -> list:
    """Per tick: delivery latencies (global and the acme tenant), dropped
    and received increments, the memory gauge's value. A calm stretch, a
    storm and a recovery, so objectives breach and recover."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(ticks):
        storm = 60 <= k < 150
        lat = rng.exponential(0.08 if storm else 0.004, size=int(rng.integers(5, 30))).tolist()
        acme = rng.exponential(0.05 if storm else 0.002, size=int(rng.integers(0, 6))).tolist()
        received = int(rng.integers(50, 200))
        dropped = int(rng.integers(0, received // 4)) if storm else int(rng.integers(0, 2))
        hbm = float(rng.uniform(0.85, 0.99) if storm else rng.uniform(0.2, 0.6))
        out.append((lat, acme, dropped, received, hbm))
    return out


def _drive(tel_mod, slo_mod, seed: int, tmp_path) -> tuple:
    tele = tel_mod.Telemetry(sample=1, dump_dir=str(tmp_path), dump_min_interval_s=0.0)
    r = tele.registry
    counts = {"dropped": 0, "received": 0}
    r.counter("mqtt_tpu_messages_dropped_total", fn=lambda: counts["dropped"])
    r.counter("mqtt_tpu_messages_received_total", fn=lambda: counts["received"])
    hbm = {"v": 0.0}
    r.gauge("mqtt_tpu_device_hbm_ratio", fn=lambda: hbm["v"], device="0")
    published = []
    eng = slo_mod.SLOEngine(tele, slo_mod.parse_objectives(SPECS), burn_threshold=1.0,
                            clock=lambda: 0.0, publish=lambda name, state: published.append((name, state)))
    states = []
    for k, (lat, acme, dropped, received, v) in enumerate(_series(seed)):
        for x in lat:
            tele.observe_delivery(x, "", 0, "local")
        for x in acme:
            tele.observe_delivery(x, "acme", 1, "local")
        counts["dropped"] += dropped
        counts["received"] += received
        hbm["v"] = v
        eng.evaluate(now=1000.0 + k)
        states.append(eng.state())
    tele.recorder.join_writer()
    return states, published, eng.breach_transitions.value, tele.exposition()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_same_series_gives_the_same_transitions(seed, tmp_path):
    j = _drive(jtel, jslo, seed, tmp_path / "jax")
    t = _drive(ttel, tslo, seed, tmp_path / "torch")
    jstates, jpub, jn, jtext = j
    tstates, tpub, tn, ttext = t
    assert tstates == jstates
    assert tpub == jpub
    assert tn == jn > 0
    assert ttext == jtext
    # latency (global and per tenant), ratio and gauge objectives breach;
    # the short-windowed ones recover after the storm
    assert {name for name, st in tpub if st["breached"]} == {
        "p99_delivery_50ms_over_5m", "p99_delivery_50ms_over_5m_2", "p99_delivery_tenant_acme_20ms_over_30s_2m",
        "shed_ratio_0_1_over_1m", "hbm_ratio_0_9_over_1m"}
    assert {name for name, st in tpub if not st["breached"]} == {
        "p99_delivery_tenant_acme_20ms_over_30s_2m", "hbm_ratio_0_9_over_1m"}
