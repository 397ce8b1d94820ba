"""The cluster's halves of the port's telemetry (``ClusterMetrics``,
``RemoteStageClock``, the registry's ``summary()``) and
``GET /metrics/cluster``, held against the JAX package's on the CPU.

Every case of ``tests/test_cluster_metrics.py`` runs again on the port
(``tests/torch_mirror.py``: the same bodies and assertions, the imports
answered by the port): the summary's round trip, idempotent ingest by
(boot, sequence), ageing out, the folds of labelled families and
histograms, the federated SLO gauges, two live telemetries folding into a
valid exposition, the ``el`` stamp on a sampled forward, and a 3-worker
tree whose root scrapes the whole mesh with remote-path deliveries.

Then both packages take the same seeded observations: two registries of
each package fed alike give equal ``summary()`` maps; a ``ClusterMetrics``
of each ingests the same summaries (re-deliveries, reorders and a
restarted incarnation among them) and renders byte-identical
``/metrics/cluster`` text and equal ``slo_state``; a ``RemoteStageClock``
of each carries the same base and trace id into the same remote-path
SLI. And the port's ``HTTPStats`` answers ``/metrics/cluster`` 404
without a cluster and 200 with the federated exposition once one is
attached.
"""

import asyncio
import random

import pytest

import chip_smoke as cs
from mqtt_tpu import telemetry as J
from mqtt_tpu_torch import telemetry as T
from tests import torch_mirror

torch_mirror.export(torch_mirror.mirror("tests.test_cluster_metrics"), globals(), "Port")


def _feed(mod, seed: int):
    """A registry of ``mod`` with counters, gauges and histograms, labelled
    and not, fed from ``seed``."""
    r = random.Random(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("mqtt_tpu_test_publishes_total", "publishes", tenant="a")
    c2 = reg.counter("mqtt_tpu_test_publishes_total", "publishes", tenant="b")
    reg.gauge("mqtt_tpu_test_depth", "depth", fn=lambda: 7)
    h = reg.histogram("mqtt_tpu_test_latency_seconds", "latency", path="local")
    h2 = reg.histogram("mqtt_tpu_test_latency_seconds", "latency", path="remote")
    for _ in range(200):
        c.inc(r.randrange(3))
        c2.inc(r.randrange(2))
        h.observe(r.random() * 0.05)
        h2.observe(r.random() * 0.2)
    return reg


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_summaries_and_folds_equal_the_jax_package(seed):
    js = [_feed(J, seed + k).summary() for k in range(3)]
    ts = [_feed(T, seed + k).summary() for k in range(3)]
    assert ts == js
    now = {"t": 100.0}
    jcm = J.ClusterMetrics(max_age_s=50.0, clock=lambda: now["t"])
    tcm = T.ClusterMetrics(max_age_s=50.0, clock=lambda: now["t"])
    r = random.Random(seed)
    frames = []
    for w in range(1, 4):
        for seq in range(1, 4):
            frames.append((str(w), 11 + w, seq, js[(w + seq) % 3]))
    r.shuffle(frames)
    frames += frames[:4]  # re-deliveries
    frames.append(("2", 99, 1, js[0]))  # a restarted incarnation
    for wid, boot, seq, fams in frames:
        a = jcm.ingest(wid, boot, seq, fams)
        b = tcm.ingest(wid, boot, seq, fams)
        assert b == a
        now["t"] += 1.0
    assert (tcm.frames_ingested, tcm.frames_stale) == (jcm.frames_ingested, jcm.frames_stale)
    jl, tl = _feed(J, 0), _feed(T, 0)
    assert tcm.exposition(tl, "0") == jcm.exposition(jl, "0")
    T.check_exposition(tcm.exposition(tl, "0"))
    assert tcm.slo_state() == jcm.slo_state()
    now["t"] += 100.0  # everything ages out
    assert tcm.exposition(tl, "0") == jcm.exposition(jl, "0")
    assert tcm.worker_count == jcm.worker_count


def test_remote_stage_clock_feeds_the_remote_sli_as_the_jax_package():
    """A forwarded publish's receiving clock through each package's
    ``Server._finish_remote_clock``: one sample in the remote-path cell
    (tenant "", QoS 0) holding the origin's elapsed base plus this
    worker's segment, none in the local path, and the clock detached."""
    from mqtt_tpu.packets import Packet as JPacket
    from mqtt_tpu.server import Options as JOpts, Server as JServer
    from mqtt_tpu_torch.packets import Packet as TPacket
    from mqtt_tpu_torch.server import Options as TOpts, Server as TServer

    kw = dict(telemetry_sample=1, profile=False, device_stats=False, gc_tuning=False,
              predicate_filters=False, overload_control=False)
    out = []
    for Srv, Opts, Pk, mod, extra in ((JServer, JOpts, JPacket, J, {}), (TServer, TOpts, TPacket, T, {"device": "cpu"})):
        srv = Srv(Opts(**kw, **extra))
        pk = Pk(topic_name="r/t")
        ck = mod.RemoteStageClock(0.25, "feedface")
        ck.stamp("decode")
        pk._tclock = ck
        srv._finish_remote_clock(pk)
        assert getattr(pk, "_tclock") is None
        remote = srv.telemetry.delivery_hist("", 0, "remote")
        local = srv.telemetry.delivery_hist("", 0, "local")
        assert 0.25 <= remote.sum < 1.25
        out.append((remote.count, local.count, [s for s, _t in ck.stages], sorted(srv.telemetry.delivery_summary())))
    assert out[1] == out[0] and out[1][0] == 1 and out[1][1] == 0


def test_metrics_cluster_route_answers_from_cluster_metrics():
    """The port's ``HTTPStats``: 404 while the telemetry has no
    ``ClusterMetrics``, 200 with the exposition the store renders (the
    JAX listener's rendering of the same store) once one is attached."""
    from mqtt_tpu.listeners import HTTPStats as JStats
    from mqtt_tpu.system import Info as JInfo
    from mqtt_tpu_torch.listeners import Config, HTTPStats
    from mqtt_tpu_torch.system import Info

    async def main():
        tele = T.Telemetry(sample=1)
        st = HTTPStats(Config(type="sysinfo", id="st", address="127.0.0.1:0"), Info(), telemetry=tele)
        import logging

        await st.init(logging.getLogger("t"))
        await st.serve(None)
        host, port = st.address().rsplit(":", 1)
        status, _ = await cs.http_get(host, int(port), "/metrics/cluster")
        assert status == 404
        cm = T.ClusterMetrics(clock=lambda: 5.0)
        cm.ingest("1", 7, 1, _feed(T, 4).summary())
        tele.attach_cluster_metrics(cm)
        status, body = await cs.http_get(host, int(port), "/metrics/cluster")
        await st.close(lambda _lid: None)
        jt = J.Telemetry(sample=1)
        jcm = J.ClusterMetrics(clock=lambda: 5.0)
        jcm.ingest("1", 7, 1, _feed(J, 4).summary())
        jt.attach_cluster_metrics(jcm)
        return status, body.decode(), jcm.exposition(jt.registry, "0"), tele

    status, body, want, tele = asyncio.run(main())
    assert status == 200
    assert T.check_exposition(body) > 0
    assert 'worker="1"' in body
    # the port's registry differs from the JAX one only by what each
    # Telemetry registered itself; the federated worker's samples are equal
    fed = lambda text: sorted(ln for ln in text.splitlines() if 'worker="1"' in ln)
    assert fed(body) == fed(want)
    assert JStats and JInfo
