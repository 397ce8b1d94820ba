"""The port's own entry point held against the JAX package's on the CPU:
``config`` (JSON and YAML to ``Options``, the built-in hooks and
listeners), ``utils.obfuscate``, ``hooks.auth.authfile`` and
``python -m mqtt_tpu_torch`` (``initauth``, ``code-password``, ``genecc``,
``serve``).

The same configuration bytes give each package's ``Options`` the same
value in every field, and the same hooks with the same options, the
worker cluster's and the shard fabric's keys included. The CLI's cases of
``tests/test_aux.py`` behave alike in both packages; a ``serve``
subprocess on the CPU restores a LogKV store, answers MQTT over TCP and
WebSocket and ``/healthz``, and on SIGTERM closes the store and exits 0;
and ``serve --workers 2`` starts two workers of the port that form the
mesh and deliver each other's publishes.
"""

import asyncio
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import types

import pytest

import chip_smoke as cs

from mqtt_tpu import __main__ as jmain
from mqtt_tpu import config as jconfig
from mqtt_tpu.server import Options as JOptions

from mqtt_tpu_torch import __main__ as tmain
from mqtt_tpu_torch import config as tconfig
from mqtt_tpu_torch.server import Options as TOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

YAML = b"""
listeners:
  - type: tcp
    id: t1
    address: ":0"
  - type: ws
    id: ws1
    address: ":0"
    admission: false
  - type: sysinfo
    id: st
    address: ":0"
hooks:
  auth:
    ledger:
      users:
        u1: {password: p1, acl: {"a/#": 3}}
      auth:
        - {username: u1, password: p1, allow: true}
  storage:
    logkv:
      path: kv-here
      durability_fsync: batch
      fsync_interval_ms: 20
    sqlite: {path: x.db, sync: true}
    memory: {}
  debug:
    show_pings: true
options:
  inline_client: true
  sys_topic_resend_interval: 7
  device_matcher: true
  matcher_opts: {max_levels: 4, background: false}
  matcher_stage_window_ms: 3.5
  matcher_stage_max_batch: 0
  matcher_stage_max_inflight: 0
  matcher_compact_capacity: 512
  matcher_lazy_views: false
  fanout_batch: false
  scan_coalesce: true
  matcher_resilience: true
  breaker_failure_threshold: 0
  breaker_watchdog_ms: -1
  breaker_probe_backoff_ms: 250
  breaker_probe_backoff_max_ms: 100
  breaker_probe_jitter: 0.3
  breaker_probe_successes: 4
  breaker_verify_sample: 2
  gc_tuning: false
  overload_stage_max_pending: 99
  tenancy: true
  tenants: {t1: {quota_class: gold}}
  tenant_users: {u1: t1}
  tenant_default: t1
  recrypt: false
  predicate_filters: true
  predicate_max_rules: 1000
  retained_matcher: true
  durable_restore_batch: 0
  trace_jax_profiler_dir: prof-dir
  capabilities:
    maximum_qos: 1
    compatibilities:
      obscure_not_authorized: true
logging:
  level: warning
"""

# the keys of the worker cluster (with the governor's federation and the
# metric federation) and of the event-loop shard fabric, each with a value
# other than its default
PLANE_VALUES = {
    "overload_federation": False, "overload_federation_weight": 0.5, "overload_federation_ttl_ms": 4000.0,
    "cluster_topology": "tree", "cluster_transport": "tcp", "cluster_tree_degree": 3, "cluster_summary_bits": 1024,
    "cluster_dup_window": 100, "cluster_peer_health_suspect_pings": 3, "cluster_suspect_window_s": 2.5,
    "cluster_peer_park_max_bytes": 4096, "cluster_base_port": 19000, "cluster_tls_cert": "worker.pem",
    "cluster_connect_timeout_s": 2.0, "cluster_summary_digests": 8, "loop_shards": 4,
    "loop_shard_accept": "reuseport", "cluster_metrics": False, "cluster_metrics_max_age_s": 60.0,
}
PLANE_FIELDS = list(PLANE_VALUES)
# the keys of the default planes: the governor, telemetry, tracing, the
# host profiler, the SLO engine and the per-card plane
DEFAULT_PLANE_FIELDS = {
    "overload_control": False, "overload_throttle_enter": 0.6, "overload_admission": False,
    "overload_shed_quota": 100, "overload_priority_classes": {"gold": 4}, "telemetry": False,
    "telemetry_ring": 32, "telemetry_sample": 8, "trace": False, "trace_sample": 16, "trace_exemplars": False,
    "profile": False, "profile_hz": 11.0, "profile_locks": False, "slo": False,
    "slo_objectives": ["p99 delivery < 50ms over 5m", "hbm ratio < 0.9 over 5m"], "slo_burn_threshold": 2.0,
    "device_stats": False, "device_hbm_watermark": 0.8,
}


def _json_of(yaml_bytes: bytes) -> bytes:
    import yaml

    return json.dumps(yaml.safe_load(yaml_bytes)).encode()


def _hook_view(hooks) -> list:
    """Each hook's class name and its options' attributes (the ledger as
    its JSON)."""
    out = []
    for hook, conf in hooks:
        if conf is None:
            out.append((type(hook).__name__, None))
            continue
        d = dict(vars(conf))
        if "ledger" in d:
            d["ledger"] = json.loads(d["ledger"].to_json())
        out.append((type(hook).__name__, d))
    return out


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_the_same_config_gives_the_jax_options(fmt):
    """One configuration, as YAML and as JSON: every ``Options`` field the
    port has takes the JAX package's value (before and after
    ``ensure_defaults``, which normalizes the degenerate staging and
    breaker knobs alike), ``trace_jax_profiler_dir`` lands in
    ``trace_torch_profiler_dir``, and the hooks, listeners and
    capabilities are the same."""
    raw = YAML if fmt == "yaml" else _json_of(YAML)
    j, t = jconfig.from_bytes(raw), tconfig.from_bytes(raw)
    skip = {"hooks", "listeners", "logger", "capabilities"}
    names = [f.name for f in dataclasses.fields(TOptions) if f.name not in skip]
    ported = [n for n in names if hasattr(j, n)]
    assert set(names) - set(ported) == {"device", "trace_torch_profiler_dir"}
    for stage in ("raw", "defaults"):
        if stage == "defaults":
            j.ensure_defaults()
            t.ensure_defaults()
        assert {n: getattr(t, n) for n in ported} == {n: getattr(j, n) for n in ported}, stage
    assert t.trace_torch_profiler_dir == j.trace_jax_profiler_dir == "prof-dir"
    assert (t.breaker_failure_threshold, t.breaker_watchdog_ms, t.breaker_probe_backoff_max_ms) == (3, 5000.0, 30000.0)
    assert (t.matcher_stage_max_batch, t.matcher_stage_max_inflight, t.durable_restore_batch) == (4096, 4, 4096)
    assert _hook_view(t.hooks) == _hook_view(j.hooks)
    assert [type(h).__name__ for h, _ in t.hooks] == ["AuthHook", "SqliteStore", "MemoryStore", "LogKVStore",
                                                      "DebugHook"]
    assert [dataclasses.asdict(c) for c in t.listeners] == [dataclasses.asdict(c) for c in j.listeners]
    assert dataclasses.asdict(t.capabilities) == dataclasses.asdict(j.capabilities)
    assert t.logger.name == "mqtt_tpu_torch"


def test_device_and_plain_configs():
    """The port's own ``device`` key; the JAX suite's small configs; an
    empty one."""
    t = tconfig.from_bytes(json.dumps({"options": {"device": "cuda:1", "device_matcher": True,
                                                   "matcher_opts": {"max_levels": 4, "background": False}}}).encode())
    assert (t.device, t.device_matcher, t.matcher_opts) == ("cuda:1", True, {"max_levels": 4, "background": False})
    for raw in (b"", b"{}"):
        assert tconfig.from_bytes(raw) is None and jconfig.from_bytes(raw) is None
    small = json.dumps({"listeners": [{"type": "tcp", "id": "t1", "address": ":0"}],
                        "hooks": {"auth": {"allow_all": True}}}).encode()
    for mod in (jconfig, tconfig):
        o = mod.from_bytes(small)
        assert len(o.listeners) == 1 and type(o.hooks[0][0]).__name__ == "AllowHook"


@pytest.mark.parametrize("field", PLANE_FIELDS)
def test_a_plane_field_the_port_lacks_raises(field):
    """A key of the cluster or the shard fabric (the planes the port
    lacked before they were ported) loads into the port's field with the
    JAX loader's value, before and after ``ensure_defaults``, and both
    packages default it alike."""
    value = PLANE_VALUES[field]
    raw = json.dumps({"options": {field: value}}).encode()
    j, t = jconfig.from_bytes(raw), tconfig.from_bytes(raw)
    assert getattr(t, field) == getattr(j, field) == value
    j.ensure_defaults()
    t.ensure_defaults()
    assert getattr(t, field) == getattr(j, field)
    assert getattr(TOptions(), field) == getattr(JOptions(), field)
    assert getattr(TOptions(**{field: value}), field) == value


@pytest.mark.parametrize("field", sorted(DEFAULT_PLANE_FIELDS))
def test_a_default_plane_field_loads_as_the_jax_package_loads_it(field):
    """A key of a default plane maps to the port's field with the JAX
    loader's value, and both packages default it alike."""
    raw = json.dumps({"options": {field: DEFAULT_PLANE_FIELDS[field]}}).encode()
    j, t = jconfig.from_bytes(raw), tconfig.from_bytes(raw)
    assert getattr(t, field) == getattr(j, field) == DEFAULT_PLANE_FIELDS[field]
    assert getattr(TOptions(), field) == getattr(JOptions(), field)


def test_a_config_driven_server_boots_and_serves(tmp_path):
    """The JAX suite's boot case on the port: a TCP listener from the
    config, allow-all auth, a CONNECT answered."""
    raw = json.dumps({"listeners": [{"type": "tcp", "id": "cfg-tcp", "address": "127.0.0.1:0"}],
                      "hooks": {"auth": {"allow_all": True}},
                      "options": {"device": "cpu", "gc_tuning": False}}).encode()

    async def main():
        from mqtt_tpu_torch.server import Server

        server = Server(tconfig.from_bytes(raw))
        await server.serve()
        host, port = server.listeners.get("cfg-tcp").address().rsplit(":", 1)
        c = cs.WireClient("cfg-client", 4)
        await c.open(host, int(port))
        c.send(cs.connect_frame("cfg-client", 4))
        got = await c.wait_frames(1, 30)
        await server.close()
        return got

    assert asyncio.run(main())[0] == b"\x20\x02\x00\x00"


# -- obfuscation and the authfile ----------------------------------------------------


@pytest.mark.parametrize("pwd", ["", "a", "hunter2", "pass:with colon", "ünïcødé"])
def test_obfuscation_equals_the_jax_package(pwd):
    from mqtt_tpu.utils import obfuscate as jo
    from mqtt_tpu_torch.utils import obfuscate as to

    coded = to.obfuscate(pwd)
    assert coded == jo.obfuscate(pwd) and coded.startswith("$MOB$") and coded != pwd
    assert to.try_deobfuscate(coded) == jo.try_deobfuscate(coded) == pwd
    assert to.try_deobfuscate("plaintext") == "plaintext" and to.is_obfuscated(coded)
    assert to.obfuscate(pwd + "a") != coded


def test_authfile_equals_the_jax_package(tmp_path):
    from mqtt_tpu.hooks.auth import authfile as ja
    from mqtt_tpu_torch.hooks.auth import authfile as ta
    from mqtt_tpu_torch.utils.obfuscate import obfuscate

    p = tmp_path / "auth.yaml"
    ta.init_authfile(str(p))
    assert p.read_text() == ja.AUTH_SAMPLE
    t, j = ta.from_authfile(str(p)), ja.from_authfile(str(p))
    assert t.to_json() == j.to_json()
    assert "sample-acl-user" not in t.users and str(t.users["device01"].password) == "secret01"
    coded = f"coded:\n    password: '{obfuscate('s3cret')}'\nplain:\n    password: open\n".encode()
    for flag in (True, False):
        assert ta.parse_authfile(coded, coded_pwd=flag).to_json() == ja.parse_authfile(coded, coded_pwd=flag).to_json()
    assert str(ta.parse_authfile(coded, coded_pwd=True).users["coded"].password) == "s3cret"
    with pytest.raises(ValueError):
        ta.from_authfile("")


# -- the CLI ---------------------------------------------------------------------------


def test_initauth_and_code_password(tmp_path, capsys):
    outs = []
    for main in (jmain.main, tmain.main):
        p = tmp_path / f"a{len(outs)}.yaml"
        assert main(["initauth", str(p)]) == 0 and p.exists()
        assert main(["code-password", "hunter2"]) == 0
        outs.append((p.read_text(), capsys.readouterr().out.splitlines()[-1]))
    assert outs[1] == outs[0] and "$MOB$" in outs[1][1]


def test_genecc_writes_the_four_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tmain.main(["genecc"]) == 0
    for f in ["root-key.ec.pem", "root.ec.pem", "cert-key.ec.pem", "cert.ec.pem"]:
        assert (tmp_path / f).exists(), f


def test_genecc_without_cryptography_returns_1(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    assert tmain.main(["genecc"]) == 1
    assert "cryptography" in capsys.readouterr().err


def _args(**kw):
    base = dict(config=None, auth=None, coded_pwd=False, disable_auth=True, admin_user=None, port=18999,
                tls_port=0, cert=None, key=None, rootca=None, ws_port=0, stats_port=0, dashboard_port=0,
                msg_timeout=0, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("case", ["admin-user-without-password", "tls-without-cert", "dashboard-without-admin"])
def test_serve_refuses_what_the_jax_cli_refuses(case, monkeypatch):
    for mod in (jmain, tmain):
        with pytest.raises(SystemExit):
            if case == "admin-user-without-password":
                mod.main(["serve", "--admin-user", "admin"])
            elif case == "tls-without-cert":
                mod.build_server(_args(tls_port=18998))
            else:
                mod.build_server(_args(dashboard_port=18997))


def test_flags_before_the_subcommand_survive(monkeypatch):
    for mod in (jmain, tmain):
        captured = {}
        monkeypatch.setattr(mod, "cmd_serve", lambda a, argv: captured.update(vars(a)) or 0)
        assert mod.main(["--port", "1999", "serve"]) == 0
        assert captured["port"] == 1999
    assert captured["device"] is None  # the config's device, else cuda


def test_build_server_adds_the_listeners_the_flags_ask_for():
    """``serve``'s flags without a config: TCP, WebSocket, dashboard and
    stats listeners, an admin user in the authfile's ledger; the same
    listener types as the JAX CLI's."""
    got = []
    for mod in (jmain, tmain):
        srv = mod.build_server(_args(ws_port=18996, stats_port=18995, dashboard_port=18994, admin_user="adm:pw"))
        got.append(sorted((lid, type(l).__name__) for lid, l in srv.listeners.internal.items()))
        if srv.matcher is not None:
            srv.matcher.close()
    assert got[1] == got[0] == [("stats", "HTTPStats"), ("tcp", "TCP"), ("web", "Dashboard"), ("ws", "Websocket")]


SITE_PROBE = """
import atexit, json, os, sys

def _report():
    mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mqtt_tpu"))
    path = os.path.join(os.environ["PROBE_DIR"], "%d.json" % os.getpid())
    with open(path, "w") as f:
        json.dump({"worker": os.environ.get("MQTT_TPU_WORKER"), "argv": sys.argv,
                   "torch": "mqtt_tpu_torch.cluster" in sys.modules, "foreign": mods}, f)

atexit.register(_report)
"""


async def _landed(port: int, name: str):
    """A v4 client on the shared port and the worker the kernel gave it
    (read from its own ``$SYS/broker/cluster/worker`` and ``peers``)."""
    c = cs.WireClient(name, 4)
    await c.open("127.0.0.1", port)
    c.send(cs.connect_frame(name, 4))
    await c.wait_frames(1, 30)
    c.send(cs.subscribe_frame(1, [("$SYS/broker/cluster/worker", 0, 0), ("$SYS/broker/cluster/peers", 0, 0)], 4))
    got = {}
    deadline = time.monotonic() + 30
    while len(got) < 2 or got.get("peers") != "1":
        assert time.monotonic() < deadline, f"{name}: no cluster rows ({got})"
        for p in cs._publishes(c, 0):
            got[p["topic"].rsplit("/", 1)[1]] = p["payload"].decode()
        await asyncio.sleep(0.05)
    return c, int(got["worker"])


def test_no_cluster_yet(tmp_path):
    """``serve --workers 2 --device cpu``: the launcher starts two
    ``python -m mqtt_tpu_torch`` workers on one SO_REUSEPORT port; each
    reports ``peers`` 1 over ``$SYS``, a publish on one worker reaches a
    subscriber on the other (QoS 0 and 1), and on SIGTERM the launcher ends
    both workers. A ``sitecustomize`` on the workers' path records, at each
    interpreter's exit, that it ran the port and that no ``jax``, ``jaxlib``
    or ``mqtt_tpu`` module was ever imported."""
    probe = tmp_path / "probe"
    probe.mkdir()
    (tmp_path / "sitecustomize.py").write_text(SITE_PROBE)
    port = _free_port()
    env = dict(os.environ, PROBE_DIR=str(probe),
               PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT, os.environ.get("PYTHONPATH", "")]))
    env.pop("MQTT_TPU_WORKER", None)
    proc = subprocess.Popen([sys.executable, "-m", "mqtt_tpu_torch", "serve", "--workers", "2", "--device", "cpu",
                             "--port", str(port), "--log-level", "warning"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        async def drive():
            deadline = time.monotonic() + 120
            on: dict = {}
            k = 0
            # the kernel spreads connections over the workers: connect
            # until one client stands on each
            while len(on) < 2:
                assert time.monotonic() < deadline and k < 200, f"clients landed on workers {sorted(on)} only"
                try:
                    c, w = await _landed(port, f"c{k}")
                except OSError:
                    await asyncio.sleep(0.2)
                    continue
                k += 1
                if w in on:
                    c.send(cs.disconnect_frame(4))
                    await c.ended(30)
                else:
                    on[w] = c
            sub, pub = on[0], on[1]
            n0 = len(sub.frames())
            sub.send(cs.subscribe_frame(2, [("xw/+/t", 1, 0)], 4))
            await sub.wait_frames(n0 + 1, 30)
            # the presence of the new filter reaches worker 1 asynchronously
            for i in range(600):
                pub.send(cs.publish_frame("xw/a/t", b"probe-%d" % i))
                await asyncio.sleep(0.05)
                if any(p["payload"].startswith(b"probe-") for p in cs._publishes(sub, n0)):
                    break
            else:
                raise AssertionError("no cross-worker delivery")
            pub.send(cs.publish_frame("xw/b/t", b"qos1-leg", 1, 7))
            for _ in range(600):
                if any(p["payload"] == b"qos1-leg" for p in cs._publishes(sub, n0)):
                    break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError("the QoS 1 publish did not cross")
            for c in on.values():
                c.send(cs.disconnect_frame(4))
                await c.ended(30)

        asyncio.run(drive())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    reports = [json.loads(p.read_text()) for p in sorted(probe.iterdir())]
    workers = sorted(r["worker"] for r in reports if r["worker"] is not None)
    assert workers == ["0", "1"], (reports, out[-2000:])
    for r in reports:
        assert r["foreign"] == [], r
        if r["worker"] is not None:
            assert r["torch"] and r["argv"][0].endswith(os.path.join("mqtt_tpu_torch", "__main__.py")), r


def test_serve_without_a_card_exits_naming_the_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(SystemExit, match="device 'cuda'"):
        tmain.build_server(_args(device=None))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_subprocess_restores_serves_and_closes_its_store(tmp_path):
    """``python -m mqtt_tpu_torch serve --config`` on the CPU: a LogKV store
    holding a subscription and a persistent session, TCP, WebSocket,
    healthcheck and stats listeners, an inline-JSON ledger. It restores the
    session (session present), delivers a publish to it over WebSocket,
    answers ``/healthz`` 200 with a closed breaker, and on SIGTERM exits 0
    having closed the store, which then holds the session's new filter."""
    from mqtt_tpu_torch.hooks.storage import Client as SClient, Subscription as SSub
    from mqtt_tpu_torch.hooks.storage.base import dumps
    from mqtt_tpu_torch.hooks.storage.logkv import LogKVOptions, LogKVStore

    kv = str(tmp_path / "kv")
    st = LogKVStore()
    st.init(LogKVOptions(path=kv, gc_interval=0))
    st._set("CL_s1", dumps(SClient(id="s1", listener="ws", clean=False, protocol_version=4)))
    st._set("SUB_s1:a/+", dumps(SSub(client="s1", filter="a/+", qos=1)))
    st.snapshot()
    st.stop()
    ports = {k: _free_port() for k in ("tcp", "ws", "hc", "st")}
    conf = {
        "listeners": [{"type": "tcp", "id": "t", "address": f"127.0.0.1:{ports['tcp']}"},
                      {"type": "ws", "id": "ws", "address": f"127.0.0.1:{ports['ws']}"},
                      {"type": "healthcheck", "id": "hc", "address": f"127.0.0.1:{ports['hc']}"},
                      {"type": "sysinfo", "id": "st", "address": f"127.0.0.1:{ports['st']}"}],
        "hooks": {"auth": {"ledger": {"auth": [{"allow": True}]}}, "storage": {"logkv": {"path": kv}}},
        "options": {"device": "cpu", "device_matcher": True, "matcher_opts": {"max_levels": 4},
                    "sys_topic_resend_interval": 1},
    }
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    proc = subprocess.Popen([sys.executable, "-m", "mqtt_tpu_torch", "serve", "--config", str(path)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        async def drive():
            deadline = time.monotonic() + 120
            health = None
            while time.monotonic() < deadline:
                try:
                    status, body = await cs.http_get("127.0.0.1", ports["st"], "/healthz")
                    if status == 200:
                        health = json.loads(body)
                        break
                except OSError:
                    pass
                await asyncio.sleep(0.2)
            assert health is not None and health["matcher_breaker"] == {"state": "closed"}
            assert health["degraded"] == []
            status, _ = await cs.http_get("127.0.0.1", ports["hc"], "/healthcheck")
            assert status == 200
            sub = cs.WsClient("s1", 4)
            await sub.open("127.0.0.1", ports["ws"])
            sub.send(cs.connect_frame("s1", 4, clean=False))
            ack = (await sub.wait_frames(1, 30))[0]
            assert ack == b"\x20\x02\x01\x00"  # session present
            pub = cs.WireClient("p", 4)
            await pub.open("127.0.0.1", ports["tcp"])
            pub.send(cs.connect_frame("p", 4))
            await pub.wait_frames(1, 30)
            pub.send(cs.publish_frame("a/b", b"over-ws", 1, 1))
            got = await sub.wait_frames(2, 30)
            assert cs.parse_publish(got[1], 4)["payload"] == b"over-ws"
            sub.send(cs.subscribe_frame(9, [("b/#", 0, 0)], 4))
            await sub.wait_frames(3, 30)
            status, body = await cs.http_get("127.0.0.1", ports["st"], "/")
            assert status == 200 and "version" in json.loads(body)
            for c in (sub, pub):
                c.send(cs.disconnect_frame(4))
                await c.ended(30)

        asyncio.run(drive())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    again = LogKVStore()
    again.init(LogKVOptions(path=kv, gc_interval=0))
    try:
        assert again._get("SUB_s1:b/#") is not None and again._get("SUB_s1:a/+") is not None
    finally:
        again.stop()
