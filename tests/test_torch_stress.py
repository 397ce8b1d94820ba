"""The port's stress driver (``mqtt_tpu_torch.stress``) held against the JAX
package's ``mqtt_tpu.stress`` on the CPU.

The wire helpers and the raw frame scanner give byte-equal output on
seeded inputs, with tolerance 0. Then the driver against the port's own
broker, ``python -m mqtt_tpu_torch.stress --serve --device cpu``: the
mqtt-stresser workload at QoS 0 and 1 receives every message, a small
publish storm accounts for every offered publish (the port's and the JAX
driver's storms alike), SIGTERM ends the broker with exit 0, and the
cluster launcher (``--workers 2``) serves and stops its workers the same
way. Without ``--device`` on a host with no card, ``--serve`` exits
non-zero naming CUDA. The mesh drill over a port worker fleet, against
the JAX fleet on the same script, is marked ``slow`` as the JAX drill is.
"""

import asyncio
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time

import pytest

import mqtt_tpu.stress as jst
import mqtt_tpu_torch.stress as tst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the wire helpers ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wire_helpers_write_the_jax_bytes(seed):
    rng = random.Random(seed)
    for _ in range(40):
        cid = "c" + "".join(rng.choice("abc123-/") for _ in range(rng.randrange(0, 30)))
        topic = "/".join(f"t{rng.randrange(50)}" for _ in range(rng.randrange(1, 6)))
        payload = bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 300)))
        version, ka, pid, qos = rng.choice((3, 4, 5)), rng.randrange(0, 600), rng.randrange(1, 65536), rng.randrange(2)
        count, pid0 = rng.randrange(1, 40), rng.choice((1, 65530, rng.randrange(1, 65536)))
        for mod_a, mod_b in ((tst, jst),):
            assert mod_a._connect_bytes(cid, version, ka) == mod_b._connect_bytes(cid, version, ka)
            assert mod_a._subscribe_bytes(pid, topic, qos) == mod_b._subscribe_bytes(pid, topic, qos)
            assert mod_a._publish_bytes(topic, payload, qos, pid) == mod_b._publish_bytes(topic, payload, qos, pid)
            assert mod_a._publish_chunk(topic, payload, count, qos, pid0) == mod_b._publish_chunk(
                topic, payload, count, qos, pid0)
            assert mod_a._puback_bytes(pid) == mod_b._puback_bytes(pid)


def _stream(seed: int) -> bytes:
    rng = random.Random(seed)
    out = bytearray()
    for i in range(200):
        kind = rng.randrange(4)
        if kind == 0:
            out += jst._publish_bytes(f"s/{i}", b"x" * rng.randrange(0, 400), rng.randrange(2), i + 1)
        elif kind == 1:
            out += jst._puback_bytes(i + 1)
        elif kind == 2:
            out += jst._publish_bytes("big/" + "y" * 20, b"z" * rng.randrange(128, 20000))
        else:
            out += b"\xc0\x00"  # PINGREQ
    return bytes(out)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_scan_frames_reads_the_jax_frames(seed):
    data = _stream(seed)
    rng = random.Random(seed)
    for mod_a, mod_b in ((tst, jst),):
        # the whole stream, then prefixes cut at seeded points (partial frames stay)
        for cut in [len(data)] + [rng.randrange(len(data)) for _ in range(60)]:
            a = mod_a._scan_frames(bytearray(data[:cut]))
            b = mod_b._scan_frames(bytearray(data[:cut]))
            assert a == b
        frames, consumed = mod_a._scan_frames(bytearray(data))
        assert consumed == len(data) and len(frames) == 200
    for mod in (tst, jst):
        with pytest.raises(ValueError, match="malformed varint"):
            mod._scan_frames(bytearray(b"\x30\xff\xff\xff\xff\x01" + b"\x00" * 8))


# -- the driver against the port's broker ------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(port: int, *extra: str) -> subprocess.Popen:
    p = subprocess.Popen(
        [sys.executable, "-m", "mqtt_tpu_torch.stress", "--serve", "--broker", f"127.0.0.1:{port}", *extra],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
    )
    line = p.stdout.readline().strip()
    if line != b"READY":
        p.kill()
        raise AssertionError(f"broker failed to start: {line!r} {p.stderr.read()[-2000:]!r}")
    return p


def _sigterm(p: subprocess.Popen) -> int:
    p.send_signal(signal.SIGTERM)
    try:
        return p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()


def test_stress_and_storm_against_the_port_broker_on_the_cpu():
    port = _free_port()
    p = _serve(port, "--device", "cpu", "--device-matcher")
    try:
        for qos in (0, 1):
            # run_stress returns once every client received all its messages
            r = asyncio.run(tst.run_stress("127.0.0.1", port, 4, 500, qos=qos, timeout=120.0))
            assert r["clients"] == 4 and r["msgs_per_client"] == 500 and r["qos"] == qos
            assert r["receive_min_per_sec"] > 0 and r["aggregate_msgs_per_sec"] > 0
        storms = {}
        for name, mod in (("torch", tst), ("jax", jst)):
            s = asyncio.run(mod.run_storm("127.0.0.1", port, publishers=4, msgs_each=200, seed=3, timeout=120.0))
            storms[name] = {k: s[k] for k in ("publishers", "offered", "acked_admitted_qos1", "shed_qos1_0x97",
                                              "publishers_disconnected")}
            # offered = admitted + shed on the acks, and nothing admitted was lost
            assert s["acked_admitted_qos1"] + s["shed_qos1_0x97"] == s["offered"]["qos1"]
            assert s["publishers_disconnected"] == 0
            assert s["shed_qos1_0x97"] == 0 and s["delivered"] == s["offered"]["total"]
        assert storms["torch"] == storms["jax"]
        assert storms["torch"]["offered"]["total"] == 800
    finally:
        rc = _sigterm(p)
    assert rc == 0


def test_serve_without_a_device_names_cuda_on_a_host_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    r = subprocess.run([sys.executable, "-m", "mqtt_tpu_torch.stress", "--serve", "--broker",
                        f"127.0.0.1:{_free_port()}"], stdin=subprocess.DEVNULL, capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode != 0 and "CUDA" in r.stderr and "READY" not in r.stdout
    with pytest.raises(SystemExit, match="CUDA"):
        tst.broker_main("127.0.0.1:1", device="cuda")


def test_the_cluster_launcher_serves_and_stops_on_sigterm():
    port = _free_port()
    p = _serve(port, "--device", "cpu", "--workers", "2")
    try:
        r = asyncio.run(tst.run_stress("127.0.0.1", port, 4, 200, timeout=120.0))
        assert r["clients"] == 4
        kids = subprocess.run(["pgrep", "-P", str(p.pid)], capture_output=True, text=True).stdout.split()
        assert len(kids) == 2
    finally:
        rc = _sigterm(p)
    assert rc == 0
    deadline = time.monotonic() + 30
    while any(os.path.exists(f"/proc/{k}") and open(f"/proc/{k}/stat").read().split()[2] != "Z" for k in kids):
        assert time.monotonic() < deadline, "a worker outlived its launcher"
        time.sleep(0.1)


# -- the mesh drill (slow, as the JAX drill is) -----------------------------------------


def _drill_fleet(module: str, base: int, workers: int, extra=()) -> subprocess.Popen:
    env = dict(os.environ)
    env.update({"MQTT_TPU_WORKER_PORTS": "1", "MQTT_TPU_CLUSTER_PING_S": "0.5", "MQTT_TPU_CLUSTER_SUSPECT_PINGS": "6",
                "MQTT_TPU_SYS_RESEND_S": "1", "MQTT_TPU_OVERLOAD_CONTROL": "0", "JAX_PLATFORMS": "cpu"})
    cmd = [sys.executable, "-m", module, "--serve", "--broker", f"127.0.0.1:{base}", "--workers", str(workers),
           "--topology", "tree", "--degree", "2", "--flap-peer-s", "0.6", "--flap-for-s", "4", "--flap-workers", "2",
           *extra]
    p = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, cwd=REPO)
    assert p.stdout.readline().strip() == b"READY"
    return p


def _free_window(span: int) -> int:
    for base in range(31010, 60000, span + 7):
        try:
            for off in range(span + 1):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + off))
            return base
        except OSError:
            continue
    raise RuntimeError("no free port window")


@pytest.mark.slow
def test_mesh_drill_over_a_port_fleet_equals_the_jax_fleet():
    """The same drill script against a flapping spanning tree of the JAX
    package's workers and of the port's (``--device cpu``): both heal,
    both verify every payload at every subscriber exactly once, and their
    verify sets and anomaly maps are equal."""
    workers = 5
    reports = {}
    for name, module, driver, extra in (("jax", "mqtt_tpu.stress", jst, ()),
                                        ("torch", "mqtt_tpu_torch.stress", tst, ("--device", "cpu"))):
        base = _free_window(workers + 2)
        p = _drill_fleet(module, base, workers, extra)
        try:
            time.sleep(2.0)
            reports[name] = asyncio.run(driver.run_mesh_drill("127.0.0.1", base, workers, settle_s=6.0,
                                                              verify_timeout_s=120.0, scrape=False))
        finally:
            p.stdin.close()
            p.wait(timeout=120)
    keys = ("workers", "storm_sent", "healed", "route_converged", "verify_sent", "verify_complete",
            "verify_missing", "dup_deliveries", "verify_anomalies")
    assert {k: reports["torch"][k] for k in keys} == {k: reports["jax"][k] for k in keys}, json.dumps(reports)
    assert reports["torch"]["verify_complete"] and reports["torch"]["dup_deliveries"] == 0
