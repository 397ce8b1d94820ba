"""The port's tenant plane, its re-key re-seal and the retained-delivery
slice against the JAX package, on the CPU.

``TenantPlane`` (configuration, CONNECT-time resolution, active tenants,
the lazily registered per-tenant metric families, rendered by each
package's ``MetricsRegistry``) against ``mqtt_tpu.tenancy.TenantPlane`` for the same maps;
``RecryptEngine.reseal_batch`` byte for byte against the JAX engine's from
the same nonce stream (256-B and 4096-B payloads, malformed, keyless and
zero-length items); ``note_rekey``'s count and its gauge, beside the
engine's other families. Then the slice
as a broker runs it: retain, wildcard SUBSCRIBE through the retained
engine, re-key (stage the epoch, re-seal the tenant's encrypted retained
payloads in one keystream generation, retain them, activate, note), and
SUBSCRIBE again, through both packages with the same inputs. Tolerance 0:
bytes, names and counters are equal.
"""

import numpy as np
import pytest

from mqtt_tpu.ops.retained import RetainedMatchEngine as JRetained
from mqtt_tpu.packets import PUBLISH as JPUBLISH
from mqtt_tpu.packets import FixedHeader as JFixedHeader
from mqtt_tpu.packets import Packet as JPacket
from mqtt_tpu.telemetry import MetricsRegistry as JRegistry
from mqtt_tpu.tenancy import RecryptEngine as JEngine
from mqtt_tpu.tenancy import TenantPlane as JPlane
from mqtt_tpu.tenancy import local_client_id as j_local_client_id
from mqtt_tpu.tenancy import scope_client_id as j_scope_client_id
from mqtt_tpu.topics import TopicsIndex as JTopicsIndex

from mqtt_tpu_torch import PUBLISH, FixedHeader, Packet, RecryptEngine, RetainedMatchEngine, TenantPlane, TopicsIndex
from mqtt_tpu_torch import tenancy as tten
from mqtt_tpu_torch.telemetry import MetricsRegistry, check_exposition
from mqtt_tpu_torch.topics import NS_CHAR, ns_local, ns_scope_filter, ns_scope_topic

KEY_A = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
KEY_S = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")


def family(text: str, name: str) -> list:
    """The exposition lines of one family: its HELP and TYPE lines and
    its samples."""
    return [line for line in text.splitlines()
            if line.split("{")[0].split(" ")[0] == name or line.startswith((f"# HELP {name} ", f"# TYPE {name} "))]


CONFIG = {
    "acme": {"quota_class": "vip", "encrypted": ["e/", "sec/"], "max_retained": 5,
             "keys": {"c0": KEY_A.hex(), "c1": KEY_S.hex(), "bad": "zz"}},
    "bulkco": {"max_subscriptions": "x"},  # not an integer: the caps are ignored
    "empty": None,
}
USERS = {"alice": "acme", "cid-b": "bulkco", "carol": "newco"}


def _planes():
    jr, tr = JRegistry(), MetricsRegistry()
    jp, tp = JPlane(registry=jr), TenantPlane(registry=tr)
    for p in (jp, tp):
        p.configure(CONFIG, USERS, default="fallback")
    return jp, tp, jr, tr


def _tenant_view(t) -> tuple:
    return (t.name, t.quota_class, t.encrypted, t.max_retained, t.max_subscriptions, t.sys_rows())


def test_tenant_plane_matches_jax():
    jp, tp, jr, tr = _planes()
    assert len(tp) == len(jp)
    assert np.array_equal(tp.keys.table(), jp.keys.table())
    for name in ("acme", "bulkco", "empty", "fallback", "nope"):
        jt, tt = jp.get(name), tp.get(name)
        assert (tt is None) == (jt is None)
        if tt is not None:
            assert _tenant_view(tt) == _tenant_view(jt)
    for user, cid in (("alice", "x"), ("", "cid-b"), ("carol", ""), ("", "nobody"), ("alice", "cid-b")):
        assert _tenant_view(tp.resolve(user, cid)) == _tenant_view(jp.resolve(user, cid))
    assert len(tp) == len(jp)  # "newco" registered itself in both
    for topic in (ns_scope_topic("acme", "e/1"), "global/t", ns_scope_topic("ghost", "x")):
        jt, tt = jp.tenant_of_topic(topic), tp.tenant_of_topic(topic)
        assert (tt and tt.name) == (jt and jt.name)
    with pytest.raises(ValueError):
        tp.register("a/b")
    for bad in ("", "+", "#", NS_CHAR + "x"):
        assert not tten._valid_tenant_name(bad)
    t = tp.get("acme")
    assert t.is_encrypted("sec/x") and not t.is_encrypted("pub/x")
    assert tp.scope_topic("acme", "x") == ns_scope_topic("acme", "x") and tp.local(ns_scope_topic("acme", "x")) == "x"
    assert tp.scope_filter("acme", "$SHARE/g/x") == ns_scope_filter("acme", "$SHARE/g/x")
    assert tten.scope_client_id("acme", "c0") == j_scope_client_id("acme", "c0")
    assert tten.local_client_id(tten.scope_client_id("acme", "c0")) == j_local_client_id(
        j_scope_client_id("acme", "c0")) == "c0"


def test_connect_accounting_and_metric_families_match_jax():
    jp, tp, jr, tr = _planes()
    assert tp.active_tenants() == [] and jp.active_tenants() == []
    for plane in (jp, tp):
        a, b = plane.get("acme"), plane.get("bulkco")
        plane.note_connect(a)
        plane.note_connect(a)
        plane.note_connect(b)
        plane.note_disconnect(b)
        plane.note_disconnect(b)  # never below 0
        a.messages_in += 3
        a.retained_count = 2
    assert [t.name for t in tp.active_tenants()] == [t.name for t in jp.active_tenants()] == ["acme", "bulkco"]
    assert _tenant_view(tp.get("acme")) == _tenant_view(jp.get("acme"))
    assert _tenant_view(tp.get("bulkco")) == _tenant_view(jp.get("bulkco"))
    # one set of families per tenant, at its first connect, read live
    assert tr.exposition() == jr.exposition()
    assert check_exposition(tr.exposition()) == 2 * 11
    tp.get("acme").bytes_out += 7
    jp.get("acme").bytes_out += 7
    assert tr.exposition() == jr.exposition()
    assert 'mqtt_tpu_tenant_bytes_out_total{tenant="acme"} 7' in tr.exposition()


def _engines(registry=None, **kw):
    jp, tp, _, _ = _planes()
    jeng = JEngine(jp.keys, oracle_sample=1, registry=registry and JRegistry(), **kw)
    teng = RecryptEngine(tp.keys, oracle_sample=1, device="cpu", registry=registry, **kw)
    jeng.reseed_nonce(b"seal", 7)
    teng.reseed_nonce(b"seal", 7)
    return jp, tp, jeng, teng


@pytest.mark.parametrize("device_min_blocks", [1, 10_000])  # a launch, and the host keystream
def test_reseal_batch_matches_jax(device_min_blocks):
    jp, tp, jeng, teng = _engines(device_min_blocks=device_min_blocks)
    for keys in (jp.keys, tp.keys):
        epoch = keys.stage_epoch("acme", {"c0": KEY_S, "c1": KEY_A})
    rng = np.random.default_rng(5)
    items = []
    for k, size in enumerate((256, 4096, 256, 4096, 0, 5, 17)):
        plain = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        ident = ("c0", "c1")[k % 2]
        wire = teng.seal_with_key((KEY_A, KEY_S)[k % 2], plain)
        assert wire == jeng.seal_with_key((KEY_A, KEY_S)[k % 2], plain)
        items.append((wire, tp.keys.key_id("acme", ident), tp.keys.kid_for_epoch("acme", ident, epoch)))
    items += [(b"short", 0, 1), (items[0][0], -1, 2), (items[1][0], 0, -1)]  # malformed, keyless twice
    got = teng.reseal_batch(tp.get("acme"), items, epoch)
    want = jeng.reseal_batch(jp.get("acme"), items, epoch)
    assert got == want
    assert got[-3:] == [None, None, None] and len(got[4]) == 12  # zero-length: the nonce alone
    for out, (wire, _o, _n), key in zip(got[:7], items, (KEY_S, KEY_A) * 4):
        assert tten.nonce_epoch(out[:12]) == epoch and out[0] == tten.EPOCH_NONCE_MAGIC
        assert teng.open_with_key(key, out) == teng.open_with_key((KEY_A, KEY_S)[key == KEY_A], wire)
    g_t, g_j = teng.gauges(), jeng.gauges()
    for k in ("device_batches", "device_blocks", "host_blocks", "oracle_checks", "oracle_mismatches", "resealed"):
        assert g_t[k] == g_j[k], k
    blocks = 2 * (2 * 16 + 2 * 256 + 0 + 1 + 2)
    if device_min_blocks == 1:
        assert (g_t["device_batches"], g_t["device_blocks"], g_t["host_reasons"]) == (1, blocks, {})
    else:
        assert (g_t["device_batches"], g_t["host_reasons"]) == (0, {"small_batch": blocks})


def test_reseal_batch_of_nothing_viable_launches_nothing():
    _jp, tp, _jeng, teng = _engines()
    assert teng.reseal_batch(tp.get("acme"), [(b"x", 0, 1), (bytes(40), -1, 0)], 1) == [None, None]
    assert teng.device_batches == teng.host_blocks == teng.resealed == 0
    assert teng.reseal_batch(tp.get("acme"), [(bytes(12), 0, 1)], 1)[0][:3] == bytes((0xA7, 0, 1))
    assert teng.device_batches == 0 and teng.resealed == 1


def test_note_rekey_counts_and_registers_its_gauge_once():
    reg = MetricsRegistry()
    jp, tp, jeng, teng = _engines(registry=reg)
    jreg = jeng._registry
    for plane, eng in ((jp, jeng), (tp, teng)):
        plane.keys.stage_epoch("acme", {"c0": KEY_S})
        plane.keys.activate_epoch("acme")
        eng.note_rekey("acme")
        eng.note_rekey("acme")
        eng.note_rekey("bulkco")
    assert teng.rekeys == jeng.rekeys == 3
    assert teng.gauges()["rekeys"] == 3
    name = "mqtt_tpu_recrypt_epoch"
    text, jtext = reg.exposition(), jreg.exposition()
    assert family(text, name) == family(jtext, name)
    assert family(text, name)[2:] == ['mqtt_tpu_recrypt_epoch{tenant="acme"} 1', 'mqtt_tpu_recrypt_epoch{tenant="bulkco"} 0']
    # the engine's other families, as the JAX engine's but for its device-error counter (a failed
    # launch raises in the port)
    names = {line.split()[2] for line in jtext.splitlines() if line.startswith("# TYPE ")}
    assert names - {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")} == {
        "mqtt_tpu_recrypt_device_errors_total"}
    for n in names - {"mqtt_tpu_recrypt_device_errors_total"}:
        assert family(text, n) == family(jtext, n), n
    assert 'mqtt_tpu_recrypt_epoch_rekeys_total 3' in text and check_exposition(text) > 0


# -- the slice: retain, SUBSCRIBE, re-key, SUBSCRIBE --------------------------
#
# What the broker does around the engines (mqtt_tpu/server.py), written once
# for either package's objects.


def subscribe_retained(engine, topics, flt: str) -> list:
    """SUBSCRIBE's retained delivery (server.py:4364-4374): the engine's
    names, each looked up in the store; the walk on a decline."""
    names = engine.match(flt)
    if names is None:
        return topics.messages(flt)
    return [m for m in (topics.retained.get(n) for n in names) if m is not None]


def retain(engine, topics, pk) -> int:
    """A retained PUBLISH, or a clear (server.py:3026-3027)."""
    r = topics.retain_message(pk)
    engine.note_retained(pk.topic_name, r == 1)
    return r


def rekey(plane, renc, engine, topics, name: str, new_keys: dict, local_client_id) -> tuple:
    """A live key rotation (server.py:4463-4556): stage the epoch, re-seal
    the tenant's encrypted retained payloads in one keystream generation,
    retain them, activate, count. Returns ``(epoch, resealed)``."""
    t = plane.get(name)
    keys = plane.keys
    epoch = keys.stage_epoch(name, new_keys)
    prefix = NS_CHAR + name + "/"
    victims, items = [], []
    for topic, pkv in topics.retained.get_all().items():
        if not topic.startswith(prefix) or not pkv.payload:
            continue
        local = ns_local(topic)
        if local.startswith("$SYS") or not t.is_encrypted(local):
            continue
        ident = local_client_id(pkv.origin)
        victims.append((topic, pkv))
        items.append((bytes(pkv.payload), keys.key_id(name, ident), keys.kid_for_epoch(name, ident, epoch)))
    resealed = 0
    for (_topic, pkv), data in zip(victims, renc.reseal_batch(t, items, epoch)):
        if data is None:
            continue  # a keyless origin: the old ciphertext stands
        out = pkv.copy(False)
        out.payload = data
        out.fixed_header.retain = True
        retain(engine, topics, out)
        resealed += 1
    keys.activate_epoch(name)
    renc.note_rekey(name)
    return epoch, resealed


def _slice(pkg: str):
    if pkg == "jax":
        plane, topics = JPlane(), JTopicsIndex()
        renc = JEngine(plane.keys, oracle_sample=1, device_min_blocks=1)
        engine = JRetained(topics, oracle_sample=1, min_capacity=16)
        packet = lambda tp, p, o: JPacket(fixed_header=JFixedHeader(type=JPUBLISH, retain=True),  # noqa: E731
                                          topic_name=tp, payload=p, origin=o)
        return plane, topics, renc, engine, packet, j_scope_client_id, j_local_client_id
    plane, topics = TenantPlane(), TopicsIndex()
    renc = RecryptEngine(plane.keys, oracle_sample=1, device_min_blocks=1, device="cpu")
    engine = RetainedMatchEngine(topics, oracle_sample=1, min_capacity=16, device="cpu")
    packet = lambda tp, p, o: Packet(fixed_header=FixedHeader(type=PUBLISH, retain=True),  # noqa: E731
                                     topic_name=tp, payload=p, origin=o)
    return plane, topics, renc, engine, packet, tten.scope_client_id, tten.local_client_id


FILTERS = ["e/+/+", "e/#", "#", "+/+", "e/g1/+", "pub/#", "$SYS/#", "e/g0/d3"]


def _run_slice(pkg: str) -> dict:
    plane, topics, renc, engine, packet, scope_cid, local_cid = _slice(pkg)
    plane.configure({"acme": {"encrypted": ["e/"]}, "bulkco": {}}, {})
    old_keys = {f"c{k}": bytes([1, k]) * 8 for k in range(4)}
    for ident, key in old_keys.items():
        plane.keys.set_key("acme", ident, key)
    renc.reseed_nonce(b"slice", 1)
    rng = np.random.default_rng(9)
    plains = {}
    for i in range(24):
        size = (256, 4096, 0, 40)[i % 4]
        plain = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        ident = f"c{i % 4}"
        topic = ns_scope_topic("acme", f"e/g{i % 3}/d{i}")
        plains[topic] = plain
        retain(engine, topics, packet(topic, renc.seal_with_key(old_keys[ident], plain), scope_cid("acme", ident)))
    for topic, payload in ((ns_scope_topic("acme", "pub/x"), b"clear"),
                           (ns_scope_topic("acme", "e/g9/nokey"), bytes(30)),
                           (ns_scope_topic("acme", "$SYS/x"), b"s"),
                           (ns_scope_topic("bulkco", "e/g0/d1"), b"other tenant"), ("e/g0/d1", b"global")):
        retain(engine, topics, packet(topic, payload, scope_cid("acme", "nobody")))
    retain(engine, topics, packet(ns_scope_topic("acme", "e/g0/d3"), b"", ""))  # a clear
    del plains[ns_scope_topic("acme", "e/g0/d3")]
    engine.reseed()
    before = {f: sorted(p.topic_name for p in subscribe_retained(engine, topics, ns_scope_filter("acme", f)))
              for f in FILTERS}
    new_keys = {f"c{k}": bytes([2, k]) * 8 for k in range(4)}
    epoch, resealed = rekey(plane, renc, engine, topics, "acme", new_keys, local_cid)
    after = {}
    opened = {}
    for f in FILTERS:
        pks = subscribe_retained(engine, topics, ns_scope_filter("acme", f))
        after[f] = sorted(p.topic_name for p in pks)
        for p in pks:
            if p.topic_name in plains:
                ident = local_cid(p.origin)
                assert (p.payload[0], (p.payload[1] << 8) | p.payload[2]) == (tten.EPOCH_NONCE_MAGIC, epoch)
                opened[p.topic_name] = renc.open_with_key(new_keys[ident], p.payload)
    store = {k: v.payload for k, v in topics.retained.get_all().items()}
    return {"before": before, "after": after, "epoch": epoch, "resealed": resealed, "opened": opened,
            "plains": plains, "store": store, "stats": engine.stats(), "rekeys": renc.rekeys,
            "resealed_count": renc.resealed, "device_batches": renc.device_batches,
            "current": plane.keys.current_epoch("acme")}


def test_retained_slice_rekey_matches_jax():
    t, j = _run_slice("torch"), _run_slice("jax")
    for k in ("before", "after", "epoch", "resealed", "opened", "store", "rekeys", "resealed_count",
              "device_batches", "current"):
        assert t[k] == j[k], k
    for k in ("corpus", "device_matches", "oracle_checks", "oracle_mismatches"):
        assert t["stats"][k] == j["stats"][k], k
    assert t["stats"]["oracle_mismatches"] == 0 and t["stats"]["device_matches"] > 0
    # the tenant's filters answer the same names before and after the re-key
    assert t["before"] == t["after"] and t["after"]["e/#"]
    # every re-sealed payload opened under the new epoch's key to its plaintext
    assert t["opened"] == t["plains"] and t["resealed"] == len(t["plains"])
    assert (t["epoch"], t["current"], t["rekeys"], t["device_batches"]) == (1, 1, 1, 1)
    # the keyless, the clear, the $SYS and the other tenants' payloads stand
    assert t["store"][ns_scope_topic("acme", "e/g9/nokey")] == bytes(30)
    assert t["store"][ns_scope_topic("bulkco", "e/g0/d1")] == b"other tenant"
