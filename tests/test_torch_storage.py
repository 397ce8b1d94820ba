"""The port's storage hooks (``mqtt_tpu_torch.hooks.storage``) held against
the JAX package's on the CPU: ``dumps`` gives the same bytes for the same
seeded records, the ``*_from_dict`` readers give the same records back,
``MemoryStore`` restores what it was given, and a ``MemoryStore`` attached
to each package's ``Server`` through a scripted session (the session of
``test_torch_server``) mirrors the same records, key for key.
"""

import asyncio
import json
import random
from dataclasses import asdict

import pytest

from test_torch_server import Broker, allow, package, pinned_clock, script_core  # noqa: F401 (fixture)


def modules(name):
    pkg = package(name)
    from importlib import import_module

    root = pkg.memory.__name__.rsplit(".", 1)[0]
    return import_module(root), import_module(root + ".base"), pkg


def seeded_records(name: str, seed: int) -> list:
    """One of each DTO with seeded fields, built in one package."""
    st, _, _ = modules(name)
    from importlib import import_module

    packets = import_module(("mqtt_tpu" if name == "jax" else "mqtt_tpu_torch") + ".packets")
    system = import_module(("mqtt_tpu" if name == "jax" else "mqtt_tpu_torch") + ".system")
    rng = random.Random(seed)
    users = [packets.UserProperty(f"k{i}", f"v{rng.randrange(99)}") for i in range(rng.randrange(3))]
    return [
        st.Client(id=f"c{seed}", remote="10.0.0.1:1", listener="t", username=bytes([rng.randrange(256)] * 3),
                  clean=rng.random() < 0.5, protocol_version=rng.choice([3, 4, 5]),
                  properties=st.ClientProperties(session_expiry_interval=rng.randrange(1 << 16),
                                                 session_expiry_interval_flag=True,
                                                 authentication_data=b"\x00\xff", receive_maximum=10, user=users),
                  will=st.ClientWill(payload=b"bye\x00", topic_name="will/t", flag=1, qos=1, retain=True,
                                     will_delay_interval=5, user=users)),
        st.Subscription(client=f"c{seed}", filter="a/+/#", identifier=rng.randrange(9), qos=rng.randrange(3),
                        retain_as_published=True, no_local=rng.random() < 0.5, retain_handling=2,
                        predicates=["$GT{v:%d}" % rng.randrange(9)]),
        st.Message(t=st.RETAINED_KEY, client=f"c{seed}", id="RET_a/b", origin="o", topic_name="a/b",
                   payload=bytes(rng.randrange(256) for _ in range(17)), created=1234, sent=5, packet_id=7,
                   qos=2, dup=True, retain=True, protocol_version=5, expiry=99999,
                   properties=st.MessageProperties(correlation_data=b"\x01", subscription_identifier=[1, 2],
                                                   user=users, content_type="json", response_topic="r/t",
                                                   message_expiry_interval=60, topic_alias=3,
                                                   payload_format=1, payload_format_flag=True)),
        st.SystemInfo(info=system.Info(version="0.1.0", started=1, bytes_received=rng.randrange(1 << 30),
                                       clients_connected=3, retained=rng.randrange(100))),
    ]


@pytest.mark.parametrize("seed", range(6))
def test_dumps_and_readers_equal_the_jax_package(seed):
    got = []
    for name in ("jax", "torch"):
        st, base, _ = modules(name)
        recs = seeded_records(name, seed)
        raw = [base.dumps(r) for r in recs]
        back = [
            base.client_from_dict(base._decode(json.loads(raw[0]))),
            base.subscription_from_dict(base._decode(json.loads(raw[1]))),
            base.message_from_dict(base._decode(json.loads(raw[2]))),
            base.sys_info_from_dict(base._decode(json.loads(raw[3]))),
        ]
        assert [base.dumps(b) for b in back] == raw  # the readers invert dumps
        got.append((raw, [json.dumps(asdict(b), default=repr, sort_keys=True) for b in back],
                    back[2].to_packet().payload, (st.SUBSCRIPTION_KEY, st.SYS_INFO_KEY, st.RETAINED_KEY,
                                                  st.INFLIGHT_KEY, st.CLIENT_KEY)))
    assert got[0] == got[1]


def test_memory_store_restores_what_it_mirrors():
    st, base, pkg = modules("torch")
    store = pkg.memory.MemoryStore()
    store.init({"CL_x": base.dumps(st.Client(id="x", protocol_version=5))})
    recs = seeded_records("torch", 3)
    store._set(st.SUBSCRIPTION_KEY + "_c3:a/+/#", base.dumps(recs[1]))
    store._set(st.RETAINED_KEY + "_a/b", base.dumps(recs[2]))
    store._set(st.SYS_INFO_KEY, base.dumps(recs[3]))
    assert [c.id for c in store.stored_clients()] == ["x"]
    assert base.dumps(store.stored_subscriptions()[0]) == base.dumps(recs[1])
    assert base.dumps(store.stored_retained_messages()[0]) == base.dumps(recs[2])
    assert store.stored_inflight_messages() == []
    assert store.stored_sys_info().info.retained == recs[3].info.retained
    store._del(st.SYS_INFO_KEY)
    assert store.stored_sys_info() is None
    assert store.id() == "memory-store" and store.provides(pkg.hooks.STORED_SUBSCRIPTIONS)


def test_server_mirrors_the_same_records_as_the_jax_server(pinned_clock):
    """The write-through hook under a scripted session: every client,
    subscription, retained and inflight record the port's server mirrors
    equals the JAX server's (the clients' ephemeral remote ports and the
    wall-clock $SYS snapshot aside)."""
    stores = {}
    for name in ("jax", "torch"):
        pkg = package(name)
        store = pkg.memory.MemoryStore()

        async def main():
            b = Broker(pkg, hooks=allow(pkg) + [(store, None)])
            await b.start()
            await script_core(b)
            await b.close()

        asyncio.run(main())
        stores[name] = store

    def norm(store):
        out = {}
        for k, v in store.data.items():
            if k == "SYS":
                continue
            d = json.loads(v)
            d.pop("remote", None)
            out[k] = d
        return out

    j, t = norm(stores["jax"]), norm(stores["torch"])
    assert t == j
    kinds = {k.split("_", 1)[0] for k in t}
    assert kinds == {"CL", "SUB", "RET", "IFM"} and len(t) > 20
