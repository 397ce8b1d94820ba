"""The fan-out half of the port's ``topics`` and the fan-out's wire and
session layer, held against the JAX package.

First the parts one by one against ``mqtt_tpu.topics``: ``select_shared``
and ``merge_shared_selected`` on the trie's results, ``is_valid_filter``,
``summary_base``, ``SharedSubscriptions.group_len`` and
``TopicsIndex.inline_subscription``. Then the slice end to end on a seeded
small config-4 corpus (``$SHARE`` groups of 4 beside ``corpus_ops``'s
clients): ``chip_smoke.Fanout`` (publishers' frames read and decoded,
matched by a ``MatchStage`` over a ``DeltaMatcher``, one member selected
per group, delivered to v4, v5 and aliasing v5 clients through their
outbound queues and write loops), once over the port on ``device="cpu"``
(a port ``Server``'s ``fan_out_targets`` and ``publish_to_client``) and
once over the JAX package's own modules on its CPU matcher (a JAX
``Server``'s ``publish_to_client``), with lazy views and eager results, across a churn
of group members folded between two waves. The bytes each client receives must be
identical in both packages, and every frame must be what
``chip_smoke.FanoutCheck`` derives from the trie's own walk. All
comparisons are exact.
"""

import asyncio
import random
from types import SimpleNamespace

import pytest

import chip_smoke as cs
from mqtt_tpu import clients as jclients
from mqtt_tpu import hooks as jhooks
from mqtt_tpu import native as jnative
from mqtt_tpu import packets as jp
from mqtt_tpu import server as jserver
from mqtt_tpu import system as jsystem
from mqtt_tpu import topics as jtopics
from mqtt_tpu.ops.delta import DeltaMatcher as JDeltaMatcher
from mqtt_tpu.staging import MatchStage as JMatchStage
from mqtt_tpu_torch import DeltaMatcher, MatchStage
from mqtt_tpu_torch import topics as ttopics
from test_torch_flat import twin_tries
from test_torch_matcher import canon
from test_torch_topics import corpus_ops, corpus_topics



def jax_fan_out_targets(ops, pk, subs):
    """The selection lines of the JAX ``Server._fan_out``
    (mqtt_tpu/server.py:3384-3407, no predicate rules), which the JAX
    package has no function of its own for: ``(items, inline,
    emissions)`` as the port's ``Server.fan_out_targets`` returns them."""
    vcls = jserver._view_class()
    if vcls is not None and type(subs) is vcls:
        if not subs.has_shared and not subs.has_inline:
            return subs.targets(), (), ()
        subs = subs.materialize()
    if subs.shared:
        subs = ops.hooks.on_select_subscribers(subs, pk)
        if not subs.shared_selected:
            subs.select_shared()
        subs.merge_shared_selected()
    return subs.subscriptions.items(), subs.inline_subscriptions.values(), ()


def jax_server():
    """A JAX ``Server`` with every client allowed."""
    from mqtt_tpu import Options as JOptions
    from mqtt_tpu import Server as JServer
    from mqtt_tpu.hooks.auth.allow_all import AllowHook

    srv = JServer(JOptions())
    srv.add_hook(AllowHook())
    return srv


def jax_fanout(srv):
    """``chip_smoke.Fanout`` over the JAX package's modules, delivering
    through ``srv.publish_to_client`` onto its clients' outbound queues."""
    mods = SimpleNamespace(clients=jclients, hooks=jhooks, native=jnative, packets=jp, server=jserver,
                           system=jsystem, topics=jtopics)

    def deliver_inline(inline, pk):  # the JAX Server._fan_out's lines (mqtt_tpu/server.py:3425-3427)
        for isub in inline:
            isub.handler(srv.inline_client, isub, pk)

    stand_in = SimpleNamespace(
        _ops=srv._ops, fan_out_targets=lambda pk, subs: jax_fan_out_targets(srv, pk, subs),
        deliver_inline=deliver_inline,
        publish_to_client=srv.publish_to_client)
    return cs.Fanout(mods, stand_in)
VOCAB = [f"v{i}" for i in range(5)]


def selected(subs):
    """``canon`` of a result after ``select_shared`` and
    ``merge_shared_selected``, with the picks."""
    subs.select_shared()
    picks = {c: cs_key(s) for c, s in subs.shared_selected.items()}
    subs.merge_shared_selected()
    return canon(subs), picks


def cs_key(s):
    return (s.filter, s.qos, s.identifier, s.identifiers, s.no_local)


def small_cfg4_ops(seed: int, n_groups: int = 200, members: int = 4) -> list:
    """Config 4's shape (``$SHARE/grp<g>/<a>/<b>/<c>``, QoS 1) over a
    vocabulary of 5 values a level, so that topics hit groups."""
    rng = random.Random(seed)
    ops = []
    for g in range(n_groups):
        flt = "/".join(rng.choice(VOCAB) for _ in range(3))
        ops += [("sub", f"g{g}m{m}", f"{ttopics.SHARE_PREFIX}/grp{g}/{flt}", 1, 0, False) for m in range(members)]
    return ops


def test_select_and_merge_shared_equal_the_jax_package():
    ops = corpus_ops(21, n_subs=600) + small_cfg4_ops(22)
    jidx, tidx = twin_tries(ops)
    rng = random.Random(23)
    topics = corpus_topics(24, n=300) + ["/".join(rng.choice(VOCAB) for _ in range(3)) for _ in range(300)]
    n_picks = 0
    for t in topics:
        got, want = selected(tidx.subscribers(t)), selected(jidx.subscribers(t))
        assert got == want, t
        n_picks += len(got[1])
    assert n_picks > 300
    # a pick merges over the client's own subscription: max QoS, both
    # identifiers
    a, b = ttopics.Subscribers(), jtopics.Subscribers()
    for s, pkg in ((a, ttopics), (b, jtopics)):
        sub = pkg.Subscription(filter="$SHARE/g/a", qos=2, identifier=4)
        s.shared["$SHARE/g/a"] = {"c1": sub, "c2": sub}
        s.subscriptions["c1"] = pkg.Subscription(filter="a", qos=0, identifier=7)
        s.select_shared()
        s.merge_shared_selected()
    assert canon(a) == canon(b) and a.subscriptions["c1"].qos == 2
    assert a.subscriptions["c1"].identifiers == b.subscriptions["c1"].identifiers == {"a": 7, "$SHARE/g/a": 4}


FILTERS = [
    "", "a", "a/b", "a/+", "+", "#", "a/#", "a/#/b", "a#", "a/b#", "+/+/#", "$SYS/x", "$sys/#", "$SYSTEM",
    "$SHARE", "$SHARE/g", "$SHARE/g/", "$SHARE/g/a/#", "$share/g/+", "$SHARE/g+/a", "$SHARE/#/a",
    "$SHARE/g/a$GT{v:1}", "a/b$GT{v:2.5}", "$CONTAINS{alarm}", "a\x00b", "\x00t/a", "a//b", "/", "//",
    "a/$AND{$GT{v:1}$LT{v:9}}", "$SHARE/g/$OR{$GT{v:1}$EQS{k:x}}", "x/$MEAN{v:32}", "é/ü", "a/b/c/d/e/f/g/h/i",
]


@pytest.mark.parametrize("flt", FILTERS)
def test_filter_checks_equal_the_jax_package(flt):
    for for_publish in (False, True):
        assert ttopics.is_valid_filter(flt, for_publish) == jtopics.is_valid_filter(flt, for_publish)
    assert ttopics.summary_base(flt) == jtopics.summary_base(flt)
    assert ttopics.is_shared_filter(flt) == jtopics.is_shared_filter(flt)


def test_group_len_and_inline_subscription_equal_the_jax_package():
    ops = corpus_ops(31, n_subs=400) + small_cfg4_ops(32, n_groups=60)
    jidx, tidx = twin_tries(ops)
    inline = [(o[4], o[2]) for o in ops if o[0] == "inline"] + [(5, "no/such"), (10_000, "a")]
    for ident, flt in inline:
        j, t = jidx.inline_subscription(ident, flt), tidx.inline_subscription(ident, flt)
        assert (t is None) == (j is None)
        if t is not None:
            assert (t.filter, t.identifier) == (j.filter, j.identifier)
    n = 0
    for flt in {o[2] for o in ops if o[0] == "sub" and ttopics.is_shared_filter(o[2])}:
        jn, tn = jidx._seek(flt, 2), tidx._seek(flt, 2)
        assert tn.shared.group_len() == jn.shared.group_len() and len(tn.shared) == len(jn.shared)
        n += tn.shared.group_len()
    assert n > 60


def _fanout_run(fan, idx, dm, stage, waves, hot, churn, adds, pkg_subscription):
    """Both waves of the fan-out over one package's ``fan`` (``churn``
    unsubscribed and subscribed again, and ``adds`` subscribed, between
    them); the harness, its checker and each wave's matcher stats."""
    verify = cs.FanoutCheck()
    fan.n_views = 0
    fan.stats = []

    async def drive():
        stage.start()
        try:
            for w, topics in enumerate(waves):
                if w == 1:
                    for cid, flt in churn:
                        idx.unsubscribe(flt, cid)
                    for cid, flt in churn + adds:
                        idx.subscribe(cid, pkg_subscription(filter=flt, qos=1))
                    dm.flush()
                    fan.add_select_hook()
                stats0 = dict(dm.stats.as_dict())
                r = await fan.wave(stage, topics, w, hot)
                verify(idx, fan, r["pks"], f"wave {w + 1}")
                fan.n_views += sum(type(x) is fan.view_t for x in r["results"])
                fan.stats.append({k: dm.stats.as_dict()[k] - stats0[k] for k in ("host_fast", "host_fallbacks")})
        finally:
            await fan.close()
            await stage.stop()

    asyncio.run(drive())
    return fan, verify


@pytest.mark.parametrize("corpus", ["mixed", "cfg4"])
@pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])
def test_fanout_end_to_end_equals_the_jax_package(lazy, corpus):
    """``mixed``: the groups beside ``corpus_ops``'s clients (wildcards,
    inline, identifiers, no-local), every wave on the device route;
    ``cfg4``: the groups alone, wildcard-free, so the first wave takes
    both packages' exact-map route and the audit group's wildcard,
    subscribed with the churn, moves the second onto the device route."""
    cfg4 = small_cfg4_ops(41)
    ops = (corpus_ops(42, n_subs=300) if corpus == "mixed" else []) + cfg4
    jidx, tidx = twin_tries(ops)
    rng = random.Random(43)
    hot = sorted({ttopics.shared_inner(o[2]) for o in cfg4})[:6]
    waves = [
        [rng.choice(["/".join(rng.choice(VOCAB) for _ in range(3)), t]) for t in corpus_topics(44 + w, n=500)]
        for w in range(2)
    ]
    # every hot group's first member, then members at random, churned
    firsts = {o[2]: (o[1], o[2]) for o in reversed(cfg4)}
    churn = [firsts[f] for f in sorted(firsts) if ttopics.shared_inner(f) in hot]
    churn += [(o[1], o[2]) for o in rng.sample(cfg4, 60) if (o[1], o[2]) not in churn]
    adds = [(f"audit{m}", f"$SHARE/audit/{hot[0].split('/')[0]}/+/+") for m in range(4)]
    tdm = DeltaMatcher(tidx, max_levels=4, background=False, device="cpu", lazy=lazy)
    jdm = JDeltaMatcher(jidx, max_levels=4, background=False, lazy=lazy)
    try:
        tfan, tver = _fanout_run(
            cs.Fanout(cs.fanout_modules()), tidx, tdm,
            MatchStage(tdm, tidx.subscribers, max_batch=64, latency_budget_s=None), waves, hot, churn, adds,
            ttopics.Subscription)
        jfan, jver = _fanout_run(
            jax_fanout(jax_server()), jidx, jdm,
            JMatchStage(jdm, jidx.subscribers, max_batch=64, latency_budget_s=None), waves, hot, churn, adds,
            jtopics.Subscription)
        assert tdm.stats.as_dict()["folds"] >= 1
    finally:
        tdm.close()
        jdm.close()
    tout, jout = tfan.outbound(), jfan.outbound()
    assert list(tout) == list(jout) and tout == jout
    assert tver.frames == jver.frames > 200 and tver.alias_hits == jver.alias_hits > 0
    assert tfan.inbound_alias_hits == jfan.inbound_alias_hits > 0
    assert tfan.select_hook.calls == jfan.select_hook.calls > 0
    assert (tfan.gate.batches, tfan.gate.scans) == (jfan.gate.batches, jfan.gate.scans)
    assert tfan.dropped == jfan.dropped == 0
    assert tfan.stats == jfan.stats
    if corpus == "cfg4":
        assert tfan.stats[0]["host_fast"] > 300 and tfan.stats[1]["host_fast"] == 0
    assert (tfan.n_views > (500 if corpus == "mixed" else 200)) if lazy else tfan.n_views == 0
    assert {cs.subscriber_kind(cid) for cid in tout} == {(4, 0), (5, 0), (5, cs.ALIAS_MAX)}
    # the churned first members moved to the end of their groups: the
    # second wave selected another member of each hot group
    assert any(cid.startswith("g") and cid.endswith("m1") for cid in tout)
    assert any(cid.startswith("audit") for cid in tout)


def test_deliver_mirrors_the_jax_servers_publish_to_client():
    """The port's ``Server.publish_to_client`` queues what the JAX
    ``Server.publish_to_client`` queues, each drained as its write loop
    drains it: per subscriber version, alias maximum, identifiers,
    retain-as-published, no-local and QoS."""
    from mqtt_tpu_torch import clients as tclients
    from mqtt_tpu_torch import packets as tp
    from mqtt_tpu_torch import server as tserver

    srv = jax_server()
    tfan = cs.Fanout(cs.fanout_modules())  # a port Server, every client allowed
    tsrv, tops = tfan.srv, tfan.ops
    rng = random.Random(51)
    cases = []
    for k in range(60):
        version = rng.choice([3, 4, 5])
        alias_max = rng.choice([0, 0, 2]) if version == 5 else 0
        kw = dict(filter=f"t/{k % 3}", qos=rng.randrange(3), identifier=rng.choice([0, 0, 9]),
                  retain_as_published=rng.random() < 0.5, no_local=rng.random() < 0.2,
                  fwd_retained_flag=rng.random() < 0.2)
        merged = rng.random() < 0.5
        subs = []
        for p in (jp, tp):
            sub = p.Subscription(**kw)
            subs.append(sub.merge(sub) if merged else sub)
        cases.append((f"s{k % 7}", version, alias_max, subs))
    subs_j, subs_t = {}, {}
    for cid, version, alias_max, _ in cases:
        for store, p, cmod, ops in ((subs_j, jp, jclients, srv._ops), (subs_t, tp, tclients, tops)):
            if cid not in store:
                w = cs.MemWriter()
                cl = cmod.Client(None, w, ops)
                pk = p.Packet(fixed_header=p.FixedHeader(type=p.CONNECT), protocol_version=version,
                              connect=p.ConnectParams(protocol_name=b"MQTT", client_identifier=cid),
                              properties=p.Properties(topic_alias_maximum=alias_max))
                cl.parse_connect("t", pk)
                store[cid] = (cl, w)

    def drain(cl):
        while not cl.state.outbound.empty():
            item = cl.state.outbound._items.popleft()
            cl.write_frame(item) if type(item) is bytes else cl.write_packet(item)

    n_queued = 0
    for n, (cid, _v, _a, (sub_j, sub_t)) in enumerate(cases):
        origin = rng.choice(["s1", "p"])
        pks = [p.Packet(fixed_header=p.FixedHeader(type=p.PUBLISH, qos=n % 3, retain=n % 4 == 0),
                        topic_name=f"t/{n % 3}", payload=f"m{n}".encode(), origin=origin) for p in (jp, tp)]
        fast_j = jserver._FrameCache(pks[0]) if n % 3 == 0 else None
        fast_t = tserver._FrameCache(pks[1]) if n % 3 == 0 else None
        (cl_j, _), (cl_t, _) = subs_j[cid], subs_t[cid]
        srv.publish_to_client(cl_j, sub_j, pks[0], fast_j)
        tsrv.publish_to_client(cl_t, sub_t, pks[1], fast_t)
        assert cl_t.state.outbound.qsize() == cl_j.state.outbound.qsize()
        n_queued += cl_t.state.outbound.qsize()
        drain(cl_j)
        drain(cl_t)
        assert len(cl_t.state.inflight) == len(cl_j.state.inflight)
    for cid in subs_j:
        assert subs_t[cid][1].data == subs_j[cid][1].data, cid
    assert n_queued > 20 and sum(len(w.data) for _, w in subs_t.values()) > 0
    assert tops.info.inflight == srv.info.inflight > 0


@pytest.mark.parametrize("qos", [0, 1])
def test_publish_to_client_full_queue_equals_the_jax_servers(qos):
    """A full outbound queue: the port's ``Server.publish_to_client``
    raises the JAX server's code, counts the drop and rolls the inflight
    entry back as the JAX ``Server.publish_to_client`` does."""
    from mqtt_tpu_torch import clients as tclients
    from mqtt_tpu_torch import packets as tp
    from mqtt_tpu_torch import server as tserver

    srv = jax_server()
    tfan = cs.Fanout(cs.fanout_modules())
    tsrv, tops = tfan.srv, tfan.ops
    got = []
    for p, cmod, ops, publish, cache in (
        (jp, jclients, srv._ops, lambda cl, sub, pk, fast: srv.publish_to_client(cl, sub, pk, fast),
         jserver._FrameCache),
        (tp, tclients, tops, lambda cl, sub, pk, fast: tsrv.publish_to_client(cl, sub, pk, fast),
         tserver._FrameCache),
    ):
        ops.options.capabilities.maximum_client_writes_pending = 2
        cl = cmod.Client(None, cs.MemWriter(), ops)
        cl.parse_connect("t", p.Packet(fixed_header=p.FixedHeader(type=p.CONNECT), protocol_version=4,
                                       connect=p.ConnectParams(protocol_name=b"MQTT", client_identifier="c")))
        sub = p.Subscription(filter="t/x", qos=1)
        codes = []
        for n in range(5):
            pk = p.Packet(fixed_header=p.FixedHeader(type=p.PUBLISH, qos=qos), topic_name="t/x",
                          payload=f"m{n}".encode(), origin="p")
            try:
                publish(cl, sub, pk, cache(pk) if qos == 0 else None)
                codes.append(0)
            except p.Code as e:
                codes.append(int(e.code))
        got.append((codes, cl.state.outbound.qsize(), len(cl.state.inflight), ops.info.messages_dropped,
                    ops.info.inflight, cl.state.inflight.send_quota))
    assert got[0] == got[1]
    assert got[1][0] == [0, 0, 0x97, 0x97, 0x97] and got[1][3] == 3
