"""The port's payload-predicate plane against the JAX package, on the CPU.

K4 ``rules_eval`` and K5 ``agg_reduce`` (their plain PyTorch versions here)
against the JAX package's ``rules_eval_core`` and ``agg_reduce_core`` on
seeded numpy inputs: packed rows equal word for word, pad bits included
(tolerance 0); MAX/MIN equal; MEAN within the JAX engine's own oracle
tolerance, ``1e-5 * max(1, |want|)``, since the two sum in different
orders. Then the host engine against ``mqtt_tpu.predicates``: grammar,
interning, feature vectors, and ``apply`` on twin tries, on the host path
and on the device-row path.
"""

import json
import random

import numpy as np
import pytest
import torch

import jax

from mqtt_tpu.ops import predicates as jops
from mqtt_tpu.packets import Subscription as JSubscription
from mqtt_tpu.predicates import PredicateEngine as JEngine
from mqtt_tpu.predicates import compile_suffix as jcompile
from mqtt_tpu.topics import InlineSubscription as JInline
from mqtt_tpu.topics import TopicsIndex as JTopicsIndex
from mqtt_tpu import topics as jtopics

from mqtt_tpu_torch import predicates as tpred
from mqtt_tpu_torch import topics as ttopics
from mqtt_tpu_torch.ops import predicates as tops
from mqtt_tpu_torch.packets import Subscription as TSubscription
from mqtt_tpu_torch.topics import InlineSubscription as TInline
from mqtt_tpu_torch.topics import TopicsIndex as TTopicsIndex

MEAN_TOL = 1e-5


def _noop(*_a) -> None:
    pass


def rule_inputs(seed: int, B: int, R: int, S: int, W: int):
    """Seeded rule table and feature batch: every op code (pad and
    compound codes included), slots and cbits past both clip edges, NaN
    and infinite features and thresholds, exact-threshold features."""
    rng = np.random.default_rng(seed)
    op = rng.integers(0, 14, R).astype(np.int32)
    slot = rng.integers(-3, S + 3, R).astype(np.int32)
    pool = np.array([0.0, 0.5, -1.0, 1e-3, 7.25, np.nan, np.inf, -np.inf], dtype=np.float32)
    thresh = np.where(rng.random(R) < 0.5, rng.choice(pool, R), rng.normal(size=R)).astype(np.float32)
    cbit = rng.integers(-40, 32 * W + 40, R).astype(np.int32)
    feats = np.where(rng.random((B, S)) < 0.5, rng.choice(pool, (B, S)), rng.normal(size=(B, S)))
    feats = feats.astype(np.float32)
    # some features equal a rule's threshold exactly (EQ/NE/GTE/LTE edges)
    for b in range(B):
        r = int(rng.integers(0, R))
        feats[b, int(np.clip(slot[r], 0, S - 1))] = thresh[r]
    cmask = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    return op, slot, thresh, cbit, feats, cmask


@pytest.mark.parametrize("seed,B,R,S,W", [
    (0, 1, 32, 1, 1),
    (1, 16, 64, 3, 2),
    (2, 37, 256, 2, 5),
    (3, 64, 1024, 4, 3),
    (4, 5, 96, 1, 1),
])
def test_rules_eval_plain_matches_jax(seed, B, R, S, W):
    op, slot, thresh, cbit, feats, cmask = rule_inputs(seed, B, R, S, W)
    want = np.asarray(jax.jit(jops.rules_eval_core)(op, slot, thresh, cbit, feats, cmask))
    got = tops.rules_eval(*(torch.from_numpy(a) for a in (op, slot, thresh, cbit, feats)),
                          torch.from_numpy(cmask.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (B, R // 32)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_rules_eval_bit_order_and_skip_to_pass():
    # rule k of word w is bit k: one GT rule per position, passing only
    # where its threshold is below the feature; NaN passes every numeric op
    R = 64
    op = np.full(R, tops.OP_GT, np.int32)
    thresh = np.arange(R, dtype=np.float32)
    feats = np.array([[10.5], [np.nan]], dtype=np.float32)
    cmask = np.zeros((2, 1), np.uint32)
    args = (op, np.zeros(R, np.int32), thresh, np.zeros(R, np.int32), feats, cmask)
    got = tops.rules_eval(*(torch.from_numpy(a) for a in args[:5]), torch.from_numpy(cmask.view(np.int32)))
    words = got.numpy().view(np.uint32)
    assert words[0, 0] == (1 << 11) - 1 and words[0, 1] == 0
    assert (words[1] == 0xFFFFFFFF).all()
    assert np.array_equal(words, np.asarray(jax.jit(jops.rules_eval_core)(*args)))


def agg_inputs(seed: int, W: int, N: int):
    rng = np.random.default_rng(seed)
    vals = rng.normal(scale=50.0, size=(W, N)).astype(np.float32)
    vals[rng.random((W, N)) < 0.3] = np.nan
    vals[0] = np.nan  # an all-NaN window
    ops = rng.integers(tops.OP_MEAN, tops.OP_MIN + 1, W).astype(np.int32)
    ops[: min(W, 3)] = [tops.OP_MEAN, tops.OP_MAX, tops.OP_MIN][: min(W, 3)]
    # counts that differ from the live count (the mean divides by counts)
    counts = rng.integers(0, N + 4, W).astype(np.int32)
    return vals, ops, counts


def assert_agg_close(got, want, ops):
    for g, w, o in zip(got, want, ops):
        if o == tops.OP_MEAN:
            assert abs(float(g) - float(w)) <= MEAN_TOL * max(1.0, abs(float(w))), (g, w)
        else:
            assert np.float32(g).tobytes() == np.float32(w).tobytes(), (g, w, o)


@pytest.mark.parametrize("seed,W,N", [(0, 1, 1), (1, 2, 8), (2, 7, 33), (3, 64, 64), (4, 9, 200)])
def test_agg_reduce_plain_matches_jax(seed, W, N):
    vals, ops, counts = agg_inputs(seed, W, N)
    want = np.asarray(jax.jit(jops.agg_reduce_core)(vals, ops, counts))
    got = tops.agg_reduce(torch.from_numpy(vals), torch.from_numpy(ops), torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32 and got.shape == (W,)
    assert_agg_close(got, want, ops)
    if ops[1 % W] != tops.OP_MEAN:
        # an all-NaN MAX is -inf and MIN is +inf, on both sides
        assert np.isinf(got[0]) or ops[0] == tops.OP_MEAN


def test_agg_reduce_batch_matches_jax():
    rng = random.Random(5)
    pending = [(rng.choice([tops.OP_MEAN, tops.OP_MAX, tops.OP_MIN]),
                [rng.uniform(-9, 9) for _ in range(rng.randint(1, 70))]) for _ in range(11)]
    want = jops.agg_reduce_batch(pending)
    got = tops.agg_reduce_batch(pending, device="cpu")
    assert got.shape == want.shape == (11,)
    assert_agg_close(got, want, [op for op, _ in pending])


def test_rule_table_rows_match_jax_padding_included():
    eng = tpred.PredicateEngine(device="cpu")
    specs = [tpred.compile_suffix(s) for s in ("$GT{v:0.5}", "$CONTAINS{ab}", "$EQ{1}", "$EQS{s:x}")] * 9
    slots = [0, -1, 1, -1] * 9
    cbits = [-1, 0, -1, 1] * 9
    jev = jops.DeviceRuleEvaluator()
    jev.rebuild(specs, slots, cbits, n_slots=2, n_cwords=1)
    tev = tops.DeviceRuleEvaluator(device="cpu")
    tev.rebuild(specs, slots, cbits, n_slots=2, n_cwords=1)
    assert eng.device.type == "cpu" and tev.table.arrays[0].shape == (64,)
    rng = np.random.default_rng(9)
    feats = rng.choice(np.array([0.5, 1.0, np.nan, 0.25], np.float32), (21, 2))
    cmask = rng.integers(0, 4, (21, 1)).astype(np.uint32)
    want = jev.eval_async(feats, cmask)()
    got = tev.eval_async(feats, cmask)()
    assert got.dtype == np.uint32 and np.array_equal(got, want)


# -- grammar ----------------------------------------------------------------

GRAMMAR = [
    "sensors/+/temp$GT{25.0}", "a/b$LTE{hum:-1.5}", "$CONTAINS{alarm}",
    "a/b$GT{notanum}", "a/b$GT{}", "a/b$CONTAINS{}", "a/b$MEAN{temp:0}", "a/b$FOO{1}",
    "a/b$GT{1}/c", "a/b$GT{nan}", "plain/topic", "$SHARE/g/a/b$GT{t:1.5}", "alerts/#$CONTAINS{alarm}",
    "x/y$EQS{s:on}", "$EQS{:whole}", "x$AND{$GT{v:1}$LT{v:2}}", "$OR{$EQS{s:a}$CONTAINS{b}}",
    "x$AND{$GT{v:1}}", "x$AND{$MEAN{v:2}$GT{v:1}}", "x$AND{$GT{v:1}junk}", "a$MAX{v.w:64}",
]


@pytest.mark.parametrize("flt", GRAMMAR)
def test_split_and_compile_match_jax(flt):
    got = ttopics.split_predicate_suffix(flt)
    assert got == jtopics.split_predicate_suffix(flt)
    _base, suffix = got
    if suffix:
        t, j = tpred.compile_suffix(suffix), jcompile(suffix)

        def flat(spec):
            return (spec.op, spec.field, spec.value, spec.text, spec.window, tuple(flat(c) for c in spec.children))

        assert flat(t) == flat(j)


def test_grammar_cases():
    assert ttopics.split_predicate_suffix("sensors/+/temp$GT{25.0}") == ("sensors/+/temp", "$GT{25.0}")
    assert ttopics.split_predicate_suffix("$CONTAINS{alarm}") == ("#", "$CONTAINS{alarm}")
    assert ttopics.split_predicate_suffix("a/b$GT{1}/c") == ("a/b$GT{1}/c", "")
    assert ttopics.split_predicate_tokens("$GT{v:1}$LT{v:2}") == ("$GT{v:1}", "$LT{v:2}")
    spec = tpred.compile_suffix("$MEAN{v:10}")
    assert spec.op == tpred.OP_MEAN and spec.window == 10 and spec.is_agg
    with pytest.raises(ValueError):
        tpred.compile_suffix("$FOO{1}")


@pytest.mark.parametrize("key", ["\x00t1/a/b", "\x00t1", "plain/x", "", "\x00/x"])
def test_namespace_helpers_match_jax(key):
    assert ttopics.ns_tenant(key) == jtopics.ns_tenant(key)
    assert ttopics.ns_local(key) == jtopics.ns_local(key)
    for f in ("a/+", "$SHARE/g/a/#", "$share/g", "#"):
        assert ttopics.ns_scope_filter("t9", f) == jtopics.ns_scope_filter("t9", f)
        assert ttopics.ns_scope_topic("t9", f) == jtopics.ns_scope_topic("t9", f)


@pytest.mark.parametrize("a,b", [
    ((), ("$GT{1}",)), (("$GT{1}",), ()), (("$GT{1}",), ("$GT{1}",)),
    (("$GT{1}",), ("$LT{2}", "$GT{1}")), (("$GT{1}", "$EQS{s:x}"), ("$CONTAINS{q}",)),
])
def test_subscription_merge_predicate_union_matches_jax(a, b):
    t = TSubscription(filter="f/a", identifier=3, predicates=a).merge(
        TSubscription(filter="f/b", qos=2, identifier=4, predicates=b))
    j = JSubscription(filter="f/a", identifier=3, predicates=a).merge(
        JSubscription(filter="f/b", qos=2, identifier=4, predicates=b))
    assert (t.predicates, t.qos, t.identifiers) == (j.predicates, j.qos, j.identifiers)
    assert TSubscription(filter="f", predicates=a).self_merged_copy().predicates == a


# -- the host engine --------------------------------------------------------

SUFFIXES = (
    [f"$GT{{v:{t}}}" for t in (0.1, 0.25, 0.5, 0.75, 0.9)]
    + ["$LT{v:0.3}", "$GTE{v:0.5}", "$LTE{w:2}", "$EQ{w:1}", "$NE{v:0.5}", "$GT{1.5}", "$GT{n.x:0.2}"]
    + ["$CONTAINS{alarm}", "$CONTAINS{x1y}", "$EQS{s:on}", "$EQS{s:off}", "$EQS{:raw}"]
    + ["$AND{$GT{v:0.2}$LT{v:0.8}}", "$OR{$EQS{s:on}$CONTAINS{alarm}}"]
    + ["$MEAN{v:3}", "$MAX{v:2}", "$MEAN{v:32}", "$MAX{v:32}", "$MIN{v:33}"]
)


def payload_corpus(seed: int, n: int) -> list[bytes]:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        roll = rng.random()
        if roll < 0.06:
            out.append(rng.choice([b"raw", b"1.75", b"not json", b"", b"[1, 2]", b"alarm"]))
            continue
        doc = {"v": rng.choice([rng.random(), 0.5, 0.75, "str", None, True])}
        if rng.random() < 0.7:
            doc["s"] = rng.choice(["on", "off", "x1y", "alarm!", 3])
        if rng.random() < 0.4:
            doc["w"] = rng.choice([1, 2, 2.5, 0])
        if rng.random() < 0.2:
            doc["n"] = {"x": rng.random()}
        out.append(json.dumps(doc).encode())
    return out


def _sub_kwargs(i: int, rng: random.Random) -> dict:
    k = rng.randint(0, 3)
    preds = tuple(rng.sample(SUFFIXES, k)) if k else ()
    return dict(qos=i % 3, identifier=i % 5, predicates=preds)


def twin_predicated_tries(seed: int, n_subs: int = 300):
    """Twin tries (JAX package, port) of predicated subscriptions: plain
    clients on wildcard filters, $SHARE groups and inline subscriptions,
    some without predicates; one hot topic holds 40 window subscribers so
    a tick completes at least 4 large windows. Also returns every suffix
    subscribed, once per subscription."""
    rng = random.Random(seed)
    jidx, tidx = JTopicsIndex(), TTopicsIndex()
    suffixes = []
    for i in range(n_subs):
        flt = rng.choice(["s/+/t", "s/1/t", "s/#", "s/2/+", "q/+"])
        kw = _sub_kwargs(i, rng)
        suffixes.extend(kw["predicates"])
        if rng.random() < 0.1:
            flt = f"$SHARE/g{i % 2}/{flt}"
        if rng.random() < 0.08:
            kw["identifier"] = 500 + i
            jidx.inline_subscribe(JInline(filter=flt, handler=_noop, **kw))
            tidx.inline_subscribe(TInline(filter=flt, handler=_noop, **kw))
            continue
        cid = f"c{rng.randrange(n_subs // 2)}"
        jidx.subscribe(cid, JSubscription(filter=flt, **kw))
        tidx.subscribe(cid, TSubscription(filter=flt, **kw))
    for k in range(40):
        preds = (["$MEAN{v:32}", "$MAX{v:32}", "$MIN{v:33}", "$MEAN{v:3}"][k % 4],)
        suffixes.extend(preds)
        jidx.subscribe(f"agg{k}", JSubscription(filter="hot/agg", predicates=preds))
        tidx.subscribe(f"agg{k}", TSubscription(filter="hot/agg", predicates=preds))
    return jidx, tidx, suffixes


def _canon_subs(subs):
    return (
        sorted((c, s.qos, s.predicates) for c, s in subs.subscriptions.items()),
        sorted((g, sorted(m)) for g, m in subs.shared.items()),
        sorted(subs.inline_subscriptions),
    )


def _canon_emits(emits):
    out = []
    for kind, target, _sub, payload in emits:
        out.append((kind, target if kind == "client" else target.identifier, float(payload)))
    return out


def _assert_emits(got, want):
    # the windows reduced on the card sum in another order than XLA's:
    # every aggregate within the MEAN tolerance (MAX/MIN are exact anyway)
    assert [e[:2] for e in got] == [e[:2] for e in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert abs(g - w) <= MEAN_TOL * max(1.0, abs(w)), (g, w)


@pytest.fixture(scope="module")
def engines_corpus():
    return twin_predicated_tries(11)


def _engines(suffixes, **kw):
    jeng = JEngine(oracle_sample=1, **kw)
    teng = tpred.PredicateEngine(oracle_sample=1, device="cpu", **kw)
    for s in suffixes:
        jeng.register(s)
        teng.register(s)
    return jeng, teng


def test_engine_interning_and_features_match_jax(engines_corpus):
    _jidx, _tidx, suffixes = engines_corpus
    jeng, teng = _engines(suffixes)
    assert teng.rule_count == jeng.rule_count and teng.generation == jeng.generation
    jeng._rebuild_evaluator()
    teng._rebuild_evaluator()
    for s, jr in jeng._rules.items():
        tr = teng._rules[s]
        assert (tr.idx, tr.slot, tr.cbit, tr.device, tr.children, tr.refs) == (
            jr.idx, jr.slot, jr.cbit, jr.device, jr.children, jr.refs), s
    for p in payload_corpus(3, 200):
        jf, tf = jeng.features_for(p), teng.features_for(p)
        assert tf.version == jf.version
        assert np.array_equal(tf.fvec.view(np.uint32), jf.fvec.view(np.uint32)), p
        assert np.array_equal(tf.cmask, jf.cmask), p
    g_t, g_j = teng.gauges(), jeng.gauges()
    for k in ("rules", "device_rules", "fields", "contains", "equals"):
        assert g_t[k] == g_j[k], k


def _run_apply(jidx, tidx, jeng, teng, device_rows: bool, seed: int, n: int = 400, batch: int = 50):
    topics_rng = random.Random(seed)
    payloads = payload_corpus(seed, n)
    topics = [topics_rng.choice(["s/1/t", "s/2/t", "s/2/x", "q/1", "hot/agg", "hot/agg"]) for _ in range(n)]
    for lo in range(0, n, batch):
        chunk = range(lo, min(n, lo + batch))
        jf = tf = [None] * len(chunk)
        if device_rows:
            jf = [jeng.features_for(payloads[i]) for i in chunk]
            tf = [teng.features_for(payloads[i]) for i in chunk]
            jr, tr = jeng.eval_batch_async(jf), teng.eval_batch_async(tf)
            assert (jr is None) == (tr is None)
            rows_j, rows_t = jr(), tr()
            assert rows_t[1:] == rows_j[1:]
            assert np.array_equal(rows_t[0], rows_j[0])
            jeng.attach_rows(jf, rows_j)
            teng.attach_rows(tf, rows_t)
        for k, i in enumerate(chunk):
            js, je = jeng.apply(jidx.subscribers(topics[i]), payloads[i], jf[k])
            ts, te = teng.apply(tidx.subscribers(topics[i]), payloads[i], tf[k])
            assert _canon_subs(ts) == _canon_subs(js), (topics[i], payloads[i])
            _assert_emits(_canon_emits(te), _canon_emits(je))


@pytest.mark.parametrize("device_rows", [False, True], ids=["host_path", "device_rows"])
def test_engine_apply_matches_jax(engines_corpus, device_rows):
    jidx, tidx, suffixes = engines_corpus
    jeng, teng = _engines(suffixes)
    _run_apply(jidx, tidx, jeng, teng, device_rows, seed=21)
    g_t, g_j = teng.gauges(), jeng.gauges()
    for k in ("device_decisions", "host_evals", "filtered", "deliveries", "agg_emits",
              "agg_device_reductions", "oracle_checks", "oracle_mismatches", "device_batches",
              "device_evals", "agg_windows"):
        assert g_t[k] == g_j[k], k
    assert g_t["oracle_mismatches"] == 0 and g_t["agg_emits"] > 0
    if device_rows:
        assert g_t["device_decisions"] > 0 and g_t["agg_device_reductions"] >= 4
        assert "no_row" not in g_t["host_reasons"]
        assert g_t["host_reasons"]["compound"] > 0
    else:
        assert g_t["device_decisions"] == 0 and g_t["host_reasons"]["no_row"] == g_t["host_evals"]


def test_engine_host_routes_are_counted():
    eng = tpred.PredicateEngine(max_rules=2, oracle_sample=0, device="cpu")
    for s in ("$GT{v:1}", "$LT{v:5}", "$EQ{v:3}"):
        eng.register(s)
    assert [r.device for r in eng._rules.values()] == [True, True, False]
    f = [eng.features_for(b'{"v": 3}')]
    eng.attach_rows(f, eng.eval_batch_async(f)())
    sub = TSubscription(filter="t", predicates=("$EQ{v:3}",))
    subs, _ = eng.apply(_subs_of(("c", sub)), b'{"v": 3}', f[0])
    assert "c" in subs.subscriptions and eng.host_reasons == {"host_only": 1}
    # a row built before a registry change stays off the card
    f = [eng.features_for(b'{"v": 2}')]
    eng.register("$NE{v:2}")
    assert eng.eval_batch_async(f) is None and eng.stale_rows == 1
    eng.apply(_subs_of(("c", TSubscription(filter="t", predicates=("$GT{v:1}",)))), b'{"v": 2}', f[0])
    assert eng.host_reasons["no_row"] == 1


def _subs_of(*entries):
    subs = ttopics.Subscribers()
    for cid, sub in entries:
        subs.subscriptions[cid] = sub
    return subs


def test_small_ticks_reduce_on_the_host_counted():
    eng = tpred.PredicateEngine(oracle_sample=1, device="cpu")
    eng.register("$MAX{v:32}")
    sub = TSubscription(filter="t", predicates=("$MAX{v:32}",))
    emits = []
    for i in range(32):
        _subs, e = eng.apply(_subs_of(("c", sub)), json.dumps({"v": i * 0.5}).encode())
        emits += e
    assert [p for _k, _t, _s, p in emits] == [b"15.5"]
    assert eng.host_reasons == {"agg_small_tick": 1} and eng.agg_device_reductions == 0


def test_passes_retained_matches_jax():
    jeng, teng = JEngine(), tpred.PredicateEngine(device="cpu")
    for s in ("$GT{v:0.5}", "$MEAN{v:4}", "$CONTAINS{z}"):
        jeng.register(s)
        teng.register(s)
    for preds in [(), ("$GT{v:0.5}",), ("$MEAN{v:4}",), ("$MEAN{v:4}", "$CONTAINS{z}"), ("$gone{1}",)]:
        for p in (b'{"v": 0.7}', b'{"v": 0.1}', b"zz", b"x"):
            assert teng.passes_retained(TSubscription(predicates=preds), p) == jeng.passes_retained(
                JSubscription(predicates=preds), p)


@pytest.mark.parametrize("device_rows", [False, True], ids=["host_path", "device_rows"])
def test_engine_metric_families_match_jax(engines_corpus, device_rows):
    """``PredicateEngine(registry=)``: the same families as the JAX
    engine's, read live, but for its device-error counter (a failed launch
    raises in the port); and the same interning digests."""
    from mqtt_tpu.predicates import predicate_digest as jdigest
    from mqtt_tpu.telemetry import MetricsRegistry as JRegistry
    from mqtt_tpu_torch.telemetry import MetricsRegistry, check_exposition

    jidx, tidx, suffixes = engines_corpus
    jreg, treg = JRegistry(), MetricsRegistry()
    jeng, teng = _engines(suffixes, registry=None)
    jeng._register_metrics(jreg)
    teng._register_metrics(treg)
    _run_apply(jidx, tidx, jeng, teng, device_rows, seed=23, n=200)
    skip = "mqtt_tpu_predicate_device_errors_total"
    want = [line for line in jreg.exposition().splitlines() if skip not in line]
    got = treg.exposition()
    assert got.splitlines() == want
    assert check_exposition(got) == len([line for line in want if not line.startswith("#")])
    assert f"mqtt_tpu_predicate_rules {teng.rule_count}" in got
    for s in suffixes:
        assert tpred.predicate_digest(s) == jdigest(s)
    # through the constructor, as the JAX engine takes it
    reg = MetricsRegistry()
    tpred.PredicateEngine(device="cpu", registry=reg)
    assert "# TYPE mqtt_tpu_predicate_filtered_ratio gauge" in reg.exposition()
