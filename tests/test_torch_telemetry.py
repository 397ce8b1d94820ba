"""The port's metrics core (``mqtt_tpu_torch.telemetry``) against the JAX
package's (``mqtt_tpu.telemetry``), on the CPU.

The same seeded sequence of registrations and observations goes into a
``MetricsRegistry`` of each package: counters (stored and callback-backed),
gauges (stored, callback-backed, integral and fractional floats), labelled
children whose values need escaping, histograms on the default log-scale
bounds and on explicit bounds, and a callback-backed histogram merged from
per-thread shards at scrape time. The rendered exposition text must be
byte-identical, the ``$SYS`` rows and every percentile equal, and both
packages' ``check_exposition`` must accept both texts with the same sample
count. Tolerance 0: the arithmetic is the same, operation for operation.
"""

import json

import numpy as np
import pytest

from mqtt_tpu import telemetry as jtel

from mqtt_tpu_torch import telemetry as ttel

SEEDS = (0, 1, 7)


def _drive(tel, seed: int):
    """Register and observe one seeded sequence on a fresh registry of
    ``tel``'s package; returns the registry and its plain histograms."""
    rng = np.random.default_rng(seed)
    reg = tel.MetricsRegistry()
    hists = []
    calls = {"n": 0}

    def ticking():
        calls["n"] += 1
        return calls["n"] * 3

    reg.counter("mqtt_tpu_test_events_total", "Events seen\nby the test \\ path").inc(int(rng.integers(1, 50)))
    reg.counter("mqtt_tpu_test_calls_total", "A callback counter", fn=ticking)
    for lab in ("a", 'q"uote', "back\\slash", "new\nline", ""):
        c = reg.counter("mqtt_tpu_test_labelled_total", "Labelled", kind=lab, shard=str(int(rng.integers(0, 4))))
        c.inc(int(rng.integers(0, 1000)))
    reg.gauge("mqtt_tpu_test_level", "A stored gauge").set(float(rng.integers(0, 10)))
    reg.gauge("mqtt_tpu_test_ratio", "A fractional gauge").set(float(rng.random()))
    reg.gauge("mqtt_tpu_test_live", "A callback gauge", fn=lambda: 2.5e15)
    reg.gauge("mqtt_tpu_test_inf", "An infinite gauge", fn=lambda: float("inf"))
    lat = reg.histogram("mqtt_tpu_test_latency_seconds", "Latency", stage="issue")
    for v in rng.lognormal(-8.0, 2.0, 400):
        lat.observe(float(v))
    hists.append(lat)
    fill = reg.histogram("mqtt_tpu_test_fill_ratio", "Fill", bounds=tel.FILL_BOUNDS, tile="0")
    for v in rng.random(97):
        fill.observe(float(v))
    hists.append(fill)
    # the scrape-time merge of per-thread shards (the sharded matcher's
    # per-shard compile histograms render this way)
    shards = [tel.Histogram() for _ in range(3)]
    for s in shards:
        for v in rng.exponential(0.01, 50):
            s.observe(float(v))

    def merged():
        m = tel.Histogram()
        for s in shards:
            m.merge(s)
        return m

    reg.histogram("mqtt_tpu_test_compile_seconds", "Merged shards", fn=merged)
    empty = reg.histogram("mqtt_tpu_test_empty_seconds", "Nothing observed")
    hists.append(empty)
    return reg, hists


@pytest.mark.parametrize("seed", SEEDS)
def test_exposition_is_byte_identical(seed):
    jreg, _ = _drive(jtel, seed)
    treg, _ = _drive(ttel, seed)
    want = jreg.exposition()
    got = treg.exposition()
    assert got == want
    assert got.encode() == want.encode()


@pytest.mark.parametrize("seed", SEEDS)
def test_check_exposition_accepts_both_texts_alike(seed):
    jreg, _ = _drive(jtel, seed)
    treg, _ = _drive(ttel, seed)
    texts = (jreg.exposition(), treg.exposition())
    counts = {(pkg.__name__, i): pkg.check_exposition(t) for pkg in (jtel, ttel) for i, t in enumerate(texts)}
    assert len(set(counts.values())) == 1 and next(iter(counts.values())) > 0
    for bad in ("no_value_here\n", "# TYPE x flavour\n", "# what\nx 1\n", ""):
        for pkg in (jtel, ttel):
            with pytest.raises(ValueError):
                pkg.check_exposition(bad)


@pytest.mark.parametrize("seed", SEEDS)
def test_sys_tree_and_percentiles_are_equal(seed):
    jreg, jh = _drive(jtel, seed)
    treg, th = _drive(ttel, seed)
    assert treg.sys_tree() == jreg.sys_tree()
    for a, b in zip(jh, th):
        assert b.bounds == a.bounds and b.counts == a.counts and b.count == a.count and b.sum == a.sum
        for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert b.percentile(q) == a.percentile(q)
        assert b.summary() == a.summary()


def test_histogram_edges_match():
    for tel in (jtel, ttel):
        h = tel.Histogram(base=1e-6, growth=2.0, n_buckets=8)
        h.observe(h.bounds[3])  # on a boundary: that bucket (le)
        h.observe(1e9)  # past every bound: +Inf
        assert h.counts[3] == 1 and h.counts[-1] == 1
        assert h.percentile(0.99) == h.bounds[-1]
    a, b = jtel.Histogram(bounds=(1.0, 2.0)), ttel.Histogram(bounds=(1.0, 2.0))
    for h in (a, b):
        with pytest.raises(ValueError):
            h.merge(type(h)())
    # a failing callback renders the stored (empty) child
    for tel in (jtel, ttel):
        reg = tel.MetricsRegistry()
        reg.histogram("mqtt_tpu_test_broken_seconds", "Broken", fn=lambda: 1 / 0)
        reg.gauge("mqtt_tpu_test_broken", "Broken", fn=lambda: 1 / 0)
        assert tel.check_exposition(reg.exposition()) > 0
    assert jtel.escape_label_value('a"b\\c\nd') == ttel.escape_label_value('a"b\\c\nd')
    assert jtel.escape_help("a\\b\nc") == ttel.escape_help("a\\b\nc")


def test_registry_refuses_what_the_jax_registry_refuses():
    for tel in (jtel, ttel):
        reg = tel.MetricsRegistry()
        reg.counter("mqtt_tpu_test_x_total", "x")
        with pytest.raises(ValueError, match="re-registered"):
            reg.gauge("mqtt_tpu_test_x_total", "x")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("9bad", "x")
        # the same (name, labels) returns the same child
        assert reg.counter("mqtt_tpu_test_x_total") is reg.counter("mqtt_tpu_test_x_total")


# -- the telemetry facade: stage clocks, batch and delivery observations -----


def _stage_lists(seed: int, n: int = 120) -> list:
    """Seeded per-publish stage lists as the pipeline stamps them: the
    decode path with the device legs split, the coarse device batch (the
    exact map, a host route), the batched fan-out's encode/flush or the
    coarse fanout, and the fast path's decode/admission/fanout."""
    rng = np.random.default_rng(seed)
    shapes = (
        ("decode", "admission", "staging_wait", "h2d", "device_dispatch", "d2h", "encode", "flush"),
        ("decode", "admission", "staging_wait", "device_batch", "fanout"),
        ("decode", "admission", "staging_wait", "h2d", "device_dispatch", "d2h", "fanout"),
        ("decode", "admission", "fanout"),
        ("decode", "admission", "not_a_stage", "encode", "flush"),
    )
    out = []
    for _ in range(n):
        shape = shapes[int(rng.integers(0, len(shapes)))]
        out.append([(s, float(rng.exponential(3e-4))) for s in shape])
    return out


def _facade(tel, seed: int, tmp_path) -> object:
    """One seeded run of observations through a ``Telemetry`` of ``tel``'s
    package: finished stage clocks, batch service and fill, leg waits,
    fallback classes, deliveries by tenant and QoS, amplification counts."""
    rng = np.random.default_rng(seed + 100)
    tele = tel.Telemetry(sample=4, ring=32, dump_dir=str(tmp_path))
    for k, stages in enumerate(_stage_lists(seed)):
        clock = tel.StageClock()
        clock.t0 = clock.last = 5.0
        for stage, dt in stages:
            clock.stamp_until(stage, clock.last + dt)
        tele.observe_publish(clock, f"t/{k % 7}", k % 3)
        tele.observe_batch(float(rng.exponential(2e-3)), int(rng.integers(1, 4096)), int(rng.integers(0, 4097)))
        tele.observe_leg_wait(("h2d", "d2h", "other")[k % 3], float(rng.exponential(1e-4)))
        tele.note_fallback(("admission", "issue_error", "resolve_error", "stop", "other")[k % 5], k % 4)
        tele.observe_delivery(clock.total(), ("", "acme", "\x00")[k % 3], k % 3, ("local", "remote")[k % 2])
        tele.publish_encodes.inc(k % 2)
        tele.fanout_deliveries.inc(k % 5)
        tele.rebuild_hist.observe(float(rng.exponential(0.05)))
    return tele


@pytest.mark.parametrize("seed", SEEDS)
def test_stage_clocks_render_identical_text_and_sys_rows(seed, tmp_path):
    """The same stage lists through the facade of each package: byte-equal
    ``exposition()`` and equal ``sys_tree()``, ``bench_block()``,
    ``fanout_block()`` and flight-recorder rows (their wall stamp apart)."""
    j, t = _facade(jtel, seed, tmp_path / "j"), _facade(ttel, seed, tmp_path / "t")
    assert t.exposition() == j.exposition()
    assert ttel.check_exposition(t.exposition()) == jtel.check_exposition(j.exposition()) > 0
    assert t.sys_tree() == j.sys_tree()
    assert t.bench_block() == j.bench_block()
    assert t.fanout_block(500) == j.fanout_block(500)
    assert t.sampled_publishes.value == j.sampled_publishes.value == 120
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"} for r in recs]  # noqa: E731
    assert strip(t.recorder.ring) == strip(j.recorder.ring)
    # the coarse device_batch and fanout stages hold the split legs' sums
    assert t.stage_hist["device_batch"].count == t.stage_hist["staging_wait"].count


def test_publish_clock_sampling_and_the_flight_dump_match(tmp_path):
    """1-in-N sampling decisions and the outbound gate agree call for call;
    a synchronous dump writes the ring, rate-limited alike."""
    j = jtel.Telemetry(sample=5, dump_dir=str(tmp_path / "j"))
    t = ttel.Telemetry(sample=5, dump_dir=str(tmp_path / "t"))
    for _ in range(50):
        assert (j.publish_clock() is None) == (t.publish_clock() is None)
        assert j.sample_outbound() == t.sample_outbound()
    for tel, tele in ((jtel, j), (ttel, t)):
        clock = tel.StageClock()
        clock.stamp("decode")
        tele.observe_publish(clock, "x", 1)
    paths = [tele.recorder.dump("manual") for tele in (j, t)]
    assert all(paths) and [tele.recorder.dump("again") for tele in (j, t)] == [None, None]
    docs = [json.load(open(p)) for p in paths]
    for d in docs:
        d.pop("time_unix")
        for r in d["records"]:
            r.pop("t")
            r.pop("total_ms"), r.pop("stages_ms")
    assert docs[0] == docs[1]
    assert (t.recorder.dumps, t.recorder.dumps_suppressed) == (j.recorder.dumps, j.recorder.dumps_suppressed) == (1, 1)
