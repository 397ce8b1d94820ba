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
