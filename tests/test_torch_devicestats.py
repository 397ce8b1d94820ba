"""The port's per-card observability (``mqtt_tpu_torch.ops.devicestats``)
against the JAX package's (``mqtt_tpu.ops.devicestats``), on the CPU.

- The first-launch ledger: a ``KernelWatch`` of each package around its
  own ``flat_match_packed`` (the JAX jitted entry point; the port's
  dispatch to the plain version on CPU tensors), fed the same batches,
  notes one event per new signature in a private ledger of each package:
  equal counts and equal shape buckets. The sharded matcher's mesh-step
  watches (``sharded_step``, ``sharded_tile_compact_c<cap>``) note one
  event per new batch bucket and capacity, as the JAX package's do. A
  CUDA wrapper of ``ops/kernels.py`` given CPU tensors raises and notes
  nothing; the ``nvcc`` and ``cc`` builds are noted under their names.
- ``DeviceStatsPlane(device="cpu")``: its ``snapshot()`` and
  ``sys_tree()`` equal the JAX plane's on the CPU backend (one host
  device, the JAX plane restricted to its first) with the same profiler
  stamps and the same tile state, sentinels included; only
  ``time_unix``, ``platform`` and the ledger's ``compiles`` block, whose
  events are each package's own, may differ. ``DeviceStatsPlane("cuda")``
  raises where CUDA is absent.

Tolerance 0: counts, strings and the profiler's floats are equal.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqtt_tpu.ops import devicestats as jds
from mqtt_tpu.ops import flat as jflat
from mqtt_tpu.parallel import make_mesh as jax_make_mesh
from mqtt_tpu.parallel.sharded import ShardedTpuMatcher
from mqtt_tpu.tracing import DeviceProfiler as JProfiler

from mqtt_tpu_torch import native
from mqtt_tpu_torch import telemetry as ttel
from mqtt_tpu_torch.ops import devicestats as tds
from mqtt_tpu_torch.ops import flat as tflat
from mqtt_tpu_torch.ops import kernels
from mqtt_tpu_torch.parallel import ShardedTorchMatcher, make_mesh
from mqtt_tpu_torch.tracing import DeviceProfiler as TProfiler

from test_torch_flat import build_twins, jax_arrays, packed_batch
from test_torch_topics import MAX_LEVELS, corpus_ops, corpus_topics

# batch sizes in the order they arrive: repeats must note nothing
SIZES = (16, 16, 32, 16, 64, 32, 64, 128)


def test_ledger_notes_one_event_per_new_signature():
    jidx, tidx, jf, tf = build_twins(corpus_ops(41, n_subs=600))
    j_ledger, t_ledger = jds.CompileLedger(), tds.CompileLedger()
    j_watch = jds.KernelWatch("flat_match_packed", jflat.flat_match_packed, ledger=j_ledger)
    t_watch = tds.KernelWatch("flat_match_packed", tflat.flat_match_packed, ledger=t_ledger)
    j_arrays = jax_arrays(jf)
    t_arrays = tflat.device_index_from_numpy(tf.table, tf.pat_kind, tf.pat_depth, tf.pat_mask, "cpu")
    topics = corpus_topics(42, n=max(SIZES))
    for k, n in enumerate(SIZES):
        tokens = packed_batch(topics[:n], tf)
        want = np.asarray(j_watch(*j_arrays, jnp.asarray(tokens), max_levels=MAX_LEVELS))
        got = t_watch(*t_arrays, torch.from_numpy(tokens), max_levels=MAX_LEVELS).numpy()
        assert np.array_equal(got, want)
        assert t_ledger.total() == j_ledger.total() == len(set(SIZES[: k + 1]))
    assert t_ledger.counts() == j_ledger.counts() == {"flat_match_packed": len(set(SIZES))}
    assert [e["shape_bucket"] for e in t_ledger.events()] == [e["shape_bucket"] for e in j_ledger.events()]
    assert t_ledger.attribution(2).splitlines()[0] == j_ledger.attribution(2).splitlines()[0]
    # the port's signature also keys the device: the same shape elsewhere is new
    cpu, meta = torch.zeros((4, 2)), torch.zeros((4, 2), device="meta")
    assert tds._sig_of((cpu,), {}) != tds._sig_of((meta,), {})
    assert tds._shape_bucket((cpu, 3), {"capacity": 8}) == jds._shape_bucket((np.zeros((4, 2)), 3), {"capacity": 8})


def test_ledger_registry_families_and_snapshot():
    reg = ttel.MetricsRegistry()
    ledger = tds.CompileLedger()
    ledger.note_compile("flat_probe_ranges", "16x18", 0.0002)
    ledger.bind_registry(reg)
    ledger.note_compile("scatter_rows", "8x16", 0.0001)  # a kernel first seen after binding
    ledger.note_compile("flat_probe_ranges", "32x18", 0.0003)
    text = reg.exposition()
    assert ttel.check_exposition(text) > 0
    assert 'mqtt_tpu_matcher_recompiles_total{kernel="flat_probe_ranges"} 2' in text
    assert 'mqtt_tpu_matcher_recompiles_total{kernel="scatter_rows"} 1' in text
    assert "mqtt_tpu_matcher_compile_seconds_count 3" in text
    snap = ledger.snapshot()
    assert snap["total"] == 3 and snap["kernels"] == {"flat_probe_ranges": 2, "scatter_rows": 1}
    assert [e["kernel"] for e in snap["recent"]] == ["flat_probe_ranges", "scatter_rows", "flat_probe_ranges"]


def test_cuda_wrapper_on_cpu_tensors_raises_and_notes_nothing():
    before = tds.LEDGER.total()
    table = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.flat_probe_ranges(table, table[0], table[0], table[0], torch.zeros((4, 18), dtype=torch.int32), 8)
    assert tds.LEDGER.total() == before
    assert kernels.flat_probe_ranges.watch.kernel == "flat_probe_ranges"
    assert {f.watch.kernel for f in (kernels.flat_match_compact, kernels.scatter_rows, kernels.rules_eval,
                                     kernels.agg_reduce, kernels.keystream, kernels.flat_match_slots,
                                     kernels.sharded_match_slots, kernels.tile_compact)} == {
        "flat_match_compact", "scatter_rows", "rules_eval", "agg_reduce", "keystream", "flat_match_slots",
        "sharded_match_slots", "tile_compact"}


def test_watch_switch_skips_signatures_alike():
    for ds in (jds, tds):
        ledger = ds.CompileLedger()
        watch = ds.KernelWatch("k", lambda x: x, ledger=ledger)
        ds.set_watch_enabled(False)
        try:
            assert not ds.watch_enabled()
            watch(np.zeros(3))
        finally:
            ds.set_watch_enabled(True)
        watch(np.zeros(3))
        watch(np.zeros(3))
        assert ledger.total() == 1


def test_sharded_mesh_step_notes_as_the_jax_package_does():
    jidx, tidx, _, _ = build_twins(corpus_ops(43, n_subs=400))
    pm = ShardedTorchMatcher(tidx, mesh=make_mesh(["cpu"] * 8), max_levels=MAX_LEVELS)
    jm = ShardedTpuMatcher(jidx, mesh=jax_make_mesh(jax.devices()[:8]), max_levels=MAX_LEVELS, lazy=False)
    try:
        pm.rebuild()
        jm.rebuild()
        topics = corpus_topics(44, n=200)
        j0, t0 = jds.LEDGER.counts(), tds.LEDGER.counts()
        for n in (100, 100, 200, 60, 200):
            pm.match_topics(topics[:n])
            jm.match_topics(topics[:n])
        jd = {k: v - j0.get(k, 0) for k, v in jds.LEDGER.counts().items() if v != j0.get(k, 0)}
        td = {k: v - t0.get(k, 0) for k, v in tds.LEDGER.counts().items() if v != t0.get(k, 0)}
        assert td.get("sharded_step") == jd.get("sharded_step") == 3, (td, jd)  # buckets 128, 256, 64
        t_compact = {k: v for k, v in td.items() if k.startswith("sharded_tile_compact_c")}
        j_compact = {k: v for k, v in jd.items() if k.startswith("sharded_tile_compact_c")}
        assert t_compact == j_compact and t_compact
        # the per-shard compile histograms and the tile fill histograms
        assert pm.merged_shard_compile().count == sum(h.count for h in pm.shard_compile_hists) >= pm.n_shards
        assert len(pm.tile_fill_hists) == pm.n_batch == jm.n_batch
        assert [h.count for h in pm.tile_fill_hists] == [h.count for h in jm.tile_fill_hists]
        assert [h.counts for h in pm.tile_fill_hists] == [h.counts for h in jm.tile_fill_hists]
        assert pm.tile_hit_counts().tolist() == jm.tile_hit_counts().tolist()
        assert pm.device_skew_ratio() == jm.device_skew_ratio()
    finally:
        pm.close()
        jm.close()


def test_builds_are_noted_under_their_names(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    # writes an empty library where -o points: enough for the build step
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; shift; done\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kbuild")
    before = tds.LEDGER.counts()
    kernels.build_all()
    after = tds.LEDGER.counts()
    for source in kernels.SOURCES:
        assert after.get(f"nvcc:{source}", 0) == before.get(f"nvcc:{source}", 0) + 1
    kernels.build_all()  # every library exists now: nothing built, nothing noted
    assert tds.LEDGER.counts() == after
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "cbuild")
    native._build(native.NATIVE_SRC)
    assert tds.LEDGER.count("cc:mqtt_native.c") == before.get("cc:mqtt_native.c", 0) + 1


# -- DeviceStatsPlane -------------------------------------------------------------


class _Tiles:
    """The tile state a sharded matcher exports, fixed."""

    def __init__(self, hits):
        self.hits = np.asarray(hits, dtype=np.int64)

    def tile_hit_counts(self):
        return self.hits.copy()

    def device_skew_ratio(self):
        return tds.skew_of(self.hits)


def _stamp(profilers, seed: int) -> None:
    """The same synthetic batches into each profiler: issue and D2H stamps
    from a seeded clock (no sleeps), some overlapping, some compact."""
    rng = np.random.default_rng(seed)
    t = 100.0
    for k in range(40):
        t0 = t + float(rng.random()) * 1e-3
        t1 = t0 + float(rng.random()) * 1e-4
        s0 = t1 + float(rng.random()) * 2e-3
        s1 = s0 + float(rng.random()) * 5e-4
        compact = bool(rng.random() < 0.5)
        nbytes = int(rng.integers(64, 1 << 20))
        for prof in profilers:
            rec = prof.open_batch()
            rec.devices = (0,)
            prof.note_dispatch(rec, t0, t1)
            rec.d2h_bytes, rec.d2h_bytes_ranges, rec.d2h_bytes_dense = nbytes, 2 * nbytes, 4 * nbytes
            rec.compact, rec.compact_overflow = compact, compact and k % 7 == 0
            prof.note_resolve(rec, s0, s1)
        # every third batch starts while the previous one is still open
        t = s1 if k % 3 else t1


def _without(d: dict, *keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


@pytest.mark.parametrize("stamped", [False, True], ids=["empty", "stamped"])
def test_cpu_plane_matches_the_jax_planes_cpu_snapshot(stamped):
    jp, tp = JProfiler(), TProfiler()
    if stamped:
        _stamp((jp, tp), 5)
    jplane = jds.DeviceStatsPlane(ledger=jds.CompileLedger())
    jplane._devices = jplane._devices[:1]  # the host: one device, as the port's "cpu" plane lists it
    tplane = tds.DeviceStatsPlane(ledger=tds.CompileLedger(), device="cpu")
    for plane, prof in ((jplane, jp), (tplane, tp)):
        plane.attach_profiler(prof)
        plane.attach_matcher(_Tiles([7, 3]) if stamped else _Tiles([]))
    want, got = jplane.snapshot(), tplane.snapshot()
    assert _without(got, "time_unix", "devices", "compiles") == _without(want, "time_unix", "devices", "compiles")
    assert [_without(d, "platform") for d in got["devices"]] == [_without(d, "platform") for d in want["devices"]]
    dev = got["devices"][0]
    assert dev["hbm"] == {"live_bytes": None, "peak_bytes": None, "limit_bytes": None, "ratio": 0.0}
    assert (dev["platform"], want["devices"][0]["platform"]) == ("cpu", "cpu")
    assert dev["batches"] == (40 if stamped else 0)
    j_rows = {k: v for k, v in jplane.sys_tree().items() if not k.startswith("compiles/")}
    t_rows = {k: v for k, v in tplane.sys_tree().items() if not k.startswith("compiles/")}
    assert t_rows == j_rows and t_rows["0/hbm_live_bytes"] == -1
    assert tplane.hbm_ratio() == jplane.hbm_ratio() == 0.0 and not tplane.hbm_degraded()


def test_cpu_plane_registry_carries_the_sentinels():
    reg = ttel.MetricsRegistry()
    plane = tds.DeviceStatsPlane(reg, ledger=tds.CompileLedger(), device="cpu")
    m = ShardedTorchMatcher.__new__(ShardedTorchMatcher)  # the attributes the plane reads
    m.tile_fill_hists = [ttel.Histogram(bounds=ttel.FILL_BOUNDS) for _ in range(2)]
    m.tile_hit_counts = lambda: np.array([4, 4])
    m.device_skew_ratio = lambda: 1.0
    plane.attach_matcher(m)
    text = reg.exposition()
    assert ttel.check_exposition(text) > 0
    for fam in ("hbm_live_bytes", "hbm_peak_bytes", "hbm_limit_bytes"):
        assert f'mqtt_tpu_device_{fam}{{device="0"}} -1' in text
    assert 'mqtt_tpu_device_hbm_ratio{device="0"} 0' in text
    assert "mqtt_tpu_device_skew_ratio 1" in text
    assert 'mqtt_tpu_device_tile_hits_total{tile="1"} 4' in text
    assert 'mqtt_tpu_device_tile_fill_ratio_count{tile="0"} 0' in text


def test_cuda_plane_raises_without_cuda():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tds.DeviceStatsPlane(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tds.DeviceStatsPlane(ttel.MetricsRegistry())
    with pytest.raises(ValueError):
        tds.DeviceStatsPlane(device="meta")
