#!/usr/bin/env python3
"""Drive the PyTorch port's publish path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as it ends:

1. The card (``nvidia-smi`` name and power limit) and the toolchain.
2. The kernel build: ``nvcc`` for ``sm_90a`` on every source in
   ``mqtt_tpu_torch/csrc`` (all started together), with ``-Xptxas -v``;
   then phase "native": the host C tokenizer and materializer
   (``mqtt_tpu_torch/native``) built with the host compiler.
3. The main path's two 1M-subscription configurations (the BASELINE
   configs 2 and 3 of ``bench.py``: 3-level topics with 10% ``+``; 8-level
   topics with 5% ``#``) built as tries and compiled to device indexes
   with the cyclic collector off, then frozen (``freeze_index``) and the
   collector's thresholds raised (``tune_for_throughput``), as bench.py
   does before it measures; every later setup does the same.
4. Every kernel against its plain PyTorch version on the card, at the main
   path's shapes (batches of 4096 and 65536 topics on both indexes, a
   compact capacity below the batch's hits, a fold-sized row scatter), with
   tolerance 0 (all outputs are integers); each kernel's CUDA-event time,
   bound and plain time, and ``torch.index_copy``'s time beside the row
   scatter. After cfg2's main path, K1 again at the smallest batch bucket
   its default-budget feed launched; after cfg3's, K2 likewise.
5. The main path, once per configuration, with the launch counts set to 0
   just before it: ``MatchStage`` → ``DeltaMatcher`` → ``TorchMatcher`` on
   ``cuda``, >= 64K publishes in three waves through a stage with a fixed
   batch of 4096, a few hundred subscribes and unsubscribes between the
   first two, and the background fold (a ``scatter_rows`` launch) before
   the third; then a fourth wave under ``torch.profiler``, whose device
   activity over its wall time gives the card's idle share; then a stage
   at the server's default settings (250 ms latency budget, adaptive
   batches) fed at half the measured rate on a fixed schedule, for the
   per-publish latency. Every result must equal the port's
   ``TopicsIndex.subscribers`` for its topic; results are lazy
   ``SubscribersView`` objects (the matchers' default), each materialized
   for the check after its wave. After each configuration's main path,
   and again after its sharded path, phase "materialize": one batch of
   4096 through the kernels, copied to the host once, then resolved in
   turns by the Python plain version, eager C, C views materialized and
   C views' ``targets()`` (all four checked against each other and the
   trie; ns a hit and a topic each), and the batch tokenized by C and by
   Python (equal arrays; µs a topic).
6. The sharded path, on the same cfg2 and cfg3 tries: ``MatchStage`` →
   ``DeltaMatcher(mesh=make_mesh(["cuda:0"] * 8))`` (4 subscription shards
   x 2 batch tiles, every position on the one card) →
   ``ShardedTorchMatcher``: the replica tries and the four shard indexes
   built, then three waves of publishes with the launch counts set to 0
   just before (150 unsubscribes and subscribes and a flush between the
   first two), and a fourth wave under ``torch.profiler``; each step must
   be one launch of K8 and one of K9 (launches equal to batches); then K8
   (the step over both tiles, one launch) and K9 (the tile compaction, at
   the capacity the path settled at and below the tiles' hits) held
   against their plain versions at the path's shapes and at batches of
   65,536. Every result must equal the trie's (every client of cfg2 and
   cfg3 holds one filter, where the sharded matcher is identical to the
   trie).
7. Tenant namespaces (cfgN): 8 tenants x 2,500 scoped subscriptions
   beside global top-level wildcards (client, ``$SHARE`` and inline),
   8,192 publishes, two thirds scoped, through ``MatchStage`` over
   ``DeltaMatcher`` and then over ``DeltaMatcher(mesh=...)``, each with
   lazy views and with eager results. Every result must equal the trie's:
   the namespace guard keeps every global wildcard off the scoped topics
   on the device routes too.
8. The predicate path (cfgP): cfg2's 1M subscriptions with cfg9's 100,000
   distinct ``$GT`` rules on every 10th filter, 1,000 each of
   ``$CONTAINS``, ``$EQS`` and ``$AND`` rules, and one hot topic whose 64
   subscribers hold ``$MEAN``/``$MAX``/``$MIN`` windows of 32 and 64
   samples: ``PredicateEngine`` (K4 ``rules_eval`` on every staged batch,
   K5 ``agg_reduce`` when a fan-out completes >= 4 large windows) through
   ``MatchStage`` and ``apply``, three waves of JSON publishes. Every
   filtered subscriber set and emission must equal the trie walk filtered
   by the host interpreter.
9. The re-encryption path (cfgR, cfg10's shape): 4 tenants x 128 keys, an
   encrypted namespace, fan-out 100, payloads of 256 and 4096 bytes:
   ``RecryptEngine`` (K6 ``keystream`` on the staged decrypt leg and on
   every ``seal_fanout``). Every decrypted publish must equal its
   plaintext, and every sealed payload must open under its subscriber's
   key (all through the plain PyTorch AES on the card, one per publish
   through the numpy ``open_with_key``).
10. Retained delivery (bench.py config 11's retained scan,
    ``bench.py:1345-1372``), at 50,000 and at 1,000,000 retained topics,
    with 4 tenant namespaces x 2,000 scoped topics, 64 ``$SYS`` and 64
    ``$other`` topics and a namespace holding an over-deep topic:
    ``RetainedMatchEngine`` (K1 with one filter over the device-resident
    corpus) answers config 11's 64 filters and 27 others in three rounds,
    300 retains and 300 clears (a namespace compacting) between the first
    two, every answer equal to the walk (``TopicsIndex.messages``); a
    fourth round under the profiler; the per-scan split; K1 held against
    its plain version at the corpus's capacity.
11. The re-key re-seal (cfgR's setup): a tenant's 4,096 encrypted retained
    payloads of 256 B and 4,096 of 4096 B re-sealed across a new epoch
    through ``RecryptEngine.reseal_batch``, one K6 launch per call; every
    new payload carries the epoch's tag and opens under the new key, and
    the engine's answers stay the same; then K6 at that block count
    against its plain version.

12. The device plane's instruments (phase "observe", run on cfg2 after
    its sharded phases): one ``MetricsRegistry`` with a
    ``tracing.DeviceProfiler`` on the single-card stage (a fresh
    ``DeltaMatcher`` on the trie as it stands) and on the sharded stage,
    a ``DeviceStatsPlane`` (per-card memory, the sharded matcher's tiles),
    the first-launch ledger, and the port's lock plane armed with its
    order witness. One wave through both routes with all of it attached
    and armed, then the same wave bare, both under ``torch.profiler``,
    with the launch counts set to 0 just before and read after (the
    single-card route must launch K1 or K2, the sharded K8 and K9; the
    counts join the kernels line). Every answer must equal the trie's,
    the profiler must hold one record
    with both windows per device batch, duty cycle and overlap lie in
    [0, 1], one device window per card, live <= peak <= limit with the
    limit ``torch.cuda.mem_get_info()``'s, and the witness no violation.
    Printed: the per-leg split (issue, D2H, idle gap, p50 and p99), duty
    cycle and overlap beside the traced busy share, memory, the ledger's
    events, lock acquisitions and waits, matches/s armed and bare, each
    with the card's name and power limit. The same registry goes to the
    predicate and re-encryption engines (and the tenant plane) of the
    later phases, and is rendered once at the end (phase "observe
    render"), checked with ``check_exposition`` for every engine's
    families.

Phase 4 also holds K7 (``flat_match_core``, the single-index entry point
of K8's kernel) and K4-K6 against their plain versions at the shapes these
paths give them (K5's MEAN within ``1e-5 * max(1, |want|)``, the rest with
tolerance 0).

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
the main paths, worst error, times and bound). K7 and K8 are one CUDA
kernel: the sharded path launches it through K8's wrapper, which counts
its launches; K7's wrapper (S = 1) is on no main path, so its row shows 0
launches and names the row whose launches it rides (``"inside"``). The
last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero, printing no result, when CUDA is absent or the package is
not beside this script.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM int32 rate outside the tensor cores: 132 SMs x 64 int32 lanes
# x 1.98 GHz boost clock. A float32 compare runs at the same rate (the CUDA
# C++ Programming Guide's throughput table, compute capability 9.0: 64
# compare/min/max results per clock per SM).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# conflict-free shared-memory lookups: 32 banks x 132 SMs x 1.98 GHz (a
# ceiling K6 meets beside its bound, not the bound itself)
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
N_SUBS = 1_000_000
WAVE = 24_576  # publishes per wave; three waves per configuration
BATCHES = (4096, 65536)
MAIN_BATCH = 4096  # MatchStage's max_batch: the kernel shape the main path runs
MESH_POSITIONS = 8  # the sharded path's mesh: 2 batch tiles x 4 subscription shards
OUT_SLOTS = 64  # the sharded matcher's sid slots per (shard, topic)
REPLACES = {
    "flat_probe_ranges": "mqtt_tpu/ops/flat.py:1007",
    "flat_match_compact": "mqtt_tpu/ops/flat.py:1052",
    "scatter_rows": "mqtt_tpu/ops/flat.py:1191",
    "rules_eval": "mqtt_tpu/ops/predicates.py:58",
    "agg_reduce": "mqtt_tpu/ops/predicates.py:99",
    "keystream": "mqtt_tpu/ops/recrypt.py:214",
    "flat_match_slots": "mqtt_tpu/ops/flat.py:858",
    "sharded_step": "mqtt_tpu/parallel/sharded.py:631",
    "tile_compact": "mqtt_tpu/parallel/sharded.py:93",
}
SOURCES = {
    "flat_probe_ranges": "mqtt_tpu_torch/csrc/flat_match.cu",
    "flat_match_compact": "mqtt_tpu_torch/csrc/flat_match.cu",
    "scatter_rows": "mqtt_tpu_torch/csrc/flat_match.cu",
    "rules_eval": "mqtt_tpu_torch/csrc/predicates.cu",
    "agg_reduce": "mqtt_tpu_torch/csrc/predicates.cu",
    "keystream": "mqtt_tpu_torch/csrc/recrypt.cu",
    "flat_match_slots": "mqtt_tpu_torch/csrc/sharded.cu",
    "sharded_step": "mqtt_tpu_torch/csrc/sharded.cu",
    "tile_compact": "mqtt_tpu_torch/csrc/sharded.cu",
}
# K7's wrapper is the S = 1 entry point of K8's kernel, on no main path
INSIDE = {"flat_match_slots": "sharded_step"}
HOT_TOPIC = "hot/agg/v"  # cfgP's window topic
HOT_PER_WAVE = 192  # hot-topic publishes per cfgP wave
MEAN_TOL = 1e-5  # K5's MEAN against its plain version and the host: 1e-5 * max(1, |want|)
N_RECRYPT = 4096  # cfgR: encrypted publishes per payload size (bench.py cfg10)
RECRYPT_SIZES = (256, 4096)
RECRYPT_FANOUT = 100
N_TENANTS = 4
KEYS_PER_TENANT = 128
# retained delivery: bench.py config 11's retained-scan corpus (leg 2, 50,000
# topics) and a fleet keeping one retained status topic per device of 1M
RETAINED_SIZES = (50_000, 1_000_000)
RET_TENANTS = 4  # tenant namespaces of scoped retained topics beside the global corpus
RET_PER_TENANT = 2_000
RET_CHURN = 300  # retains, and as many clears, between the first two rounds
N_RESEAL = 4096  # cfgR: retained encrypted payloads per size re-sealed at a re-key


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# -- configurations (copies of bench.py's build_cfg2 / build_cfg3) ------------


def build_cfg2(n_subs: int, rng: random.Random):
    """3-level topics, 10% single-level + wildcards (bench.py:172)."""
    from mqtt_tpu_torch import Subscription, TopicsIndex

    v0 = [f"region{i}" for i in range(100)]
    v1 = [f"device{i}" for i in range(100)]
    v2 = [f"metric{i}" for i in range(100)]
    entries = []
    for i in range(n_subs):
        parts = [rng.choice(v0), rng.choice(v1), rng.choice(v2)]
        if rng.random() < 0.10:
            parts[rng.randrange(3)] = "+"
        entries.append((f"cl{i}", Subscription(filter="/".join(parts), qos=i % 3)))
    index = TopicsIndex()
    index.subscribe_bulk(entries)

    def topic_gen():
        return f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"

    return index, entries, topic_gen


def build_cfg3(n_subs: int, rng: random.Random):
    """Deep 8-level topics, 5% multi-level # wildcards (bench.py:193)."""
    from mqtt_tpu_torch import Subscription, TopicsIndex

    v_top = [f"t{i}" for i in range(1000)]
    v = [f"s{i}" for i in range(30)]

    def rand_parts():
        return [rng.choice(v_top)] + [rng.choice(v) for _ in range(7)]

    entries = []
    for i in range(n_subs):
        parts = rand_parts()
        if rng.random() < 0.05:
            depth = rng.randint(1, 7)
            parts = parts[:depth] + ["#"]
        entries.append((f"cl{i}", Subscription(filter="/".join(parts), qos=i % 3)))
    index = TopicsIndex()
    index.subscribe_bulk(entries)

    def topic_gen():
        return "/".join(rand_parts())

    return index, entries, topic_gen


def topic_for(flt: str, rng: random.Random) -> str:
    """A topic the filter matches (wildcards filled with fresh levels)."""
    parts = flt.split("/")
    if parts[-1] == "#":
        parts = parts[:-1] + [f"z{rng.randrange(9)}"]
    return "/".join(p if p != "+" else f"w{rng.randrange(9)}" for p in parts)


# -- timing -------------------------------------------------------------------


def event_ms(torch, fn, iters: int) -> float:
    """Mean time per call from CUDA events around back-to-back calls,
    queued behind a device sleep of 4e7 cycles (about 20 ms): while the
    card sleeps the host queues the calls, so the events time the device's
    work and not the host's launch cost (unless the host needs longer than
    the sleep)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time for the work (ms) and what bounds it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def probe_ops(B: int, P: int, L: int) -> int:
    """int32 operations of the probes: per (topic, pattern) pair, two hash
    lanes of four operations per level, eight key-word compares and the
    meta decode (16)."""
    return B * P * (8 * L + 24)


# -- phases -------------------------------------------------------------------


def phase_card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"phase card: ok torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    return {"card": card}


def phase_build() -> float:
    from mqtt_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    dt = time.perf_counter() - t0
    for source in kernels.SOURCES:
        kernels.library(source)
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {source}: {line.strip()}")
    log(f"phase build: ok {dt:.2f} s ({', '.join(kernels.SOURCES)})")
    return dt


def _settle_gc() -> None:
    """After a setup built with the cyclic collector off: move the built
    graph out of its reach and raise its thresholds, as bench.py does
    before it measures (``tune_for_throughput`` and ``freeze_index``, the
    port's copies of ``utils/gctune.py``)."""
    from mqtt_tpu_torch.utils import freeze_index, tune_for_throughput

    freeze_index()
    gc.enable()
    tune_for_throughput()


def phase_native() -> float:
    """Build the port's C host code (the tokenizer and the materializer)
    with the host compiler and load both."""
    from mqtt_tpu_torch import native

    t0 = time.perf_counter()
    native.lib()
    t1 = time.perf_counter()
    acc = native.accel()
    t2 = time.perf_counter()
    log(f"phase native: ok {native.compiler()} built mqtt_native.c in {t1 - t0:.2f} s and accelmod.c "
        f"({acc.__name__}) in {t2 - t1:.2f} s")
    return t2 - t0


def phase_setup(name: str, make_config, n_subs: int, seed: int, device):
    from mqtt_tpu_torch import DeltaMatcher

    rng = random.Random(seed)
    # the cyclic collector rescans the growing trie on every generation-2
    # pass, which makes a 1M-subscription build quadratic: build with it
    # off, then freeze the built graph out of its reach
    gc.disable()
    try:
        t0 = time.perf_counter()
        index, entries, topic_gen = make_config(n_subs, rng)
        t1 = time.perf_counter()
        dm = DeltaMatcher(index, max_levels=8, rebuild_interval=0.5, device=device)
        t2 = time.perf_counter()
    finally:
        _settle_gc()
    fl = dm.snapshot.index
    table_bytes = int(dm.snapshot.device_arrays[0].numel() * 4)
    log(f"phase setup {name}: ok {n_subs} subscriptions, trie {t1 - t0:.1f} s, "
        f"index {t2 - t1:.1f} s, entries {fl.n_entries}, P {fl.num_patterns}, "
        f"S {fl.table.shape[0]}, table {table_bytes} B, sat {fl.n_sat}, spill {fl.n_spill}, "
        f"gc thresholds {gc.get_threshold()}, {gc.get_freeze_count()} objects frozen")
    return {"name": name, "index": index, "entries": entries, "topic_gen": topic_gen,
            "rng": rng, "dm": dm, "table_bytes": table_bytes}


def _tokens(torch, flat, topics, fl, device):
    tok1, tok2, lengths, is_dollar, _ = flat.tokenize_topics(topics, fl.max_levels, fl.salt)
    return torch.from_numpy(flat.pack_tokens(tok1, tok2, lengths, is_dollar)).to(device)


def _comparer(torch, rec: dict):
    """``compare(name, got, want, what)``: fail unless the kernel's output
    equals its plain version's (tolerance 0); keeps the worst error."""

    def compare(name, got, want, what):
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name} {what}: shape/dtype differ")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        check(err == 0, f"{name} {what}: kernel disagrees with its plain version (max abs err {err})")

    return compare


def phase_kernels(torch, cfgs: list, device, iters: int = 20) -> dict:
    """Each kernel against its plain version on the same inputs on the
    card; returns the per-kernel record at the main path's shape."""
    from mqtt_tpu_torch.ops import flat
    from mqtt_tpu_torch.ops.matcher import pick_compact_capacity

    on_cuda = device.type == "cuda"

    def measure(fn, n):
        return event_ms(torch, fn, n) if on_cuda else _host_ms(fn, n)

    rec: dict = {k: {"max_abs_err": 0} for k in REPLACES}

    compare = _comparer(torch, rec)

    def timed(name, cfg, B, what, kernel, plain, n_bytes, n_ops, library=None, plain_iters=3):
        bound_ms, bound_by = bound(n_bytes, n_ops)
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        row["ms"] = measure(kernel, iters)
        row["plain_ms"] = measure(plain, plain_iters)
        if library is not None:
            row["library_ms"] = measure(library, iters)
        lib = "" if library is None else f", index_copy {row['library_ms']:.4f} ms"
        log(f"  {name} {cfg} {what}: err 0, {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms{lib}, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B, {n_ops} int32 ops)")
        # the JSON line reports each kernel at the main path's batch shape on
        # the configuration whose main path leans on it
        lead = {"flat_probe_ranges": "cfg2", "flat_match_compact": "cfg3", "scatter_rows": "cfg2",
                "flat_match_slots": "cfg2"}
        if B == MAIN_BATCH and cfg == lead[name]:
            rec[name].update(row)

    for cfg in cfgs:
        snap = cfg["dm"].snapshot
        fl = snap.index
        arrays = snap.device_arrays
        L = fl.max_levels
        P = fl.num_patterns
        for B in BATCHES:
            topics = [cfg["topic_gen"]() for _ in range(B)]
            tokens = _tokens(torch, flat, topics, fl, device)
            rows = int(torch.unique(flat.probe_slots(*arrays, tokens, max_levels=L)).numel())
            in_bytes = tokens.numel() * 4 + rows * 64 + 3 * P * 4

            # K1: packed ranges
            got = flat.flat_match_packed(*arrays, tokens, max_levels=L)
            want = flat.flat_match_packed_plain(*arrays, tokens, L)
            compare("flat_probe_ranges", got, want, f"{cfg['name']} B={B}")
            n_hits = int(want[:, 2 * P].sum())
            timed(
                "flat_probe_ranges", cfg["name"], B, f"B={B} P={P} rows={rows} hits={n_hits}",
                lambda: flat.flat_match_packed(*arrays, tokens, max_levels=L),
                lambda: flat.flat_match_packed_plain(*arrays, tokens, L),
                in_bytes + got.numel() * 4, probe_ops(B, P, L),
            )

            # K2: compaction at the main path's adaptive capacity, and below n_hits
            capacity = pick_compact_capacity(0, max(1.0, n_hits / B), B, B * P * fl.window, {})
            small = max(1, n_hits // 2)
            for cap in (capacity, small):
                got = flat.flat_match_compact(*arrays, tokens, max_levels=L, capacity=cap)
                want = flat.flat_match_compact_plain(*arrays, tokens, L, cap)
                compare("flat_match_compact", got, want, f"{cfg['name']} B={B} cap={cap}")
                check(int(got[0]) == n_hits and bool(got[1]) == (n_hits > cap), "K2 header wrong")
            timed(
                "flat_match_compact", cfg["name"], B,
                f"B={B} cap={capacity} hits={n_hits} (also equal at cap {small} < hits)",
                lambda: flat.flat_match_compact(*arrays, tokens, max_levels=L, capacity=capacity),
                lambda: flat.flat_match_compact_plain(*arrays, tokens, L, capacity),
                # the probes, then a scan and a write over the B·P counts
                in_bytes + (2 + 2 * B + capacity) * 4, probe_ops(B, P, L) + 4 * B * P + 2 * n_hits,
            )

            # K7: flat_match_core on the single index (S = 1), K slots
            got = flat.flat_match_core(*arrays, tokens, max_levels=L, out_slots=OUT_SLOTS)
            want = flat.flat_match_core_plain(*arrays, tokens, L, OUT_SLOTS)
            for g, w, part in zip(got, want, ("slots", "totals", "overflow")):
                compare("flat_match_slots", g, w, f"{cfg['name']} B={B} {part}")
            timed(
                "flat_match_slots", cfg["name"], B, f"S=1 B={B} P={P} K={OUT_SLOTS} hits={n_hits}",
                lambda: flat.flat_match_core(*arrays, tokens, max_levels=L, out_slots=OUT_SLOTS),
                lambda: flat.flat_match_core_plain(*arrays, tokens, L, OUT_SLOTS),
                # the probes' reads, then B·K slots, B totals and B flags
                in_bytes + B * OUT_SLOTS * 4 + B * 5, probe_ops(B, P, L) + B * OUT_SLOTS,
            )

        # K3: a fold-sized row scatter (a few hundred touched buckets)
        S = arrays[0].shape[0]
        k = 512
        g = torch.Generator(device="cpu").manual_seed(5)
        idx = torch.randperm(S, generator=g)[:k].to(torch.int32).to(device)
        rows_t = torch.randint(-(2**31), 2**31, (k, 16), generator=g, dtype=torch.int64).to(torch.int32).to(device)
        idx64 = idx.to(torch.int64)
        got = flat.scatter_rows(arrays[0], idx, rows_t)
        want = flat.scatter_rows_plain(arrays[0], idx, rows_t)
        compare("scatter_rows", got, want, f"{cfg['name']} k={k}")
        check(torch.equal(torch.index_copy(arrays[0], 0, idx64, rows_t), got), "K3 disagrees with index_copy")
        timed(
            "scatter_rows", cfg["name"], MAIN_BATCH, f"S={S} k={k}",
            lambda: flat.scatter_rows(arrays[0], idx, rows_t),
            lambda: flat.scatter_rows_plain(arrays[0], idx, rows_t),
            2 * S * 64 + k * 4 + k * 64, 0,
            library=lambda: torch.index_copy(arrays[0], 0, idx64, rows_t),
            plain_iters=5,
        )
    log("phase kernels: ok every kernel equals its plain version (tolerance 0)")
    return rec


def phase_kernel_small_batch(torch, rec: dict, cfg: dict, device, name: str, iters: int = 20) -> None:
    """K1 (``name`` ``flat_probe_ranges``) or K2 (``flat_match_compact``)
    against its plain version at the smallest batch bucket that the
    configuration's default-budget feed launched (``phase_main`` records
    the buckets); K2 at the capacity the matcher held for that bucket."""
    from mqtt_tpu_torch.ops import flat
    from mqtt_tpu_torch.ops.matcher import pick_compact_capacity

    on_cuda = device.type == "cuda"
    compare = _comparer(torch, rec)
    snap = cfg["dm"].snapshot
    fl, arrays = snap.index, snap.device_arrays
    L, P = fl.max_levels, fl.num_patterns
    B = cfg["paced_buckets"][0]
    topics = [cfg["topic_gen"]() for _ in range(B)]
    tokens = _tokens(torch, flat, topics, fl, device)
    want = flat.flat_match_packed_plain(*arrays, tokens, L)
    n_hits = int(want[:, 2 * P].sum())
    rows = int(torch.unique(flat.probe_slots(*arrays, tokens, max_levels=L)).numel())
    in_bytes = tokens.numel() * 4 + rows * 64 + 3 * P * 4
    if name == "flat_probe_ranges":
        compare(name, flat.flat_match_packed(*arrays, tokens, max_levels=L), want, f"{cfg['name']} B={B}")
        what = ""
        n_bytes = in_bytes + want.numel() * 4
        n_ops = probe_ops(B, P, L)
        kernel = lambda: flat.flat_match_packed(*arrays, tokens, max_levels=L)  # noqa: E731
        plain = lambda: flat.flat_match_packed_plain(*arrays, tokens, L)  # noqa: E731
    else:
        capacity = snap._caps.get(B) or pick_compact_capacity(0, max(1.0, n_hits / B), B, B * P * fl.window, {})
        for cap in (capacity, max(1, n_hits // 2)):
            got = flat.flat_match_compact(*arrays, tokens, max_levels=L, capacity=cap)
            compare(name, got, flat.flat_match_compact_plain(*arrays, tokens, L, cap), f"{cfg['name']} B={B} cap={cap}")
        what = f" cap={capacity}"
        n_bytes = in_bytes + (2 + 2 * B + capacity) * 4
        n_ops = probe_ops(B, P, L) + 4 * B * P + 2 * n_hits
        kernel = lambda: flat.flat_match_compact(*arrays, tokens, max_levels=L, capacity=capacity)  # noqa: E731
        plain = lambda: flat.flat_match_compact_plain(*arrays, tokens, L, capacity)  # noqa: E731
    bound_ms, bound_by = bound(n_bytes, n_ops)
    measure = (lambda fn, n: event_ms(torch, fn, n)) if on_cuda else _host_ms
    ms = measure(kernel, iters)
    plain_ms = measure(plain, 3)
    log(f"  {name} {cfg['name']} smallest default-budget bucket B={B} (buckets "
        f"{cfg['paced_buckets']}) P={P}{what} hits={n_hits}: err 0, {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B)")


def _host_ms(fn, n: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


async def _wave(stage, topics):
    t0 = time.perf_counter()
    results = await asyncio.gather(*(stage.submit(t) for t in topics))
    return results, time.perf_counter() - t0


async def _traced_wave(stage, topics, on_cuda: bool):
    """A wave under ``torch.profiler``: the results, the wall seconds, and
    the device's busy and copy microseconds (``_device_busy``; None off
    the card or when the trace holds no device span)."""
    if not on_cuda:
        results, wall = await _wave(stage, topics)
        return results, wall, None, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results, wall = await _wave(stage, topics)
    return (results, wall) + _device_busy(prof)


def _device_busy(prof) -> tuple:
    """The union of the kernel, copy and memset spans in a CUDA trace, and
    the copies' and memsets' share of it, in microseconds; ``(None,
    None)`` when the trace holds no device span."""
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if str(e.device_type).endswith("CUDA")
    )
    if not spans:
        return None, None
    busy = copy = 0.0
    lo, hi = spans[0][0], spans[0][1]
    for a, b, name in spans:
        if "Memcpy" in name or "Memset" in name:
            copy += b - a
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo, copy


async def _paced(stage, topics, rate: float):
    """Submit ``topics`` on a fixed schedule of ``rate`` per second (open
    loop: a late result does not delay the next submission). Returns the
    results and each publish's latency from its scheduled time to its
    result, in seconds."""
    n = len(topics)
    done = [0.0] * n
    futs = []
    t0 = time.perf_counter()
    i = 0
    while i < n:
        now = time.perf_counter()
        while i < n and t0 + i / rate <= now:
            fut = stage.submit(topics[i])
            fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append(fut)
            i += 1
        if i < n:
            await asyncio.sleep(max(0.0, t0 + i / rate - time.perf_counter()))
    results = await asyncio.gather(*futs)
    await asyncio.sleep(0)  # let the last done-callbacks run
    return results, [done[k] - (t0 + k / rate) for k in range(n)]


class GcPauses:
    """The cyclic collector's pauses, recorded through ``gc.callbacks``:
    ``(end time, seconds, generation)`` per collection."""

    def __init__(self):
        self.pauses: list[tuple[float, float, int]] = []
        self._t0 = 0.0

    def __call__(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._t0 = now
        else:
            self.pauses.append((now, now - self._t0, info["generation"]))

    def summary(self, t_lo: float, t_hi: float) -> str:
        ps = [(dt, g) for t, dt, g in self.pauses if t_lo <= t <= t_hi]
        if not ps:
            return "no gc pause"
        return (f"{len(ps)} gc pauses ({sum(g == 2 for _, g in ps)} of generation 2), "
                f"total {sum(dt for dt, _ in ps) * 1e3:.3f} ms, max {max(dt for dt, _ in ps) * 1e3:.3f} ms")


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def _verify(index, topics, results, what) -> int:
    """Every result (each view materialized) must equal the trie's;
    returns how many were lazy views."""
    from mqtt_tpu_torch import native, subscribers_equal

    view_t = native.accel().SubscribersView
    check(len(results) == len(topics), f"{what}: {len(results)} results for {len(topics)} topics")
    n_views = 0
    for topic, got in zip(topics, results):
        if isinstance(got, view_t):
            n_views += 1
            got = got.materialize()
        check(subscribers_equal(got, index.subscribers(topic)), f"{what}: mismatch on {topic!r}")
    return n_views


def phase_main(cfg: dict, wave: int, n_churn: int = 150, paced_s: float = 2.0) -> dict:
    """The main path on one configuration (launch counts reset just before).

    Throughput and batch latency come from three waves through a stage
    with no latency budget and a fixed batch of 4096: each wave is a burst
    of ``wave`` publishes, and at the default budget the stage's admission
    would send most of a burst to the host walk. A fourth wave runs under
    the profiler for the idle share. Per-publish latency at the server's
    default settings comes from a stage with its defaults, fed at half
    the measured rate for ``paced_s`` seconds."""
    from mqtt_tpu_torch import MatchStage, Subscription
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.ops.flat import _bucket

    index, dm, rng, gen = cfg["index"], cfg["dm"], cfg["rng"], cfg["topic_gen"]
    name = cfg["name"]
    on_cuda = dm.snapshot.device.type == "cuda"
    entries = cfg["entries"]
    live = [entries[rng.randrange(len(entries))] for _ in range(n_churn)]
    unsub = {(c, s.filter) for c, s in live}
    resub = [entries[rng.randrange(len(entries))][1].filter for _ in range(n_churn)]
    churned = sorted({f for _, f in unsub} | set(resub))
    hot = [topic_for(f, rng) for f in churned]

    def wave_topics():
        return [gen() for _ in range(wave - len(hot))] + hot

    waves = [wave_topics() for _ in range(4)]
    stats0 = dict(dm.stats.as_dict())
    out: dict = {}

    async def drive():
        stage = MatchStage(dm, index.subscribers, max_batch=MAIN_BATCH, latency_budget_s=None,
                           max_pending=1 << 20)
        stage.start()
        out["t_waves"] = time.perf_counter()
        try:
            r1, t1 = await _wave(stage, waves[0])
            out["views"] = _verify(index, waves[0], r1, f"{name} wave 1")
            for c, f in sorted(unsub):
                index.unsubscribe(f, c)
            for k, f in enumerate(resub):
                index.subscribe(f"churn{k}", Subscription(filter=f, qos=k % 3, identifier=k + 1))
            r2, t2 = await _wave(stage, waves[1])
            out["views"] += _verify(index, waves[1], r2, f"{name} wave 2 (overlay)")
            deadline = time.perf_counter() + 60
            while dm.pending_deltas and time.perf_counter() < deadline:
                await asyncio.sleep(0.05)
            check(dm.pending_deltas == 0, "the background fold did not drain the overlay")
            r3, t3 = await _wave(stage, waves[2])
            out["views"] += _verify(index, waves[2], r3, f"{name} wave 3 (folded)")
            out["seconds"] = t1 + t2 + t3
            out["service"] = [dt for _, dt in stage.service_log]
            out["stats"] = dict(dm.stats.as_dict())
            out["t_waves"] = (out["t_waves"], time.perf_counter())
            r4, out["traced_s"], out["busy_us"], out["copy_us"] = await _traced_wave(
                stage, waves[3], on_cuda)
            _verify(index, waves[3], r4, f"{name} wave 4 (traced)")
        finally:
            await stage.stop()
        check(stage.admission_fallbacks == 0 and not stage.fallbacks,
              f"stage fell back to the host walk: {stage.fallbacks}")

        rate = 0.5 * 3 * wave / out["seconds"]
        paced_topics = [gen() for _ in range(max(1, int(rate * paced_s)))]
        stage = MatchStage(dm, index.subscribers)  # the server's defaults
        stage.start()
        t_paced = time.perf_counter()
        try:
            rp, lat = await _paced(stage, paced_topics, rate)
        finally:
            await stage.stop()
        out["t_paced"] = (t_paced, time.perf_counter())
        _verify(index, paced_topics, rp, f"{name} paced at the default budget")
        out.update(rate=rate, lat=lat, paced=stage, n_paced=len(paced_topics))
        cfg["paced_buckets"] = sorted({_bucket(max(1, n), minimum=16) for n, _ in stage.service_log})

    pauses = GcPauses()
    gc.callbacks.append(pauses)
    kernels.reset_launches()
    try:
        asyncio.run(drive())
    finally:
        gc.callbacks.remove(pauses)
    launches = dict(kernels.LAUNCHES)
    stats = out["stats"]
    n = 3 * wave
    seconds = out["seconds"]
    folds = stats["folds"] - stats0["folds"]
    fallbacks = stats["host_fallbacks"] - stats0["host_fallbacks"]
    check(folds >= 1, "the churn was not folded")
    check(launches["scatter_rows"] > 0 or not on_cuda, "the fold did not launch scatter_rows")
    service = out["service"]
    log(f"phase main {name}: ok {n} publishes bit-identical to the trie, "
        f"{n / seconds:.1f} matches/s (stage wall {seconds:.3f} s, fixed batch {MAIN_BATCH}, no budget), "
        f"{len(service)} batches, batch resolve p50 {_pct(service, 0.5) * 1e3:.3f} ms "
        f"max {max(service) * 1e3:.3f} ms, host_fallbacks {fallbacks}, "
        f"compact_batches {stats['compact_batches'] - stats0['compact_batches']}, "
        f"compact_overflows {stats['compact_overflows'] - stats0['compact_overflows']}, folds {folds}, "
        f"P {dm.snapshot.index.num_patterns}, table {cfg['table_bytes']} B, "
        f"{out['views']} of {n} results lazy views (each materialized against the trie after its wave), "
        f"{pauses.summary(*out['t_waves'])}")
    wall_us = out["traced_s"] * 1e6
    if out["busy_us"] is None:
        log(f"  {name} traced wave: {wave} publishes in {out['traced_s']:.3f} s; "
            "idle share not measured (no device span in the trace)")
    else:
        log(f"  {name} traced wave: {wave} publishes in {out['traced_s']:.3f} s under the profiler, "
            f"device busy {out['busy_us']:.1f} us (copies {out['copy_us']:.1f} us), "
            f"idle share {1 - out['busy_us'] / wall_us:.6f}")
    lat, paced, rate = out["lat"], out["paced"], out["rate"]
    budget = paced.latency_budget_s
    late = [k / rate for k, x in enumerate(lat) if x > budget]
    late_at = f" scheduled at {min(late):.3f}-{max(late):.3f} s" if late else ""
    service = [dt for _, dt in paced.service_log]
    log(f"  {name} default budget ({budget * 1e3:.0f} ms): {out['n_paced']} publishes "
        f"offered at {rate:.1f}/s, publish latency p50 {_pct(lat, 0.5) * 1e3:.3f} ms "
        f"p99 {_pct(lat, 0.99) * 1e3:.3f} ms max {max(lat) * 1e3:.3f} ms, "
        f"{len(late)} over the budget{late_at}, {len(service)} batches "
        f"(resolve p50 {_pct(service, 0.5) * 1e3:.3f} ms max {max(service) * 1e3:.3f} ms), "
        f"final batch cap {paced._batch_cap}, buckets {cfg['paced_buckets']}, "
        f"host-walk fallbacks {paced.fallbacks or 0}, "
        f"{pauses.summary(*out['t_paced'])}")
    log(f"  {name} launches on the main path: {launches}")
    return launches


# -- the host half: tokenizer and materializer ---------------------------------


def _fetch_single(torch, cfg: dict, topics: list, device) -> dict:
    """One fixed batch of the single-device path's kernels (the route its
    matcher picks for the batch), copied to the host once."""
    from mqtt_tpu_torch.ops import flat as tflat

    snap = cfg["dm"].snapshot
    fl, arrays, _ = snap._state
    P = fl.pat_depth.shape[0]
    tok1, tok2, lengths, is_dollar, len_ovf = tflat.tokenize_topics(topics, fl.max_levels, fl.salt)
    tokens = torch.from_numpy(tflat.pack_tokens(tok1, tok2, lengths, is_dollar)).to(device)
    b = len(topics)
    if snap.compact and P > 0 and snap._compact_pays(P):
        cap = snap._compact_capacity_for(b, fl)
        out = tflat.flat_match_compact(*arrays, tokens, max_levels=fl.max_levels, capacity=cap).cpu().numpy()
        if out[1]:  # the batch outgrew the policy's buffer: refetch at its hits
            cap = tflat._bucket(int(out[0]), minimum=256)
            out = tflat.flat_match_compact(*arrays, tokens, max_levels=fl.max_levels, capacity=cap).cpu().numpy()
        check(not out[1], "materialize: the compact batch overflowed")
        true_ovf = out[2 + b : 2 + 2 * b].astype(bool) | len_ovf
        return {"route": "compact", "n_hits": int(out[0]), "totals": out[2 : 2 + b], "true_ovf": true_ovf,
                "pair_sid": out[2 + 2 * b : 2 + 2 * b + cap], "pair_shard": None, "table": fl.subs,
                "tables": None, "bytes": out.nbytes}
    out = tflat.flat_match_packed(*arrays, tokens, max_levels=fl.max_levels).cpu().numpy()
    hits = out[:, P : 2 * P].clip(min=0)
    routed = (out[:, 2 * P + 1] != 0) | len_ovf
    return {"route": "ranges", "packed": out, "P": P, "flat": fl, "len_ovf": len_ovf,
            "n_hits": int(hits[~routed].sum()), "bytes": out.nbytes}


def _fetch_sharded(torch, sh: dict, topics: list) -> dict:
    """One fixed batch of the sharded step (K8) and its tile compaction
    (K9) at a capacity the batch fits, copied to the host once and stitched
    into one topic-major (shard, sid) stream as the matcher's resolver
    stitches it."""
    import numpy as np

    from mqtt_tpu_torch.ops import flat as tflat
    from mqtt_tpu_torch.parallel import sharded

    snap = sh["dm"].snapshot
    placed, tables, salt = snap._compiled
    tok1, tok2, lengths, is_dollar, len_ovf = tflat.tokenize_topics(topics, snap.max_levels, salt)
    host_tokens = torch.from_numpy(tflat.pack_tokens(tok1, tok2, lengths, is_dollar))
    tokens_on = {dev: host_tokens.to(dev) for dev in snap._devices}
    b, T = len(topics), snap.n_batch
    bl = b // T
    gathered = snap._step(placed, tokens_on, bl)
    cap = max(16, snap._caps.get(b, 0) // T)
    while True:
        rows = np.empty((T, 2 + 2 * bl + 2 * cap), dtype=np.int32)
        for owner, tiles in snap._tiles_of.items():
            rows[tiles] = sharded.tile_compact(*gathered[owner], cap).cpu().numpy()
        if not rows[:, 1].any():
            break
        cap = tflat._bucket(int(rows[:, 0].max()), minimum=16)
    lo = 2 + 2 * bl
    tile_hits = rows[:, 0]
    return {"route": "sharded", "n_hits": int(tile_hits.sum()), "totals": rows[:, 2 : 2 + bl].reshape(b),
            "true_ovf": rows[:, 2 + bl : 2 + 2 * bl].reshape(b).astype(bool) | len_ovf,
            "pair_shard": np.concatenate([rows[t, lo : lo + tile_hits[t]] for t in range(T)]),
            "pair_sid": np.concatenate([rows[t, lo + cap : lo + cap + tile_hits[t]] for t in range(T)]),
            "table": None, "tables": tables, "bytes": rows.nbytes}


def _resolvers(index, topics: list, f: dict) -> dict:
    """The four ways to turn one fetched batch into results, on the same
    host arrays: the Python plain version, eager C, C views materialized,
    and C views' fan-out plans (``targets()``)."""
    from mqtt_tpu_torch import Subscribers
    from mqtt_tpu_torch.ops import matcher as tm

    walk = index.subscribers

    if f["route"] == "ranges":
        args = (f["packed"], topics, f["flat"], f["P"], f["len_ovf"], None, None)

        def plain():
            return tm.resolve_ranges_py(tm.MatcherStats(), walk, *args)

        def c(lazy):
            return tm.resolve_ranges_native(tm.MatcherStats(), walk, *args, lazy)
    else:
        def plain():
            res, ovf = tm.resolve_compact_py(f["pair_sid"], f["totals"], f["true_ovf"], topics, f["table"],
                                             n_hits=f["n_hits"], pair_shard=f["pair_shard"], tables=f["tables"])
            for i in ovf:
                res[i] = walk(topics[i]) if topics[i] else Subscribers()
            return res

        def c(lazy):
            return tm.materialize_compact_pairs(
                tm.MatcherStats(), walk, f["pair_sid"], f["totals"], f["true_ovf"], f["n_hits"], topics,
                f["table"], f["true_ovf"], pair_shard=f["pair_shard"], tables=f["tables"], lazy=lazy)

    def views(each):
        return [each(r) if type(r) is not Subscribers else r for r in c(True)]

    return {
        "python": plain,
        "eager C": lambda: c(False),
        "views + materialize": lambda: views(lambda v: v.materialize()),
        "views + targets": lambda: views(lambda v: v.targets()),
    }


def phase_materialize(index, topics: list, fetched: dict, what: str, rounds: int = 3) -> dict:
    """The host half of one fixed batch: the C tokenizer against the
    Python one (equal arrays), then the four resolvers of ``_resolvers``
    timed in turns on the same fetched arrays; all four must agree with
    each other and with the trie."""
    import numpy as np

    from mqtt_tpu_torch import Subscribers, subscribers_equal
    from mqtt_tpu_torch.ops import hashing

    b = len(topics)
    tok_c = hashing.tokenize_topics(topics, 8, 0)
    tok_py = hashing.tokenize_topics_py(topics, 8, 0)  # warms the per-token cache as the path does
    check(all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(tok_c, tok_py)),
          f"materialize {what}: the C tokenizer disagrees with the Python one")
    tok_ms = {"C": _host_ms(lambda: hashing.tokenize_topics(topics, 8, 0), 5),
              "python": _host_ms(lambda: hashing.tokenize_topics_py(topics, 8, 0), 5)}

    fns = _resolvers(index, topics, fetched)
    times: dict = {k: [] for k in fns}
    results: dict = {}
    for _ in range(rounds):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            results[k] = fn()
            times[k].append(time.perf_counter() - t0)
    eager = results["eager C"]
    n_views = 0
    for i, t in enumerate(topics):
        want = index.subscribers(t)
        e = eager[i]
        check(type(e) is Subscribers and subscribers_equal(e, want), f"materialize {what}: eager C != trie on {t!r}")
        check(subscribers_equal(results["python"][i], e), f"materialize {what}: python != eager C on {t!r}")
        check(subscribers_equal(results["views + materialize"][i], e),
              f"materialize {what}: a materialized view != eager C on {t!r}")
        plan = results["views + targets"][i]
        if type(plan) is Subscribers:  # a host-walked row
            continue
        n_views += 1
        check([c for c, _ in plan] == list(e.subscriptions), f"materialize {what}: targets() clients differ on {t!r}")
        for c, sub in plan:
            w = e.subscriptions[c]
            check((sub.qos, sub.no_local, sub.retain_as_published, sub.predicates)
                  == (w.qos, w.no_local, w.retain_as_published, w.predicates),
                  f"materialize {what}: targets() of {c} on {t!r} differs from the eager result")
    n_hits = fetched["n_hits"]
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    cells = ", ".join(f"{k} {med[k] * 1e3:.3f} ms ({med[k] * 1e9 / max(1, n_hits):.1f} ns a hit, "
                      f"{med[k] * 1e9 / b:.1f} ns a topic)" for k in fns)
    log(f"phase materialize {what}: ok B={b} {fetched['route']} ({fetched['bytes']} B fetched once), "
        f"{n_hits} hits, {n_views} views; all four agree with each other and the trie; median of {rounds} "
        f"in turns: {cells}")
    log(f"  tokenize {what}: C {tok_ms['C'] * 1e3 / b:.3f} us a topic, python {tok_ms['python'] * 1e3 / b:.3f} "
        f"us a topic (equal arrays, B={b}, 8 levels)")
    return {"ns_hit": {k: med[k] * 1e9 / max(1, n_hits) for k in fns}, "tok_us": tok_ms}


# -- the sharded path -----------------------------------------------------------


def phase_setup_sharded(cfg: dict, device) -> dict:
    """``DeltaMatcher(mesh=...)`` over the configuration's trie: 4 shards x
    2 batch tiles, every position on ``device``. The replica tries are
    built with the cyclic collector off, then frozen."""
    from mqtt_tpu_torch import DeltaMatcher
    from mqtt_tpu_torch.parallel import make_mesh

    mesh = make_mesh([device] * MESH_POSITIONS)
    gc.disable()
    try:
        t0 = time.perf_counter()
        dm = DeltaMatcher(cfg["index"], max_levels=8, background=False, mesh=mesh, out_slots=OUT_SLOTS)
        dt = time.perf_counter() - t0
    finally:
        _settle_gc()
    snap = dm.snapshot
    flats = snap._flats
    log(f"phase setup sharded {cfg['name']}: ok mesh {mesh.shape} of {[str(d) for d in mesh.unique_devices()]}, "
        f"partition + {snap.n_shards} shard builds {dt:.1f} s (per shard "
        f"{[round(x, 3) for x in snap.shard_compile_seconds]} s), subscriptions {[f.n_subs for f in flats]}, "
        f"entries {[f.n_entries for f in flats]}, P {[f.num_patterns for f in flats]}, "
        f"NB {flats[0].table.shape[0]}, sat {[f.n_sat for f in flats]}, spill {[f.n_spill for f in flats]}")
    return {"name": cfg["name"], "dm": dm, "mesh": mesh, "cfg": cfg, "setup_s": dt}


def phase_kernels_sharded(torch, rec: dict, sh: dict, device, main: bool, iters: int = 20) -> None:
    """K8 (the step over the 4 stacked shards and both batch tiles, one
    launch, as the path launches it) and K9 (the tile compaction, at the
    capacity the path's batches of 4096 used, and one below the tiles'
    hits) against their plain versions on the same inputs, after the
    sharded path ran, at batches of 4096 (the path's) and 65,536 (K9 at
    the capacity the path's policy picks for them); fills ``rec`` at 4096
    when ``main``."""
    from mqtt_tpu_torch.ops import flat
    from mqtt_tpu_torch.ops.matcher import pick_compact_capacity
    from mqtt_tpu_torch.parallel import sharded

    on_cuda = device.type == "cuda"
    compare = _comparer(torch, rec)
    snap = sh["dm"].snapshot
    placed, _tables, salt = snap._compiled
    (arrays,) = placed.values()  # every position on one device: one stack
    S, T, K, L = snap.n_shards, snap.n_batch, snap.out_slots, snap.max_levels
    P = arrays[1].shape[1]
    gen = sh["cfg"]["topic_gen"]

    def measure(fn, n):
        return event_ms(torch, fn, n) if on_cuda else _host_ms(fn, n)

    def row(name, B, what, kernel, plain, n_bytes, n_ops, plain_iters=3):
        bound_ms, bound_by = bound(n_bytes, n_ops)
        r = {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "ms": measure(kernel, iters), "plain_ms": measure(plain, plain_iters)}
        log(f"  {name} {sh['name']} {what}: err 0, {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B, {n_ops} int32 ops)")
        if main and B == MAIN_BATCH:
            rec[name].update(r)

    for B in BATCHES:
        bl = B // T
        topics = [gen() for _ in range(B)]
        tok1, tok2, lengths, is_dollar, _ = flat.tokenize_topics(topics, L, salt)
        tokens = torch.from_numpy(flat.pack_tokens(tok1, tok2, lengths, is_dollar)).to(device)

        # K8: the step, one launch of the kernel over the T tiles and the S
        # stacked shards
        def step(fn, tokens=tokens, bl=bl):
            out = torch.empty((T, S, bl, K), dtype=torch.int32, device=device)
            tot = torch.empty((T, S, bl), dtype=torch.int32, device=device)
            ovf = torch.empty((T, S, bl), dtype=torch.bool, device=device)
            fn(*arrays, tokens, max_levels=L, out=out, totals=tot, overflow=ovf)
            return out, tot, ovf

        got = step(sharded.sharded_step)
        want = step(sharded.sharded_step_plain)
        for g, w, part in zip(got, want, ("slots", "totals", "overflow")):
            compare("sharded_step", g, w, f"{sh['name']} S={S} B={B} {part}")
        n_hits = int(want[1].clamp(max=K).sum())
        rows = sum(
            int(torch.unique(flat.probe_slots(*(a[s] for a in arrays), tokens, max_levels=L)).numel())
            for s in range(S)
        )
        row("sharded_step", B, f"S={S} tiles={T} B={B} P={P} K={K} rows={rows} hits={n_hits} (one launch)",
            lambda: step(sharded.sharded_step), lambda: step(sharded.sharded_step_plain),
            tokens.numel() * 4 + rows * 64 + 3 * S * P * 4 + S * B * (K * 4 + 5),
            probe_ops(B, P, L) * S + B * K * S)

        # K9: the capacity the path's batches of 4096 used (the sticky pick,
        # split over the tiles as match_topics_async splits it) or the one
        # its policy picks for 65,536, and one below the hits (the clip rule)
        out, tot, ovf = got
        if B == MAIN_BATCH:
            check(MAIN_BATCH in snap._caps, f"the sharded path held no capacity for batches of {MAIN_BATCH}")
            cap = max(16, snap._caps[MAIN_BATCH] // T)
        else:
            cap = max(16, pick_compact_capacity(snap.compact_capacity, snap._hits_ewma, B, B * S * K, {}) // T)
        tile_hits = [int(tot[t].clamp(max=K).sum()) for t in range(T)]
        small = max(1, min(tile_hits) // 2)
        for c in (cap, small):
            g = sharded.tile_compact(out, tot, ovf, c)
            w = sharded.tile_compact_plain(out, tot, ovf, c)
            compare("tile_compact", g, w, f"{sh['name']} B={B} cap_local={c}")
            check(g[:, 0].tolist() == tile_hits, "K9 header: hit counts wrong")
        row_w = 2 + 2 * bl + 2 * cap
        row("tile_compact", B, f"T={T} S={S} bl={bl} K={K} cap_local={cap} hits={n_hits} "
            f"(also equal at cap_local {small} < hits)",
            lambda: sharded.tile_compact(out, tot, ovf, cap), lambda: sharded.tile_compact_plain(out, tot, ovf, cap),
            # what the function needs: the totals and flags, each gathered
            # sid once, and the rows; a scan over the segments and the writes
            T * S * bl * 5 + n_hits * 4 + T * row_w * 4, 4 * T * S * bl + 2 * T * cap)
    log(f"phase kernels sharded {sh['name']}: ok K8 and K9 equal their plain versions (tolerance 0)")


def phase_sharded(sh: dict, wave: int, n_waves: int = 3, n_churn: int = 150) -> dict:
    """The sharded path on one configuration (launch counts reset just
    before): ``n_waves`` waves through a stage with no latency budget and
    a fixed batch of 4096, ``n_churn`` unsubscribes and subscribes and a
    flush after the first, then a wave under the profiler."""
    from mqtt_tpu_torch import MatchStage, Subscription
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.parallel import shard_of

    cfg, dm = sh["cfg"], sh["dm"]
    index, rng, gen, entries = cfg["index"], cfg["rng"], cfg["topic_gen"], cfg["entries"]
    name = cfg["name"]
    snap = dm.snapshot
    on_cuda = snap.mesh.devices[0][0].type == "cuda"
    live = [entries[rng.randrange(len(entries))] for _ in range(n_churn)]
    unsub = sorted({(c, s.filter) for c, s in live})
    resub = [entries[rng.randrange(len(entries))][1].filter for _ in range(n_churn)]
    hot = [topic_for(f, rng) for f in sorted({f for _, f in unsub} | set(resub))]
    waves = [[gen() for _ in range(wave - len(hot))] + hot for _ in range(n_waves + 1)]
    stats0 = dict(dm.stats.as_dict())
    out: dict = {}

    async def drive():
        stage = MatchStage(dm, index.subscribers, max_batch=MAIN_BATCH, latency_budget_s=None,
                           max_pending=1 << 20)
        stage.start()
        try:
            seconds = 0.0
            out["views"] = 0
            for w in range(n_waves):
                res, dt = await _wave(stage, waves[w])
                seconds += dt
                out["views"] += _verify(index, waves[w], res, f"sharded {name} wave {w + 1}")
                if w == 0:
                    muts: list = []
                    record = muts.append
                    index.add_observer(record)
                    try:
                        for c, f in unsub:
                            index.unsubscribe(f, c)
                        for k, f in enumerate(resub):
                            index.subscribe(f"shchurn{k}", Subscription(filter=f, qos=k % 3, identifier=k + 1))
                    finally:
                        index.remove_observer(record)
                    out["touched"] = {shard_of(m.kind, m.client, m.filter, m.identifier, snap.n_shards)
                                      for m in muts}
                    out["dirty"] = [s for s in range(snap.n_shards) if snap._dirty[s]]
                    before = list(snap._flats)
                    t0 = time.perf_counter()
                    dm.flush()
                    out["flush_s"] = time.perf_counter() - t0
                    out["recompiled"] = sum(a is not b for a, b in zip(snap._flats, before))
                    out["nb_changed"] = snap._flats[0].table.shape[0] != before[0].table.shape[0]
                    check(dm.pending_deltas == 0, "the flush left deltas pending")
            out["seconds"] = seconds
            out["service"] = [dt for _, dt in stage.service_log]
            out["stats"] = dict(dm.stats.as_dict())
            res, out["traced_s"], out["busy_us"], out["copy_us"] = await _traced_wave(stage, waves[-1], on_cuda)
            _verify(index, waves[-1], res, f"sharded {name} traced wave")
            out["batches"] = dm.stats.batches - stats0["batches"]
        finally:
            await stage.stop()
        check(stage.admission_fallbacks == 0 and not stage.fallbacks,
              f"stage fell back to the host walk: {stage.fallbacks}")

    kernels.reset_launches()
    asyncio.run(drive())
    launches = dict(kernels.LAUNCHES)
    stats, service = out["stats"], out["service"]
    n = n_waves * wave
    touched = out["touched"]
    check(set(out["dirty"]) == touched, f"the churn dirtied shards {out['dirty']}, not {sorted(touched)}")
    check(out["recompiled"] <= len(touched) or out["nb_changed"],
          f"the flush recompiled {out['recompiled']} shards for {len(touched)} touched")
    for k in ("sharded_step", "tile_compact"):
        check(launches[k] > 0 or not on_cuda, f"the sharded path never launched {k}")
        # every position on one card: one launch of each per step
        check(launches[k] == out["batches"] or not on_cuda,
              f"the sharded path launched {k} {launches[k]} times for {out['batches']} batches")
    log(f"phase sharded {name}: ok {n} publishes bit-identical to the trie, "
        f"{n / out['seconds']:.1f} matches/s (stage wall {out['seconds']:.3f} s, fixed batch {MAIN_BATCH}, "
        f"no budget), {len(service)} batches, batch resolve p50 {_pct(service, 0.5) * 1e3:.3f} ms "
        f"max {max(service) * 1e3:.3f} ms, host_fallbacks {stats['host_fallbacks'] - stats0['host_fallbacks']}, "
        f"compact_batches {stats['compact_batches'] - stats0['compact_batches']}, "
        f"compact_overflows {stats['compact_overflows'] - stats0['compact_overflows']}, "
        f"{out['batches']} steps with the traced wave, {out['views']} of {n} results lazy views, "
        f"device_skew_ratio {snap.device_skew_ratio():.6f} (tile hits {snap.tile_hit_counts().tolist()})")
    log(f"  sharded {name} flush: {len(unsub)} unsubscribes + {n_churn} subscribes touched shards "
        f"{sorted(touched)}, dirtied {out['dirty']}; the flush recompiled {out['recompiled']} of "
        f"{snap.n_shards} shards in {out['flush_s']:.3f} s (per shard "
        f"{[round(x, 3) for x in snap.shard_compile_seconds]} s)")
    wall_us = out["traced_s"] * 1e6
    if out["busy_us"] is None:
        log(f"  sharded {name} traced wave: {wave} publishes in {out['traced_s']:.3f} s; "
            "idle share not measured (no device span in the trace)")
    else:
        log(f"  sharded {name} traced wave: {wave} publishes in {out['traced_s']:.3f} s under the profiler, "
            f"device busy {out['busy_us']:.1f} us (copies {out['copy_us']:.1f} us), "
            f"idle share {1 - out['busy_us'] / wall_us:.6f}")
    log(f"  sharded {name} launches on the path: {launches}")
    return launches


# -- the device plane's instruments --------------------------------------------------

# the families a rendered registry must hold once every engine is attached
OBSERVE_FAMILIES = (
    "mqtt_tpu_device_issue_seconds", "mqtt_tpu_device_d2h_seconds", "mqtt_tpu_device_idle_gap_seconds",
    "mqtt_tpu_device_d2h_bytes", "mqtt_tpu_device_duty_cycle_ratio", "mqtt_tpu_device_overlap_ratio",
    "mqtt_tpu_device_hbm_live_bytes", "mqtt_tpu_device_hbm_peak_bytes", "mqtt_tpu_device_hbm_limit_bytes",
    "mqtt_tpu_device_hbm_ratio", "mqtt_tpu_device_skew_ratio", "mqtt_tpu_device_tile_hits_total",
    "mqtt_tpu_device_tile_fill_ratio", "mqtt_tpu_matcher_compile_seconds", "mqtt_tpu_matcher_recompiles_total",
    "mqtt_tpu_matcher_shard_compile_seconds", "mqtt_tpu_predicate_rules", "mqtt_tpu_predicate_evals_total",
    "mqtt_tpu_predicate_filtered_ratio", "mqtt_tpu_recrypt_keys", "mqtt_tpu_recrypt_fanouts_total",
    "mqtt_tpu_recrypt_device_blocks_total", "mqtt_tpu_recrypt_epoch",
)


def _exact_pct(xs, q: float) -> float:
    return _pct(xs, q) if xs else 0.0


def _leg_split(recs) -> str:
    """Issue, D2H and idle-gap p50/p99 in ms, exact from the records'
    own stamps (the histograms' bounds are powers of two apart)."""
    issue = [r.dispatch[1] - r.dispatch[0] for r in recs]
    d2h = [r.d2h[1] - r.d2h[0] for r in recs]
    ends = sorted((r.dispatch[1], max(r.d2h[1], r.dispatch[1])) for r in recs)
    gaps, busy_until = [], 0.0
    for start, end in ends:
        if busy_until and start >= busy_until:
            gaps.append(start - busy_until)
        busy_until = max(busy_until, end)
    return ", ".join(f"{leg} p50 {_exact_pct(xs, 0.5) * 1e3:.3f} p99 {_exact_pct(xs, 0.99) * 1e3:.3f} ms"
                     for leg, xs in (("issue", issue), ("D2H", d2h), ("idle gap", gaps)))


def phase_observe(torch, cfg: dict, sh: dict, wave: int, device, card: str) -> dict:
    """The device plane's instruments on cfg2, after its main and sharded
    phases: one ``MetricsRegistry`` holding a ``DeviceProfiler`` on the
    single-card stage and on the sharded stage, a ``DeviceStatsPlane``
    (memory gauges, the sharded matcher's tiles) and the first-launch
    ledger, with the port's lock plane armed and its witness on. One wave
    runs through both routes with everything attached and armed, under
    ``torch.profiler``; then the same wave bare (nothing attached, the
    ledger's watch off), under ``torch.profiler`` too so the two rates
    compare. The single-card route is a fresh ``DeltaMatcher`` compiled
    from the trie as it stands: cfg2's first one was closed before the
    sharded phase churned the trie. The registry goes on to the engines
    of the later phases and is rendered once at the end
    (``phase_observe_render``)."""
    from mqtt_tpu_torch import DeltaMatcher, MatchStage
    from mqtt_tpu_torch.ops import devicestats, kernels
    from mqtt_tpu_torch.telemetry import MetricsRegistry
    from mqtt_tpu_torch.tracing import DeviceProfiler
    from mqtt_tpu_torch.utils.locked import DEFAULT_PLANE

    class RecordingProfiler(DeviceProfiler):
        """Keeps every record it opens, for the per-record checks."""

        def __init__(self, registry):
            super().__init__(registry)
            self.records: list = []

        def open_batch(self):
            rec = super().open_batch()
            self.records.append(rec)
            return rec

    on_cuda = device.type == "cuda"
    index, gen, name = cfg["index"], cfg["topic_gen"], cfg["name"]
    t_phase = time.perf_counter()
    gc.disable()
    try:
        t0 = time.perf_counter()
        single = DeltaMatcher(index, max_levels=8, background=False, device=device)
        build_s = time.perf_counter() - t0
    finally:
        _settle_gc()
    routes = {"single-card": single, "sharded": sh["dm"]}
    snap_sh = sh["dm"].snapshot
    registry = MetricsRegistry()
    prof = RecordingProfiler(registry)
    plane = devicestats.DeviceStatsPlane(registry, device=device.type)
    plane.attach_profiler(prof)
    plane.attach_matcher(snap_sh)  # the plane binds the first-launch ledger to the registry too
    registry.histogram(
        "mqtt_tpu_matcher_shard_compile_seconds",
        "Per-shard flat-index compile wall time (shard-local histogram shards, merged at scrape)",
        fn=snap_sh.merged_shard_compile,
    )
    witness = DEFAULT_PLANE.arm_witness()
    topics = [gen() for _ in range(wave)]
    ledger0 = devicestats.LEDGER.total()

    async def one_pass(armed: bool) -> dict:
        out = {}
        for rname, dm in routes.items():
            dm.snapshot.profiler = prof if armed else None
            stage = MatchStage(dm, index.subscribers, max_batch=MAIN_BATCH, latency_budget_s=None,
                               max_pending=1 << 20, profiler=prof if armed else None)
            stage.start()
            b0, r0 = dm.stats.batches, len(prof.records)
            try:
                res, dt = await _wave(stage, topics)
            finally:
                await stage.stop()
                dm.snapshot.profiler = None
            check(stage.admission_fallbacks == 0 and not stage.fallbacks,
                  f"observe {rname}: stage fell back to the host walk: {stage.fallbacks}")
            out[rname] = {"results": res, "seconds": dt, "batches": dm.stats.batches - b0,
                          "records": prof.records[r0:]}
        return out

    def traced(armed: bool):
        if not on_cuda:
            t0 = time.perf_counter()
            return asyncio.run(one_pass(armed)), time.perf_counter() - t0, None
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            out = asyncio.run(one_pass(armed))
            wall = time.perf_counter() - t0
        return out, wall, _device_busy(tp)[0]

    DEFAULT_PLANE.reset()
    DEFAULT_PLANE.arm()
    kernels.reset_launches()
    try:
        armed, armed_wall, armed_busy = traced(True)
    finally:
        DEFAULT_PLANE.disarm()
    locks = [st.as_dict() for st in DEFAULT_PLANE.snapshot() if st.acquisitions]
    ledger_armed = devicestats.LEDGER.total()
    devicestats.set_watch_enabled(False)
    try:
        bare, bare_wall, bare_busy = traced(False)
    finally:
        devicestats.set_watch_enabled(True)
    launches = dict(kernels.LAUNCHES)
    for rname in routes:
        for label, run_ in (("armed", armed), ("bare", bare)):
            _verify(index, topics, run_[rname]["results"], f"observe {name} {rname} {label}")
            run_[rname]["results"] = None
    single.close()

    # the checks
    issued = sum(armed[r]["batches"] for r in routes)
    check(prof.batches == issued == len(prof.records),
          f"observe: the profiler folded {prof.batches} batches, {len(prof.records)} records, "
          f"for {issued} device batches issued")
    check(all(r.dispatch is not None and r.d2h is not None for r in prof.records),
          "observe: a record lacks its issue or D2H window")
    check(all(armed[r]["batches"] > 0 for r in routes), "observe: a route issued no device batch")
    check(0.0 <= prof.duty_cycle() <= 1.0 and 0.0 <= prof.overlap_ratio() <= 1.0,
          f"observe: duty cycle {prof.duty_cycle()} or overlap {prof.overlap_ratio()} outside [0, 1]")
    cards = sorted({d.index or 0 for dm in routes.values() for d in _route_devices(dm)})
    windows = prof.device_snapshot()
    check(sorted(windows) == cards, f"observe: device windows {sorted(windows)} for cards {cards}")
    snap = plane.snapshot()
    mem = [d["hbm"] for d in snap["devices"]]
    if on_cuda:
        check(len(mem) == torch.cuda.device_count(), "observe: the plane does not list every card")
        for did, h in enumerate(mem):
            check(0 < h["live_bytes"] <= h["peak_bytes"] <= h["limit_bytes"],
                  f"observe: card {did} memory live {h['live_bytes']} peak {h['peak_bytes']} "
                  f"limit {h['limit_bytes']} out of order")
            check(h["limit_bytes"] == torch.cuda.mem_get_info(did)[1],
                  f"observe: card {did} limit {h['limit_bytes']} is not mem_get_info's")
    check(not witness.violations, f"observe: lock-order violations {witness.violations}")
    for k in ("sharded_step", "tile_compact"):
        check(launches[k] > 0 or not on_cuda, f"observe: the sharded route never launched {k}")
    check(launches["flat_probe_ranges"] + launches["flat_match_compact"] > 0 or not on_cuda,
          "observe: the single-card route launched neither K1 nor K2")

    # the readings
    for rname in routes:
        recs = armed[rname]["records"]
        log(f"phase observe {name} {rname}: {card}; {armed[rname]['batches']} device batches, "
            f"{len(recs)} records, each with both windows; {_leg_split(recs)}")
    log(f"  observe {name} per-leg split (both routes, the profiler's histograms, bucket bounds): "
        + ", ".join(f"{leg} p50 {hist.percentile(0.5) * 1e3:.3f} p99 {hist.percentile(0.99) * 1e3:.3f} ms"
                    for leg, hist in (("issue", prof.issue_hist), ("D2H", prof.d2h_hist),
                                      ("idle gap", prof.idle_gap_hist)))
        + f" ({prof.idle_gap_hist.count} gaps); {card}")
    per_route = []
    for rname in routes:
        replay = DeviceProfiler()
        for r in armed[rname]["records"]:
            replay.note_dispatch(r, *r.dispatch)
            replay.note_resolve(r, *r.d2h)
        per_route.append(f"{rname} {replay.duty_cycle():.6f} / {replay.overlap_ratio():.6f}")
    busy = ("not measured (no device span in the trace)" if armed_busy is None
            else f"{armed_busy / (armed_wall * 1e6):.6f} ({armed_busy:.1f} us of {armed_wall:.3f} s)")
    log(f"  observe {name} duty cycle {prof.duty_cycle():.6f}, overlap {prof.overlap_ratio():.6f} "
        f"(per route, duty / overlap: {', '.join(per_route)}); torch.profiler busy share of the armed "
        f"wave {busy}; {card}")
    for h_ in mem:
        log(f"  observe {name} card memory: live {h_['live_bytes']} B, peak {h_['peak_bytes']} B, "
            f"limit {h_['limit_bytes']} B (ratio {h_['ratio']}); {card}")
    new = devicestats.LEDGER.events()[-(ledger_armed - ledger0):] if ledger_armed > ledger0 else []
    log(f"  observe {name} first-launch ledger: {ledger0} events before the phase "
        f"({devicestats.LEDGER.counts()}), {ledger_armed - ledger0} during the armed wave "
        f"{['%s[%s]' % (e['kernel'], e['shape_bucket']) for e in new]}, "
        f"{devicestats.LEDGER.total() - ledger_armed} during the bare wave (watch off); {card}")
    for st in sorted(locks, key=lambda s: s["name"]):
        log(f"  observe {name} lock {st['name']}: {st['acquisitions']} acquisitions, {st['contended']} contended, "
            f"wait p99 {st['wait_p99_ms']} ms, hold p99 {st['hold_p99_ms']} ms; {card}")
    log(f"  observe {name} witness: {len(witness.edges)} edges {sorted(witness.edges)}, "
        f"{len(witness.violations)} violations; {card}")
    for rname in routes:
        a, b = armed[rname]["seconds"], bare[rname]["seconds"]
        log(f"  observe {name} {rname}: {wave / a:.1f} matches/s armed against {wave / b:.1f} bare "
            f"(both under torch.profiler; single-card index rebuilt in {build_s:.1f} s); {card}")
    bare_share = "not measured" if bare_busy is None else f"{bare_busy / (bare_wall * 1e6):.6f}"
    log(f"phase observe {name}: ok {len(routes)} routes x 2 waves of {wave}, every answer the trie's, "
        f"bare busy share {bare_share}, {time.perf_counter() - t_phase:.1f} s; launches {launches}; {card}")
    return {"registry": registry, "launches": launches, "profiler": prof, "plane": plane, "witness": witness,
            "ledger": ledger_armed, "card": card}


def _route_devices(dm) -> list:
    """The devices a DeltaMatcher's snapshot runs on."""
    snap = dm.snapshot
    mesh = getattr(snap, "mesh", None)
    return mesh.unique_devices() if mesh is not None else [snap.device]


def phase_observe_render(obs: dict) -> None:
    """Render the registry once, after every engine of the later phases
    has registered on it, and check it; the witness has watched every
    phase since ``observe`` and must hold no violation."""
    from mqtt_tpu_torch.ops import devicestats
    from mqtt_tpu_torch.telemetry import check_exposition
    from mqtt_tpu_torch.utils.locked import DEFAULT_PLANE

    t0 = time.perf_counter()
    text = obs["registry"].exposition()
    render_s = time.perf_counter() - t0
    samples = check_exposition(text)
    families = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}
    missing = [f for f in OBSERVE_FAMILIES if f not in families]
    check(not missing, f"observe render: families missing: {missing}")
    witness = obs["witness"]
    check(not witness.violations, f"observe render: lock-order violations {witness.violations}")
    DEFAULT_PLANE.disarm_witness()
    since = devicestats.LEDGER.total() - obs["ledger"]
    kinds: dict = {}
    for e in devicestats.LEDGER.events()[-since:] if since else []:
        kinds[e["kernel"]] = kinds.get(e["kernel"], 0) + 1
    log(f"phase observe render: ok {samples} samples in {len(families)} families (all "
        f"{len(OBSERVE_FAMILIES)} expected present), rendered in {render_s * 1e3:.3f} ms, check_exposition "
        f"passed; the ledger noted {since} events after the armed wave {kinds}; the witness saw "
        f"{len(witness.edges)} edges {sorted(witness.edges)} and no violation; {obs['card']}")


# -- tenant namespaces ------------------------------------------------------------

NS_SEGS = ["e", "1", "a", "$x", "b"] + [f"s{i}" for i in range(75)]
# global filters whose first level is a wildcard: the namespace guard keeps
# them from every scoped topic
NS_GLOBAL = ["#", "+/e/+", "+/#", "+/+/1", "+/a/#", "+/$x/#"]


def build_cfgN(n_tenants: int, per_tenant: int, rng: random.Random):
    """Tenant namespaces beside global wildcards (the repro of the
    namespace-guard fault, grown to ``n_tenants`` x ``per_tenant`` scoped
    subscriptions of one filter per client): scoped filters of 1-4 levels
    with ``+`` and ``#`` levels and tenant-local ``$x`` first levels, a few
    scoped local ``+``/``#`` first levels per tenant, scoped ``$SHARE``
    groups, and the global ``NS_GLOBAL`` clients, a global ``$SHARE/g/#``
    and an inline ``#``. Topics are two thirds scoped (a fifth of those
    with a local ``$x`` first level)."""
    from mqtt_tpu_torch import InlineSubscription, Subscription, TopicsIndex
    from mqtt_tpu_torch.topics import ns_scope_filter, ns_scope_topic

    index = TopicsIndex()
    entries = [(f"gw{g}", Subscription(filter=f, qos=1)) for g, f in enumerate(NS_GLOBAL)]
    entries.append(("gs", Subscription(filter="$SHARE/g/#", qos=1)))
    tenants = [f"nt{t}" for t in range(n_tenants)]
    for t in tenants:
        for i in range(per_tenant):
            depth = rng.randint(1, 4)
            parts = [rng.choice(NS_SEGS) for _ in range(depth)]
            roll = rng.random()
            if roll < 0.2 and depth > 1:
                parts[rng.randrange(1, depth)] = "+"
            elif roll < 0.3:
                parts = parts[: rng.randint(1, depth)] + ["#"]
            if i < 6:
                parts[0] = "+#"[i % 2]
                parts = parts[:1] if parts[0] == "#" else parts
            flt = "/".join(parts)
            if i % 50 == 7:
                flt = f"$SHARE/g{i % 3}/{flt}"
            entries.append((f"{t}:c{i}", Subscription(filter=ns_scope_filter(t, flt), qos=i % 3)))
    index.subscribe_bulk(entries)
    index.inline_subscribe(InlineSubscription(filter="#", identifier=1, handler=lambda *a: None))

    def topic_gen():
        topic = "/".join(rng.choice(NS_SEGS) for _ in range(rng.randint(1, 4)))
        if rng.random() < 0.67:
            if rng.random() < 0.2:
                topic = "$x/" + topic
            return ns_scope_topic(rng.choice(tenants), topic)
        return topic

    return index, len(entries), topic_gen


def phase_namespace(torch, device, n_tenants: int = 8, per_tenant: int = 2500, n_topics: int = 8192) -> dict:
    """The namespace corpus on the card (launch counts reset just before):
    ``n_topics`` publishes through ``MatchStage`` over ``DeltaMatcher``, then
    through ``DeltaMatcher(mesh=make_mesh([device] * 8))``, each with lazy
    views (the default) and with eager results from the C materializer;
    every result must equal the trie's, no global wildcard client may
    reach a scoped topic, and the global ``#`` client must reach every
    global topic that does not start with ``$``."""
    from mqtt_tpu_torch import DeltaMatcher, MatchStage
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.parallel import make_mesh
    from mqtt_tpu_torch.topics import NS_CHAR

    rng = random.Random(11)
    index, n_subs, gen = build_cfgN(n_tenants, per_tenant, rng)
    topics = [gen() for _ in range(n_topics)]
    launches = dict.fromkeys(REPLACES, 0)
    routes = [(mesh, lazy) for mesh in (None, make_mesh([device] * MESH_POSITIONS)) for lazy in (True, False)]
    for mesh, lazy in routes:
        what = ("mesh" if mesh is not None else "single-device") + (" views" if lazy else " eager")
        dm = DeltaMatcher(index, max_levels=8, background=False, device=device, mesh=mesh,
                          out_slots=OUT_SLOTS, lazy=lazy)

        async def drive():
            stage = MatchStage(dm, index.subscribers, max_batch=MAIN_BATCH, latency_budget_s=None,
                               max_pending=1 << 20)
            stage.start()
            try:
                return await asyncio.gather(*(stage.submit(t) for t in topics))
            finally:
                await stage.stop()

        try:
            kernels.reset_launches()
            results = asyncio.run(drive())
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            stats = dm.stats.as_dict()
        finally:
            dm.close()
        n_views = _verify(index, topics, results, f"namespace {what}")
        check((n_views > 0) == lazy, f"namespace {what}: {n_views} lazy views")
        scoped = 0
        for t, r in zip(topics, results):
            wild = {c for c in r.subscriptions if c.startswith("gw")}
            if t[:1] == NS_CHAR:
                scoped += 1
                check(not wild and "$SHARE/g/#" not in r.shared and 1 not in r.inline_subscriptions,
                      f"namespace {what}: a global wildcard reached the scoped topic {t!r}")
            elif t[:1] != "$":
                check("gw0" in wild, f"namespace {what}: the global # client missed {t!r}")
        log(f"phase namespace {what}: ok {n_topics} publishes ({scoped} scoped) over {n_subs} subscriptions "
            f"of {n_tenants} tenants bit-identical to the trie, no global wildcard on a scoped topic; "
            f"{n_views} lazy views, host_fallbacks {stats['host_fallbacks']}, "
            f"compact_batches {stats['compact_batches']}")
    if device.type == "cuda":
        check(launches["flat_probe_ranges"] + launches["flat_match_compact"] > 0
              and launches["sharded_step"] > 0, f"the namespace phase ran no matcher kernel: {launches}")
    log(f"  namespace launches: {launches}")
    return launches


# -- the predicate path (cfgP) and the re-encryption path (cfgR) ---------------


def build_cfgP(n_subs: int, rng: random.Random):
    """cfg2's population (bench.py:172) with predicates: every 10th filter
    carries a distinct ``$GT{v:t}``, t uniform in [0, 1) (bench.py cfg9,
    849-870, at its full 100,000 rules for 1M filters); filters 1, 3 and 7
    of every thousand carry a distinct ``$CONTAINS{x<k>y}``,
    ``$EQS{s:w<k>}`` or ``$AND{$GT{v:a}$LT{v:b}}``; and HOT_TOPIC has 64
    subscribers holding ``$MEAN{v:32}``, ``$MAX{v:32}`` or ``$MIN{v:64}``."""
    from mqtt_tpu_torch import Subscription, TopicsIndex

    v0 = [f"region{i}" for i in range(100)]
    v1 = [f"device{i}" for i in range(100)]
    v2 = [f"metric{i}" for i in range(100)]
    n_gt = max(1, n_subs // 10)
    entries = []
    suffixes = []
    for i in range(n_subs):
        parts = [rng.choice(v0), rng.choice(v1), rng.choice(v2)]
        if rng.random() < 0.10:
            parts[rng.randrange(3)] = "+"
        k = i // 1000
        if i % 10 == 0:
            pred = "$GT{v:%.9f}" % ((i // 10 + rng.random()) / n_gt)
        elif i % 1000 == 1:
            pred = "$CONTAINS{x%dy}" % k
        elif i % 1000 == 3:
            pred = "$EQS{s:w%d}" % k
        elif i % 1000 == 7:
            pred = "$AND{$GT{v:%.6f}$LT{v:%.6f}}" % ((k + 0.5) / 2000, 0.5 + (k + 0.5) / 2000)
        else:
            pred = ""
        preds = (pred,) if pred else ()
        suffixes.extend(preds)
        entries.append((f"cl{i}", Subscription(filter="/".join(parts), qos=i % 3, predicates=preds)))
    for k in range(64):
        pred = ("$MEAN{v:32}", "$MAX{v:32}", "$MIN{v:64}")[k % 3]
        suffixes.append(pred)
        entries.append((f"agg{k}", Subscription(filter=HOT_TOPIC, qos=1, predicates=(pred,))))
    index = TopicsIndex()
    index.subscribe_bulk(entries)

    def topic_gen():
        return f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"

    return index, entries, topic_gen, suffixes


def phase_setup_predicates(n_subs: int, seed: int, device, registry=None) -> dict:
    from mqtt_tpu_torch import DeltaMatcher, PredicateEngine

    rng = random.Random(seed)
    gc.disable()
    try:
        t0 = time.perf_counter()
        index, entries, topic_gen, suffixes = build_cfgP(n_subs, rng)
        t1 = time.perf_counter()
        eng = PredicateEngine(device=device, registry=registry)
        for sfx in suffixes:
            eng.register(sfx)
        t2 = time.perf_counter()
        dm = DeltaMatcher(index, max_levels=8, rebuild_interval=0.5, device=device)
        t3 = time.perf_counter()
    finally:
        _settle_gc()
    g = eng.gauges()
    log(f"phase setup cfgP: ok {len(entries)} subscriptions, trie {t1 - t0:.1f} s, rules {t2 - t1:.1f} s, "
        f"index {t3 - t2:.1f} s; {g['rules']} rules, {g['device_rules']} on the card, "
        f"{g['fields']} field slots, {g['contains']} substrings, {g['equals']} string equalities")
    return {"name": "cfgP", "index": index, "topic_gen": topic_gen, "rng": rng, "dm": dm, "eng": eng}


def cfgP_payload(rng: random.Random) -> bytes:
    return json.dumps({"v": rng.random(), "s": f"w{rng.randrange(1200)}", "t": f"x{rng.randrange(1200)}y"}).encode()


class PredicateReference:
    """The independent reference of cfgP: the trie walk, filtered by the
    host interpreter per predicate, and the windows kept in plain lists."""

    def __init__(self, index):
        from mqtt_tpu_torch.predicates import compile_suffix

        self.index = index
        self.compile = compile_suffix
        self.specs: dict = {}
        self.windows: dict = {}

    def spec(self, sfx):
        s = self.specs.get(sfx)
        if s is None:
            s = self.specs[sfx] = self.compile(sfx)
        return s

    def expect(self, topic: str, payload: bytes):
        """``(subscribers, {cid: (op, values)})``: the filtered set and the
        windows this publish completes."""
        from mqtt_tpu_torch.predicates import eval_rule_host

        ref = self.index.subscribers(topic)
        done = {}
        v = json.loads(payload)["v"]
        for cid, sub in list(ref.subscriptions.items()):
            if not sub.predicates:
                continue
            specs = [self.spec(p) for p in sub.predicates]
            filters = [sp for sp in specs if not sp.is_agg]
            for p, sp in zip(sub.predicates, specs):
                if sp.is_agg:
                    win = self.windows.setdefault((p, cid), [])
                    win.append(v)
                    if len(win) == sp.window:
                        done[cid] = (sp.op, list(win))
                        win.clear()
            if not (filters and any(eval_rule_host(sp, payload) for sp in filters)):
                del ref.subscriptions[cid]
        return ref, done


def _check_emissions(emits, done, what):
    import numpy as np
    from mqtt_tpu_torch.predicates import OP_MAX, OP_MEAN

    got = {target: payload for _kind, target, _sub, payload in emits}
    check(set(got) == set(done), f"{what}: emissions for {sorted(got)[:4]}, expected {sorted(done)[:4]}")
    for cid, (op, values) in done.items():
        if op == OP_MEAN:
            want = sum(values) / len(values)
            check(abs(float(got[cid]) - want) <= MEAN_TOL * max(1.0, abs(want)),
                  f"{what}: MEAN emission {got[cid]!r} for {cid}, expected {want!r}")
        else:
            vals32 = [float(np.float32(x)) for x in values]
            want = b"%.10g" % (max(vals32) if op == OP_MAX else min(vals32))
            check(got[cid] == want, f"{what}: emission {got[cid]!r} for {cid}, expected {want!r}")


def phase_predicates(cfg: dict, wave: int) -> dict:
    """cfgP's main path (launch counts reset just before): three waves of
    ``wave`` JSON publishes through ``MatchStage`` with the predicate
    engine attached (fixed batch of 4096, no budget), then ``apply`` in
    submission order; each result and emission held against the
    reference."""
    from mqtt_tpu_torch import MatchStage, subscribers_equal
    from mqtt_tpu_torch.ops import kernels

    index, dm, eng, rng, gen = cfg["index"], cfg["dm"], cfg["eng"], cfg["rng"], cfg["topic_gen"]
    on_cuda = dm.snapshot.device.type == "cuda"
    ref = PredicateReference(index)
    waves = []
    for _ in range(3):
        topics = [gen() for _ in range(wave - HOT_PER_WAVE)] + [HOT_TOPIC] * HOT_PER_WAVE
        rng.shuffle(topics)
        waves.append((topics, [cfgP_payload(rng) for _ in topics]))
    t = {"features": 0.0, "stage": 0.0, "apply": 0.0}
    counts = {"emissions": 0, "delivered": 0}
    g0 = dict(eng.gauges())

    async def drive():
        stage = MatchStage(dm, index.subscribers, max_batch=MAIN_BATCH, latency_budget_s=None,
                           max_pending=1 << 20, predicates=eng)
        stage.start()
        try:
            for w, (topics, payloads) in enumerate(waves):
                t0 = time.perf_counter()
                feats = [eng.features_for(p) for p in payloads]
                t1 = time.perf_counter()
                results = await asyncio.gather(*(stage.submit(tp, feats=f) for tp, f in zip(topics, feats)))
                t2 = time.perf_counter()
                applied = [eng.apply(r, p, f) for r, p, f in zip(results, payloads, feats)]
                t3 = time.perf_counter()
                t["features"] += t1 - t0
                t["stage"] += t2 - t1
                t["apply"] += t3 - t2
                check(all(f.device_row is not None for f in feats) or not on_cuda,
                      f"cfgP wave {w + 1}: a publish came back without its pass-bit row")
                for tp, p, (subs, emits) in zip(topics, payloads, applied):
                    want, done = ref.expect(tp, p)
                    check(subscribers_equal(subs, want), f"cfgP wave {w + 1}: filtered set differs on {tp!r} {p!r}")
                    _check_emissions(emits, done, f"cfgP wave {w + 1} {tp!r}")
                    counts["emissions"] += len(emits)
                    counts["delivered"] += len(subs.subscriptions)
                del feats, results, applied
            out["service"] = [dt for _, dt in stage.service_log]
        finally:
            await stage.stop()
        check(stage.admission_fallbacks == 0 and not stage.fallbacks,
              f"stage fell back to the host walk: {stage.fallbacks}")

    out: dict = {}
    kernels.reset_launches()
    asyncio.run(drive())
    launches = dict(kernels.LAUNCHES)
    g = eng.gauges()
    n = 3 * wave
    d2h = list(eng._evaluator.d2h_log) if eng._evaluator is not None else []
    delta = {k: g[k] - g0[k] for k in ("device_decisions", "host_evals", "filtered", "deliveries",
                                        "agg_emits", "agg_device_reductions", "oracle_checks",
                                        "oracle_mismatches", "device_batches")}
    check(delta["oracle_mismatches"] == 0, f"cfgP: {delta['oracle_mismatches']} oracle mismatches")
    check(counts["emissions"] > 0 and delta["agg_device_reductions"] > 0, "cfgP: no window reduced on the card")
    check(delta["device_decisions"] > 0, "cfgP: no verdict came from the card")
    if on_cuda:
        check(launches["rules_eval"] > 0 and launches["agg_reduce"] > 0,
              f"cfgP's main path did not launch K4 and K5: {launches}")
    service = out["service"]
    decided = delta["filtered"] + delta["deliveries"]
    log(f"phase predicates cfgP: ok {n} publishes, every filtered set and emission equal to the "
        f"host-interpreted trie walk; stage {n / t['stage']:.1f} matches/s (wall {t['stage']:.3f} s, "
        f"fixed batch {MAIN_BATCH}), features_for {t['features']:.3f} s, apply {t['apply']:.3f} s, "
        f"end to end {n / (t['features'] + t['stage'] + t['apply']):.1f} publishes/s; "
        f"{len(service)} batches, resolve p50 {_pct(service, 0.5) * 1e3:.3f} ms max {max(service) * 1e3:.3f} ms")
    log(f"  cfgP verdicts: device_decisions {delta['device_decisions']}, host_evals {delta['host_evals']} "
        f"by reason {g['host_reasons']}, stale_rows {g['stale_rows']}, filtered ratio "
        f"{delta['filtered'] / decided if decided else 0.0:.6f} ({delta['filtered']} of {decided}), "
        f"delivered {counts['delivered']}, emissions {counts['emissions']} "
        f"({delta['agg_device_reductions']} windows reduced on the card), oracle checks "
        f"{delta['oracle_checks']} mismatches {delta['oracle_mismatches']}")
    if d2h:
        ms = [m for _b, m in d2h]
        log(f"  cfgP verdict copies (D2H into pinned memory, CUDA events): {len(d2h)} of {d2h[0][0]} B, "
            f"p50 {_pct(ms, 0.5):.3f} ms max {max(ms):.3f} ms, {d2h[0][0] / _pct(ms, 0.5) / 1e6:.2f} GB/s at p50")
    log(f"  cfgP launches on the main path: {launches}")
    return launches


def phase_setup_recrypt(seed: int, device, registry=None) -> dict:
    """cfg10's non-fast shape (bench.py:974-1000): 4 tenants x 128 keys,
    the encrypted namespace ``e/``; each tenant has four topic groups,
    each subscribed by 100 keyed subscribers through ``e/g<j>/+``."""
    from mqtt_tpu_torch import DeltaMatcher, RecryptEngine, Subscription, TenantPlane, TopicsIndex
    from mqtt_tpu_torch.topics import ns_scope_filter

    t0 = time.perf_counter()
    plane = TenantPlane(registry)
    reg = plane.keys
    tenants = []
    keys = {}
    index = TopicsIndex()
    for t in range(N_TENANTS):
        tenant = plane.register(f"bt{t}", encrypted=("e/",))
        tenants.append(tenant)
        for k in range(KEYS_PER_TENANT):
            keys[(tenant.name, f"c{k}")] = bytes([t, k % 256]) * 8
            reg.set_key(tenant.name, f"c{k}", keys[(tenant.name, f"c{k}")])
        for g in range(4):
            flt = ns_scope_filter(tenant.name, f"e/g{g}/+")
            for i in range(RECRYPT_FANOUT):
                index.subscribe(f"{tenant.name}:g{g}:c{i}", Subscription(filter=flt, qos=1))
    rec = RecryptEngine(reg, oracle_sample=16, device=device, registry=registry)
    rec.reseed_nonce(b"bnch")
    dm = DeltaMatcher(index, max_levels=8, rebuild_interval=0.5, device=device)
    log(f"phase setup cfgR: ok {N_TENANTS} tenants x {KEYS_PER_TENANT} keys, "
        f"{N_TENANTS * 4 * RECRYPT_FANOUT} subscriptions, {time.perf_counter() - t0:.1f} s")
    return {"name": "cfgR", "index": index, "dm": dm, "rec": rec, "tenants": tenants, "keys": keys,
            "plane": plane, "rng": random.Random(seed)}


def _verify_sealed(torch, rec, chunk, device):
    """Open every sealed payload of ``chunk`` (``(tenant, plaintext,
    {cid: wire})`` per publish) under its subscriber's key through the
    plain PyTorch AES on ``device``; returns the payloads checked."""
    import numpy as np
    from mqtt_tpu_torch.ops import recrypt as rops

    table = rec.keys.table()
    kidx, counters, cts, pts = [], [], [], []
    for tenant, plain, sealed in chunk:
        size = len(plain)
        nb = (size + 15) // 16
        for cid, wire in sealed.items():
            kid = rec.keys.key_id(tenant.name, cid.rsplit(":", 1)[1])
            kidx.append(np.full(nb, kid, np.int32))
            counters.append(rops.ctr_counters(wire[:12], nb))
            cts.append(np.frombuffer(wire[12:], np.uint8))
            pts.append(np.frombuffer(plain, np.uint8))
    if not kidx:
        return 0
    ks = rops.keystream_plain(
        torch.from_numpy(table).to(device), torch.from_numpy(np.concatenate(kidx)).to(device),
        torch.from_numpy(np.concatenate(counters)).to(device),
    ).cpu().numpy().reshape(len(cts), -1)
    got = np.stack(cts) ^ ks[:, : cts[0].shape[0]]
    check(np.array_equal(got, np.stack(pts)), "cfgR: a sealed payload does not open under its subscriber's key")
    return len(cts)


def phase_recrypt(torch, cfg: dict, n_pub: int) -> dict:
    """cfgR's main path (launch counts reset just before): per payload
    size, ``n_pub`` encrypted publishes through ``MatchStage`` with the
    re-encryption engine attached (K6 on the decrypt leg), then
    ``open_publish`` and ``seal_fanout`` to the 100 subscribers (K6 per
    publish)."""
    import numpy as np
    from mqtt_tpu_torch import MatchStage
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.topics import ns_scope_topic

    index, dm, rec, tenants, keys, rng = (cfg[k] for k in ("index", "dm", "rec", "tenants", "keys", "rng"))
    on_cuda = dm.snapshot.device.type == "cuda"
    g0 = dict(rec.gauges())
    kernels.reset_launches()
    for size in RECRYPT_SIZES:
        plains = np.random.default_rng(size).integers(0, 256, (n_pub, size), dtype=np.uint8)
        pubs = []
        for i in range(n_pub):
            tenant = tenants[i % N_TENANTS]
            plain = plains[i].tobytes()
            wire = rec.seal_with_key(keys[(tenant.name, "c0")], plain)
            topic = ns_scope_topic(tenant.name, f"e/g{rng.randrange(4)}/d{rng.randrange(16)}")
            pubs.append((tenant, topic, plain, wire, rec.decrypt_job(tenant, ("c0",), wire)))
        stage_s = {}

        async def drive():
            stage = MatchStage(dm, index.subscribers, max_batch=MAIN_BATCH, latency_budget_s=None,
                               max_pending=1 << 20, recrypt=rec)
            stage.start()
            try:
                t0 = time.perf_counter()
                res = await asyncio.gather(*(stage.submit(tp, rjob=job) for _t, tp, _p, _w, job in pubs))
                stage_s["s"] = time.perf_counter() - t0
                return res
            finally:
                await stage.stop()

        results = asyncio.run(drive())
        check(all(job.keystream is not None for *_x, job in pubs) or not on_cuda,
              f"cfgR {size} B: a decrypt job came back without its keystream")
        open_s = seal_s = 0.0
        deliveries = 0
        checked = 0
        chunk = []
        for k, ((tenant, _tp, plain, wire, job), subs) in enumerate(zip(pubs, results)):
            t0 = time.perf_counter()
            opened = rec.open_publish(tenant, ("c0",), wire, job)
            t1 = time.perf_counter()
            targets = [(cid, (cid.rsplit(":", 1)[1],)) for cid in subs.subscriptions]
            sealed = rec.seal_fanout(tenant, opened, targets)
            open_s += t1 - t0
            seal_s += time.perf_counter() - t1
            check(opened == plain, f"cfgR {size} B: publish {k} decrypted to other bytes")
            check(len(sealed) == RECRYPT_FANOUT, f"cfgR {size} B: {len(sealed)} sealed for {len(targets)} targets")
            deliveries += len(sealed)
            cid = sorted(sealed)[k % len(sealed)]
            check(rec.open_with_key(keys[(tenant.name, cid.rsplit(":", 1)[1])], sealed[cid]) == plain,
                  f"cfgR {size} B: open_with_key failed for {cid}")
            chunk.append((tenant, plain, sealed))
            if len(chunk) == 32:
                checked += _verify_sealed(torch, rec, chunk, dm.snapshot.device)
                chunk = []
        checked += _verify_sealed(torch, rec, chunk, dm.snapshot.device)
        check(checked == deliveries, f"cfgR {size} B: checked {checked} of {deliveries}")
        log(f"phase recrypt cfgR {size} B: ok {n_pub} publishes decrypted to their plaintext and "
            f"{deliveries} sealed payloads open under their subscribers' keys; stage {n_pub / stage_s['s']:.1f} "
            f"publishes/s (wall {stage_s['s']:.3f} s), fan-out {deliveries / (open_s + seal_s):.1f} deliveries/s "
            f"(open_publish wall {open_s:.3f} s, seal_fanout wall {seal_s:.3f} s: "
            f"{seal_s / n_pub * 1e3:.3f} ms per publish)")
    launches = dict(kernels.LAUNCHES)
    g = rec.gauges()
    delta = {k: g[k] - g0[k] for k in ("device_batches", "device_blocks", "host_blocks", "oracle_checks",
                                        "oracle_mismatches", "fanouts", "no_key_drops")}
    check(delta["oracle_mismatches"] == 0, f"cfgR: {delta['oracle_mismatches']} oracle mismatches")
    if on_cuda:
        check(launches["keystream"] > 0, f"cfgR's main path did not launch K6: {launches}")
    log(f"  cfgR keystream: device batches {delta['device_batches']}, device blocks {delta['device_blocks']}, "
        f"host blocks {delta['host_blocks']} by reason {g['host_reasons']}, fanouts {delta['fanouts']}, "
        f"keyless {delta['no_key_drops']}, oracle checks {delta['oracle_checks']} mismatches "
        f"{delta['oracle_mismatches']}")
    log(f"  cfgR launches on the main path: {launches}")
    return launches


def rules_ops(B: int, R: int, S: int, n_bit: int) -> int:
    """Operations the function needs for K4's B*R verdicts, ``n_bit`` of
    the R rules bit-op rules. At S = 1 a word's 32 numeric verdicts for a
    feature depend only on where it falls among the word's sorted
    thresholds: per publish and word a six-step search, one table read
    and one store (8), and once per word a sort of its thresholds (32 x 5
    compares) and its 66 region words. At S > 1 one compare per verdict
    (an unordered float compare folds in the NaN pass), and per 32 one
    ballot and one store. A bit-op verdict takes a shift and a mask."""
    words = R // 32
    if S == 1:
        return B * words * 8 + words * (32 * 5 + 66) + 2 * B * n_bit
    return B * R + 2 * B * words


def keystream_ops(N: int) -> int:
    """Operations of K6: per block, 10 rounds x 16 bytes x 4 (byte
    extract, table lookup, XOR into the column, round-key XOR)."""
    return N * 10 * 16 * 4


def _keystream_split(torch, key_table, kidx, counters, lanes: int):
    """K6 with ``lanes`` threads per AES block (the wrapper picks by N),
    launched through the library itself so the launch is not counted."""
    import ctypes

    from mqtt_tpu_torch.ops import kernels

    N = kidx.shape[0]
    out = torch.empty((N, 16), dtype=torch.uint8, device=counters.device)
    err = kernels.library("recrypt.cu").rc_keystream(
        key_table.data_ptr(), key_table.shape[0], kidx.data_ptr(), counters.data_ptr(), N, out.data_ptr(),
        lanes, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    check(err == 0, f"keystream with {lanes} lanes per block failed to launch ({err})")
    return out


def phase_kernels_pr(torch, rec: dict, cfgP: dict, cfgR: dict, device, n_recrypt: int, iters: int = 20) -> None:
    """K4-K6 against their plain versions on the same inputs on the card,
    at the shapes cfgP and cfgR give them; fills ``rec``."""
    import numpy as np
    from mqtt_tpu_torch.ops import predicates as pops
    from mqtt_tpu_torch.ops import recrypt as rops
    from mqtt_tpu_torch.ops.flat import _bucket

    on_cuda = device.type == "cuda"

    def measure(fn, n):
        return event_ms(torch, fn, n) if on_cuda else _host_ms(fn, n)

    def timed(name, what, kernel, plain, n_bytes, n_ops, err, main, plain_iters=2):
        bound_ms, bound_by = bound(n_bytes, n_ops)
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "ms": measure(kernel, iters), "plain_ms": measure(plain, plain_iters)}
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        log(f"  {name} {what}{' (the main shape)' if main else ''}: err {err}, {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B, {n_ops} ops)")
        if main:
            rec[name].update(row)

    # K4: the engine's own rule table; feature rows of cfgP payloads (the
    # main shape) and the first 64 of them, both also on the same table
    # with its bit-op rules moved to its front (the order of a rule set
    # that adds its $CONTAINS/$EQS rules together); random S = 2 rows with
    # NaNs, 4096 and 64 of them
    eng = cfgP["eng"]
    with eng._lock:
        if eng._table_gen != eng._gen:
            eng._rebuild_evaluator()
    table = eng._evaluator.table.arrays
    R = table[0].shape[0]
    is_bit = (table[0] == pops.OP_CONTAINS) | (table[0] == pops.OP_EQS)
    n_bit = int(is_bit.sum())
    crowded = [a[torch.argsort(~is_bit, stable=True)].contiguous() for a in table]
    prng = random.Random(7)
    feats = [eng.features_for(cfgP_payload(prng)) for _ in range(MAIN_BATCH)]
    F = np.stack([f.fvec for f in feats]).astype(np.float32)
    M = np.stack([f.cmask for f in feats]).view(np.int32)
    g = np.random.default_rng(8)
    F2 = g.random((MAIN_BATCH, 2), dtype=np.float32)
    F2[g.random(F2.shape) < 0.1] = np.nan
    M2 = g.integers(0, 2**32, (MAIN_BATCH, 64), dtype=np.uint64).astype(np.uint32).view(np.int32)
    cases = [("", table, F, M, True), ("", table, F[:64], M[:64], False),
             (" bit-op rules first", crowded, F, M, False), (" bit-op rules first", crowded, F[:64], M[:64], False),
             ("", table, F2, M2, False), ("", table, F2[:64], M2[:64], False)]
    for what, rules, f_np, m_np, main in cases:
        f_t = torch.from_numpy(np.ascontiguousarray(f_np)).to(device)
        m_t = torch.from_numpy(np.ascontiguousarray(m_np)).to(device)
        got = pops.rules_eval(*rules, f_t, m_t)
        want = pops.rules_eval_plain(*rules, f_t, m_t)
        check(got.shape == want.shape and got.dtype == want.dtype, "rules_eval: shape/dtype differ")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        (B, S), W = f_t.shape, m_t.shape[1]
        check(err == 0, f"rules_eval B={B} S={S}{what}: kernel disagrees with its plain version (max abs err {err})")
        del want
        timed("rules_eval", f"B={B} R={R} S={S} W={W}{what}",
              lambda: pops.rules_eval(*rules, f_t, m_t),
              lambda: pops.rules_eval_plain(*rules, f_t, m_t),
              R * 16 + B * (S + W) * 4 + B * R // 8, rules_ops(B, R, S, n_bit), err, main)
    if on_cuda:
        torch.cuda.empty_cache()

    # K5: the hot topic's tick, 64 windows of up to 64 samples
    W, N = 64, 64
    vals = g.random((W, N), dtype=np.float32)
    counts = np.where(np.arange(W) % 3 == 2, 64, 32).astype(np.int32)
    vals[np.arange(N)[None, :] >= counts[:, None]] = np.nan
    ops = np.array([(pops.OP_MEAN, pops.OP_MAX, pops.OP_MIN)[k % 3] for k in range(W)], np.int32)
    args = [torch.from_numpy(a).to(device) for a in (vals, ops, counts)]
    got = pops.agg_reduce(*args).cpu().numpy()
    want = pops.agg_reduce_plain(*args).cpu().numpy()
    exact = ops != pops.OP_MEAN
    check(np.array_equal(got[exact].view(np.uint32), want[exact].view(np.uint32)),
          "agg_reduce: MAX/MIN differ from the plain version")
    check((np.abs(got - want) <= MEAN_TOL * np.maximum(1.0, np.abs(want))).all(),
          "agg_reduce: MEAN outside its tolerance")
    timed("agg_reduce", f"W={W} N={N}", lambda: pops.agg_reduce(*args), lambda: pops.agg_reduce_plain(*args),
          W * N * 4 + W * 12, 4 * W * N, float(np.abs(got - want).max()), True, plain_iters=iters)

    # K6: cfgR's key table at every shape the path launches, padded as
    # keystream_async pads them (key 0, zero counters): the decrypt leg's
    # batches of 4096-B and 256-B payloads, and one seal_fanout of 100 per
    # publish of each size. The row kept for the kernels line is the 4096-B
    # fan-out: it takes half the path's launches and most of its blocks.
    key_table = torch.from_numpy(cfgR["rec"].keys.table()).to(device)
    T = key_table.shape[0]
    shapes = (("decrypt 4096-B", n_recrypt * 256, 256, False), ("decrypt 256-B", n_recrypt * 16, 16, False),
              ("fan-out 256-B", RECRYPT_FANOUT * 16, 16, False), ("fan-out 4096-B", RECRYPT_FANOUT * 256, 256, True))
    for what, n_live, per_payload, main in shapes:
        N = _bucket(n_live, minimum=16)
        k_np = np.zeros(N, np.int32)
        c_np = np.zeros((N, 16), np.uint8)
        k_np[:n_live] = g.integers(0, T, n_live)
        c_np[:n_live] = g.integers(0, 256, (n_live, 16), dtype=np.uint8)
        kidx = torch.from_numpy(k_np).to(device)
        ctrs = torch.from_numpy(c_np).to(device)
        got = rops.keystream(key_table, kidx, ctrs)
        want = rops.keystream_plain(key_table, kidx, ctrs)
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        check(err == 0, f"keystream N={N}: kernel disagrees with its plain version (max abs err {err})")
        timed("keystream", f"{what} N={N} ({n_live} live) T={T}", lambda: rops.keystream(key_table, kidx, ctrs),
              lambda: rops.keystream_plain(key_table, kidx, ctrs),
              N * 36 + T * 176, keystream_ops(N), err, main)
        if on_cuda:
            split_ms = {}
            for lanes in (1, 4):
                check(torch.equal(_keystream_split(torch, key_table, kidx, ctrs, lanes), want),
                      f"keystream N={N} lanes={lanes}: disagrees with its plain version")
                split_ms[lanes] = measure(lambda: _keystream_split(torch, key_table, kidx, ctrs, lanes), iters)
            # the path's own key layout: one key per payload, not per block
            runs = np.zeros(N, np.int32)
            runs[:n_live] = np.repeat(g.integers(0, T, -(-n_live // per_payload)), per_payload)[:n_live]
            k_runs = torch.from_numpy(runs).to(device)
            check(torch.equal(rops.keystream(key_table, k_runs, ctrs), rops.keystream_plain(key_table, k_runs, ctrs)),
                  f"keystream N={N} (a key per payload): disagrees with its plain version")
            runs_ms = measure(lambda: rops.keystream(key_table, k_runs, ctrs), iters)
            log(f"    keystream N={N}: one lane per AES block {split_ms[1]:.4f} ms, four lanes "
                f"{split_ms[4]:.4f} ms (both equal to plain); with one key per {per_payload}-block payload, as "
                f"the path keys it, {runs_ms:.4f} ms; shared-memory lookup ceiling "
                f"{N * 160 / SMEM_LOOKUPS_PER_S * 1e3:.4f} ms ({N * 160} lookups)")
    log("phase kernels K4-K6: ok every kernel equals its plain version (K5's MEAN within "
        f"{MEAN_TOL} x max(1, |want|), the rest tolerance 0)")



# -- retained delivery (bench.py config 11, leg 2) and the re-key re-seal -----


def cfg11_topic(i: int) -> str:
    """bench.py:1352-1356's retained topic ``i`` (unique for every i)."""
    return f"region{i % 40}/device{(i // 40) % 50}/metric{i // 2000}"


def cfg11_filters() -> list:
    """bench.py:1361-1371: config 11's 64 wildcard filters, four shapes."""
    return [
        [f"region{k % 40}/device{k % 50}/+", f"region{k % 40}/+/metric{k % 25}", f"region{k % 40}/#",
         f"+/device{k % 50}/metric{k % 25}"][k % 4]
        for k in range(64)
    ]


def _retained_packet(topic: str, payload: bytes, origin: str = ""):
    from mqtt_tpu_torch import PUBLISH, FixedHeader, Packet

    return Packet(fixed_header=FixedHeader(type=PUBLISH, retain=True), topic_name=topic, payload=payload,
                  origin=origin)


def subscribe_retained(eng, index, flt: str) -> list:
    """A SUBSCRIBE's retained delivery, as the broker runs it
    (mqtt_tpu/server.py:4364-4374): the engine's names, each looked up in
    the retained store; the trie walk when the engine declines."""
    names = eng.match(flt)
    if names is None:
        return index.messages(flt)
    return [m for m in (index.retained.get(n) for n in names) if m is not None]


def retain(eng, index, pk) -> int:
    """A retained PUBLISH or clear, then the engine's note of it
    (mqtt_tpu/server.py:3026-3027)."""
    r = index.retain_message(pk)
    eng.note_retained(pk.topic_name, r == 1)
    return r


def phase_setup_retained(n: int, device) -> dict:
    """Config 11's retained corpus of ``n`` topics (payload ``b"r"``), with
    4 tenant namespaces x 2,000 scoped topics, 64 ``$SYS/...`` and 64
    ``$other/...`` topics and a namespace ``deep`` holding one topic deeper
    than ``max_levels``; the engine reseeded from the store, then every
    namespace's corpus tokenized and copied to the card."""
    from mqtt_tpu_torch import RetainedMatchEngine, TopicsIndex
    from mqtt_tpu_torch.topics import ns_scope_topic

    gc.disable()
    try:
        t0 = time.perf_counter()
        topics = [cfg11_topic(i) for i in range(n)]
        topics += [ns_scope_topic(f"rt{t}", cfg11_topic(i)) for t in range(RET_TENANTS) for i in range(RET_PER_TENANT)]
        topics += [f"$SYS/broker/load{i}" for i in range(64)] + [f"$other/load/n{i}" for i in range(64)]
        topics += [ns_scope_topic("deep", "/".join(f"l{i}" for i in range(10))),
                   ns_scope_topic("deep", cfg11_topic(1))]
        index = TopicsIndex()
        check(index.retain_bulk([_retained_packet(t, b"r") for t in topics]) == len(topics),
              "the retained corpus holds a repeated topic")
        t1 = time.perf_counter()
        eng = RetainedMatchEngine(index, max_levels=8, oracle_sample=0, device=device)
        size = eng.reseed()
        t2 = time.perf_counter()
        for ns in eng._corpora:  # what each namespace's first match does
            with eng._lock:
                eng._ensure_tokens(eng._corpora[ns])
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        _settle_gc()
    caps = {ns or "global": int(c.packed.shape[0]) for ns, c in eng._corpora.items()}
    log(f"phase setup retained {n}: ok {size} retained topics in {len(caps)} namespaces, trie {t1 - t0:.1f} s, "
        f"reseed {t2 - t1:.2f} s, first tokenize + copy to the device {t3 - t2:.2f} s "
        f"({(t3 - t2) / size * 1e6:.3f} us a topic), capacities {caps}")
    return {"n": n, "index": index, "eng": eng, "rng": random.Random(n)}


def _retained_extra_filters() -> tuple:
    """Beside config 11's filters: global and scoped ``+``/``#`` filters
    that reach the namespaces, ``$SYS`` and ``$other``; and the two that
    take the ``depth`` class (an over-deep filter, and a filter on the
    namespace holding an over-deep topic)."""
    from mqtt_tpu_torch.topics import ns_scope_filter

    extra = ["#", "+/+/+", "$SYS/#", "$SYS/+", "+/load/+", "$other/#", "region3/device3/metric1/#"]
    for t in range(RET_TENANTS):
        extra += [ns_scope_filter(f"rt{t}", f) for f in ("#", f"region{t}/#", "+/device7/+", "$SYS/#")]
    extra += [ns_scope_filter("churn", "#"), ns_scope_filter("churn", "+/device3/+")]
    return extra, ["/".join(["+"] * 9), ns_scope_filter("deep", "#")]


def _retained_round(eng, index, bench: list, extra: list, deep: list) -> dict:
    """One round: config 11's filters through the engine, then through the
    walk (each timed as a whole), every answer equal to the walk as sorted
    lists and delivered from the store; then the other filters, checked
    the same way (the ``depth`` ones must decline)."""
    t0 = time.perf_counter()
    got = [eng.match(f) for f in bench]
    t1 = time.perf_counter()
    want = [index.messages(f) for f in bench]
    t2 = time.perf_counter()
    hits = 0
    for f, g, w in zip(bench, got, want):
        check(g is not None, f"retained: the engine declined {f!r}")
        names = sorted(p.topic_name for p in w)
        check(sorted(g) == names, f"retained: {f!r} differs from the walk")
        check(all(index.retained.get(x).payload == b"r" for x in g), f"retained: {f!r} names a topic the store lacks")
        hits += len(g)
    for f in extra + deep:
        delivered = sorted(p.topic_name for p in subscribe_retained(eng, index, f))
        check(delivered == sorted(p.topic_name for p in index.messages(f)), f"retained: {f!r} differs from the walk")
    check(all(eng.match(f) is None for f in deep), "retained: an over-deep filter was not declined")
    return {"dev_s": t1 - t0, "host_s": t2 - t1, "hits": hits}


def _scan_split(torch, eng, filters: list) -> dict:
    """Each filter's scan step by step (``_corpus``, ``_launch``,
    ``_fetch``, ``_select``), the card synchronised between steps: mean
    ms a scan for each, K1 by CUDA events. Then the cost of fresh rows:
    4,096 global names tokenized, and their rows copied to the card, in
    us a row."""
    on_cuda = eng.device.type == "cuda"
    t = {"corpus": 0.0, "k1": 0.0, "launch+sync": 0.0, "d2h": 0.0, "select": 0.0}
    for f in filters:
        local = f  # config 11's filters are global
        a = time.perf_counter()
        names, n, packed, lengths = eng._corpus("")
        b = time.perf_counter()
        fidx, arrays = eng._filter_index(local)
        if on_cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            b = time.perf_counter()
            e0.record()
        out = eng._launch(arrays, packed)
        if on_cuda:
            e1.record()
            torch.cuda.synchronize()
            t["k1"] += e0.elapsed_time(e1) / 1e3
        c = time.perf_counter()
        res = eng._fetch(out, n, fidx.num_patterns)
        d = time.perf_counter()
        eng._select(res, names, lengths, local)
        e = time.perf_counter()
        t["corpus"] += b - a
        t["launch+sync"] += c - b
        t["d2h"] += d - c
        t["select"] += e - d
    split = {k: v / len(filters) * 1e3 for k, v in t.items()}
    c = eng._corpora[""]
    fresh = c.names[:4096]
    a = time.perf_counter()
    rows, _over = eng._tokenize(fresh)
    b = time.perf_counter()
    scratch = torch.empty(rows.shape, dtype=torch.int32, device=eng.device)
    if on_cuda:
        torch.cuda.synchronize()
    b2 = time.perf_counter()
    scratch.copy_(torch.from_numpy(rows))
    if on_cuda:
        torch.cuda.synchronize()
    e = time.perf_counter()
    split["tokenize_us_a_row"] = (b - a) / len(fresh) * 1e6
    split["h2d_us_a_row"] = (e - b2) / len(fresh) * 1e6
    return split


def phase_retained(torch, rec: dict, st: dict, device, iters: int = 20) -> dict:
    """The retained-delivery path at one corpus size (launch counts reset
    just before): three rounds of config 11's 64 filters and the others,
    with 300 retains (a new namespace) and 300 clears (a third of them in
    that namespace, past ``rebuild_ratio``, so its corpus compacts)
    between the first two; a fourth round of the engine under the
    profiler. Then the per-scan split, and K1 held against its plain
    version with one filter over the global corpus's capacity."""
    from mqtt_tpu_torch.ops import flat, kernels
    from mqtt_tpu_torch.topics import ns_scope_topic

    eng, index, rng, n = st["eng"], st["index"], st["rng"], st["n"]
    on_cuda = device.type == "cuda"
    bench = cfg11_filters()
    extra, deep = _retained_extra_filters()
    f0, m0 = dict(eng.fallbacks), eng.device_matches
    rounds = []
    kernels.reset_launches()
    rounds.append(_retained_round(eng, index, bench, extra, deep))
    churn = [ns_scope_topic("churn", cfg11_topic(i)) for i in range(RET_CHURN)]
    for topic in churn:
        check(retain(eng, index, _retained_packet(topic, b"r")) == 1, "retained: a churn retain was not new")
    cleared = churn[: RET_CHURN // 3] + [cfg11_topic(i) for i in rng.sample(range(n), RET_CHURN - RET_CHURN // 3)]
    for topic in cleared:
        check(retain(eng, index, _retained_packet(topic, b"")) == -1, "retained: a clear found nothing")
    check(len(eng._corpora["churn"].names) < RET_CHURN, "retained: the churn namespace did not compact")
    for _ in range(2):
        rounds.append(_retained_round(eng, index, bench, extra, deep))
    traced = {"busy_us": None}
    if on_cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in bench:
                eng.match(f)
            traced["wall_s"] = time.perf_counter() - t0
        traced["busy_us"], traced["copy_us"] = _device_busy(prof)
    launches = dict(kernels.LAUNCHES)
    check(launches["flat_probe_ranges"] > 0 or not on_cuda, "retained: K1 was never launched")
    fallbacks = {k: eng.fallbacks[k] - f0[k] for k in eng.fallbacks}
    check(fallbacks["depth"] > 0 and fallbacks["filter"] == 0 and fallbacks["overflow"] == 0,
          f"retained: fallbacks {fallbacks}")
    scans = sum(len(bench) for _ in rounds)
    dev_s = sum(r["dev_s"] for r in rounds)
    host_s = sum(r["host_s"] for r in rounds)
    per_round = (", ".join(f"{r['dev_s']:.4f}" for r in rounds), ", ".join(f"{r['host_s']:.4f}" for r in rounds))
    log(f"phase retained {n}: ok {len(rounds)} rounds of {len(bench)} config-11 filters and "
        f"{len(extra) + len(deep)} others, every answer equal to the walk, {RET_CHURN} retains and "
        f"{RET_CHURN} clears after round 1 (the churn namespace compacted to "
        f"{len(eng._corpora['churn'].names)} rows); retained_device_scans_per_sec {scans / dev_s:.1f}, "
        f"retained_host_scans_per_sec {scans / host_s:.1f} (rounds: engine {per_round[0]} s, walk "
        f"{per_round[1]} s; {rounds[0]['hits']} hits a round), device matches {eng.device_matches - m0}, fallbacks {fallbacks}, "
        f"K1 launches {launches['flat_probe_ranges']}")
    if traced["busy_us"] is None:
        log(f"  retained {n} traced round: idle share not measured (no device span in the trace)")
    else:
        log(f"  retained {n} traced round: {len(bench)} scans in {traced['wall_s']:.4f} s under the profiler, "
            f"device busy {traced['busy_us']:.1f} us (copies {traced['copy_us']:.1f} us), "
            f"idle share {1 - traced['busy_us'] / (traced['wall_s'] * 1e6):.6f}")
    split = _scan_split(torch, eng, bench)
    log(f"  retained {n} per-scan split (ms a scan, mean of {len(bench)}): corpus check {split['corpus']:.4f}, "
        f"K1 {split['k1']:.4f} (launch to sync {split['launch+sync']:.4f}), D2H {split['d2h']:.4f}, host filter "
        f"{split['select']:.4f}; fresh rows: tokenize {split['tokenize_us_a_row']:.3f} us a row, H2D "
        f"{split['h2d_us_a_row']:.3f} us a row")

    # K1 with one filter over the global corpus, every config-11 shape, tolerance 0
    compare = _comparer(torch, rec)
    names, B_live, packed, _lengths = eng._corpus("")
    B, L = packed.shape[0], eng.max_levels
    measure = (lambda fn, k: event_ms(torch, fn, k)) if on_cuda else _host_ms
    for f in bench[:4]:
        fidx, arrays = eng._filter_index(f)
        got = flat.flat_match_packed(*arrays, packed, max_levels=L)
        want = flat.flat_match_packed_plain(*arrays, packed, L)
        compare("flat_probe_ranges", got, want, f"retained {n} B={B} {f!r}")
    f = bench[2]  # region{k}/#: the shape with the most hits
    fidx, arrays = eng._filter_index(f)
    # the build pads one pattern to its minimum of two (the pad never
    # probes): K1 writes [B, 2P+2] with P = 2 and probes one pattern a topic
    P = fidx.num_patterns
    rows = int(torch.unique(flat.probe_slots(*arrays, packed, max_levels=L)).numel())
    n_bytes = B * (2 * L + 2) * 4 + rows * 64 + 3 * P * 4 + B * (2 * P + 2) * 4
    bound_ms, bound_by = bound(n_bytes, probe_ops(B, 1, L))
    ms = measure(lambda: flat.flat_match_packed(*arrays, packed, max_levels=L), iters)
    plain_ms = measure(lambda: flat.flat_match_packed_plain(*arrays, packed, L), 3)
    log(f"phase retained {n} K1: ok flat_probe_ranges one filter (P={P}, one pad) B={B} ({B_live} live rows), "
        f"the four config-11 "
        f"shapes equal to the plain version (tolerance 0); {f!r}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B, {probe_ops(B, 1, L)} int32 ops)")
    return launches


def _open_resealed(torch, keys, tenant: str, resealed: list, plains: dict, device) -> int:
    """Open every re-sealed payload ``(topic, ident, wire)`` under its
    identity's current key through the plain PyTorch AES on ``device``, in
    chunks of one payload size; returns how many opened to their
    plaintext."""
    import numpy as np
    from mqtt_tpu_torch.ops import recrypt as rops

    table = torch.from_numpy(keys.table()).to(device)
    by_size: dict = {}
    for x in resealed:
        by_size.setdefault(len(x[2]), []).append(x)
    chunks = [g[k : k + 512] for g in by_size.values() for k in range(0, len(g), 512)]
    ok = 0
    for chunk in chunks:
        nb = (len(chunk[0][2]) - 12 + 15) // 16
        kidx = np.repeat(np.array([keys.key_id(tenant, ident) for _t, ident, _w in chunk], np.int32), nb)
        ctrs = np.concatenate([rops.ctr_counters(w[:12], nb) for _t, _i, w in chunk])
        ks = rops.keystream_plain(table, torch.from_numpy(kidx).to(device), torch.from_numpy(ctrs).to(device))
        ks = ks.cpu().numpy().reshape(len(chunk), -1)
        ct = np.stack([np.frombuffer(w[12:], np.uint8) for _t, _i, w in chunk])
        pt = np.stack([np.frombuffer(plains[t], np.uint8) for t, _i, _w in chunk])
        check(np.array_equal(ct ^ ks[:, : ct.shape[1]], pt), "reseal: a payload does not open under the new key")
        ok += len(chunk)
    return ok


def phase_reseal(torch, rec: dict, cfg: dict, device, n: int = N_RESEAL, iters: int = 20) -> dict:
    """A live re-key of one cfgR tenant with a retained store (launch
    counts reset just before the re-key): ``n`` encrypted payloads of 256
    B and ``n`` of 4096 B retained under the tenant's encrypted prefix,
    each sealed under its origin's key; the engine answers the tenant's
    filters. Then, as the broker re-keys (mqtt_tpu/server.py:4463-4556):
    stage the epoch, collect the tenant's encrypted retained payloads,
    ``reseal_batch`` them (one call, and one K6 launch, per size), retain
    the new payloads, activate, ``note_rekey``. Every new payload carries
    the epoch's tag and opens under the new key; the engine's answers are
    unchanged. Then K6 held against its plain version at that block count."""
    import numpy as np
    from mqtt_tpu_torch import RetainedMatchEngine
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.ops import recrypt as rops
    from mqtt_tpu_torch.tenancy import EPOCH_NONCE_MAGIC, local_client_id, nonce_epoch, scope_client_id
    from mqtt_tpu_torch.topics import NS_CHAR, ns_local, ns_scope_filter, ns_scope_topic

    plane, renc, index, keys = cfg["plane"], cfg["rec"], cfg["index"], cfg["keys"]
    tenant = cfg["tenants"][0]
    name = tenant.name
    on_cuda = device.type == "cuda"
    eng = RetainedMatchEngine(index, device=device)
    plains = {}
    rng = np.random.default_rng(20)
    t0 = time.perf_counter()
    for size in RECRYPT_SIZES:
        data = rng.integers(0, 256, (n, size), dtype=np.uint8)
        for i in range(n):
            ident = f"c{i % KEYS_PER_TENANT}"
            topic = ns_scope_topic(name, f"e/r{size}/d{i}")
            plains[topic] = data[i].tobytes()
            wire = renc.seal_with_key(keys[(name, ident)], plains[topic])
            retain(eng, index, _retained_packet(topic, wire, scope_client_id(name, ident)))
    retain(eng, index, _retained_packet(ns_scope_topic(name, "pub/status"), b"clear text"))
    filters = [ns_scope_filter(name, f) for f in ("e/#", "e/r256/+", "e/r4096/+", "e/+/d7", "+/+/+", "#")]

    def answers() -> dict:
        out = {}
        for f in filters:
            got = sorted(p.topic_name for p in subscribe_retained(eng, index, f))
            check(got == sorted(p.topic_name for p in index.messages(f)), f"reseal: {f!r} differs from the walk")
            out[f] = got
        return out

    before = answers()
    t1 = time.perf_counter()
    new_keys = {f"c{k}": bytes([0xE0 + k % 16, k]) * 8 for k in range(KEYS_PER_TENANT)}
    g0 = dict(renc.gauges())
    kernels.reset_launches()
    t2 = time.perf_counter()
    reg = plane.keys
    epoch = reg.stage_epoch(name, new_keys)
    prefix = NS_CHAR + name + "/"
    victims: dict = {}
    for topic, pkv in index.retained.get_all().items():
        if not topic.startswith(prefix) or not pkv.payload:
            continue
        local = ns_local(topic)
        if local.startswith("$SYS") or not tenant.is_encrypted(local):
            continue
        ident = local_client_id(pkv.origin)
        item = (bytes(pkv.payload), reg.key_id(name, ident), reg.kid_for_epoch(name, ident, epoch))
        victims.setdefault(len(pkv.payload), []).append((topic, pkv, ident, item))
    check(sorted(victims) == [12 + s for s in RECRYPT_SIZES], f"reseal: payload sizes {sorted(victims)}")
    resealed = []
    calls = []
    for size in sorted(victims):
        group = victims[size]
        l0 = kernels.LAUNCHES["keystream"]
        a = time.perf_counter()
        outs = renc.reseal_batch(tenant, [item for *_x, item in group], epoch)
        b = time.perf_counter()
        check(not on_cuda or kernels.LAUNCHES["keystream"] == l0 + 1,
              f"reseal {size - 12} B: {kernels.LAUNCHES['keystream'] - l0} K6 launches for one call")
        for (topic, pkv, ident, _item), data in zip(group, outs):
            check(data is not None, f"reseal: {topic!r} was not re-sealed")
            out = pkv.copy(False)
            out.payload = data
            out.fixed_header.retain = True
            check(retain(eng, index, out) == 1, "reseal: a re-sealed payload was not retained")
            resealed.append((topic, ident, data))
        calls.append((size - 12, len(group), 2 * len(group) * ((size - 12 + 15) // 16), b - a,
                      time.perf_counter() - b))
    reg.activate_epoch(name)
    renc.note_rekey(name)
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    g = renc.gauges()
    check(reg.current_epoch(name) == epoch and g["rekeys"] - g0["rekeys"] == 1, "reseal: the epoch did not activate")
    check(all(w[0] == EPOCH_NONCE_MAGIC and nonce_epoch(w[:12]) == epoch for _t, _i, w in resealed),
          "reseal: a payload lacks the epoch's tag")
    opened = _open_resealed(torch, reg, name, resealed, plains, device)
    check(opened == len(plains) == 2 * n, f"reseal: opened {opened} of {len(plains)}")
    for size in RECRYPT_SIZES:
        topic, ident, wire = next(x for x in resealed if len(x[2]) == 12 + size)
        check(renc.open_with_key(new_keys[ident], wire) == plains[topic], "reseal: open_with_key failed")
    check(answers() == before, "reseal: the engine's answers changed across the re-key")
    log(f"phase reseal cfgR: ok tenant {name} re-keyed to epoch {epoch}: "
        + "; ".join(f"{sz} B: {k} payloads in one reseal_batch of {blk} blocks (one K6 launch), "
                    f"{dt * 1e3:.3f} ms ({dt / k * 1e6:.3f} us a payload), retain {rt * 1e3:.3f} ms"
                    for sz, k, blk, dt, rt in calls)
        + f"; whole re-key {t3 - t2:.3f} s; every payload tagged with the epoch and opened under the new key "
          f"(plain PyTorch AES on the card; one a size through open_with_key); the engine's {len(filters)} "
          f"answers unchanged; setup {t1 - t0:.1f} s; device batches {g['device_batches'] - g0['device_batches']}, "
          f"blocks {g['device_blocks'] - g0['device_blocks']}, resealed {g['resealed'] - g0['resealed']}, "
          f"oracle checks {g['oracle_checks'] - g0['oracle_checks']} mismatches "
          f"{g['oracle_mismatches'] - g0['oracle_mismatches']}")

    # K6 at the re-seal's largest block count, tolerance 0
    key_table = torch.from_numpy(reg.table()).to(device)
    T = key_table.shape[0]
    N = calls[-1][2]
    g_np = np.random.default_rng(21)
    kidx = torch.from_numpy(g_np.integers(0, T, N).astype(np.int32)).to(device)
    ctrs = torch.from_numpy(g_np.integers(0, 256, (N, 16), dtype=np.uint8)).to(device)
    got = rops.keystream(key_table, kidx, ctrs)
    want = rops.keystream_plain(key_table, kidx, ctrs)
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    rec["keystream"]["max_abs_err"] = max(rec["keystream"]["max_abs_err"], err)
    check(err == 0, f"keystream N={N}: kernel disagrees with its plain version (max abs err {err})")
    del got, want
    measure = (lambda fn, k: event_ms(torch, fn, k)) if on_cuda else _host_ms
    ms = measure(lambda: rops.keystream(key_table, kidx, ctrs), iters)
    plain_ms = measure(lambda: rops.keystream_plain(key_table, kidx, ctrs), 2)
    n_bytes = N * 36 + T * 176
    bound_ms, bound_by = bound(n_bytes, keystream_ops(N))
    log(f"phase reseal K6: ok keystream N={N} T={T} equal to its plain version (tolerance 0): {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B, {keystream_ops(N)} ops)")
    return launches


def _materialize_single(torch, cfg: dict, device) -> None:
    topics = [cfg["topic_gen"]() for _ in range(MAIN_BATCH)]
    phase_materialize(cfg["index"], topics, _fetch_single(torch, cfg, topics, device),
                      f"{cfg['name']} single-device")


def run(device, n_subs: int = N_SUBS, wave: int = WAVE, n_recrypt: int = N_RECRYPT,
        retained_sizes: tuple = RETAINED_SIZES, n_reseal: int = N_RESEAL, card: str = "") -> list:
    import torch

    # off the card (a rehearsal) the wrappers are never called: no counts
    counted = device.type == "cuda"
    phase_native()
    cfgs = [
        phase_setup("cfg2", build_cfg2, n_subs, 2, device),
        phase_setup("cfg3", build_cfg3, n_subs, 3, device),
    ]
    sharded = []
    try:
        rec = phase_kernels(torch, cfgs, device)
        main2 = phase_main(cfgs[0], wave)
        check(main2["flat_probe_ranges"] > 0 or not counted, "cfg2's main path never launched flat_probe_ranges")
        phase_kernel_small_batch(torch, rec, cfgs[0], device, "flat_probe_ranges")
        _materialize_single(torch, cfgs[0], device)
        main3 = phase_main(cfgs[1], wave)
        check(main3["flat_match_compact"] > 0 or not counted, "cfg3's main path never launched flat_match_compact")
        phase_kernel_small_batch(torch, rec, cfgs[1], device, "flat_match_compact")
        _materialize_single(torch, cfgs[1], device)
        # the same tries, now served by the sharded matcher alone
        for cfg in cfgs:
            cfg["dm"].close()
        main_sh = []
        for cfg in cfgs:
            sh = phase_setup_sharded(cfg, device)
            sharded.append(sh)
            main_sh.append(phase_sharded(sh, wave))
            phase_kernels_sharded(torch, rec, sh, device, main=cfg is cfgs[0])
            topics = [cfg["topic_gen"]() for _ in range(MAIN_BATCH)]
            phase_materialize(cfg["index"], topics, _fetch_sharded(torch, sh, topics), f"{cfg['name']} sharded")
            if cfg is cfgs[0]:
                obs = phase_observe(torch, cfg, sh, wave, device, card)
            sh["dm"].close()
    finally:
        for cfg in cfgs:
            cfg["dm"].close()
        for sh in sharded:
            sh["dm"].close()
    del cfgs, sharded
    mainN = phase_namespace(torch, device)
    # the observe phase's registry goes on to the later phases' engines
    cfgP = phase_setup_predicates(n_subs, 9, device, obs["registry"])
    cfgR = phase_setup_recrypt(10, device, obs["registry"])
    try:
        phase_kernels_pr(torch, rec, cfgP, cfgR, device, n_recrypt)
        mainP = phase_predicates(cfgP, wave)
        mainR = phase_recrypt(torch, cfgR, n_recrypt)
        cfgP["dm"].close()
        del cfgP
        main_ret = []
        for n in retained_sizes:
            st = phase_setup_retained(n, device)
            main_ret.append(phase_retained(torch, rec, st, device))
            del st
        main_rs = phase_reseal(torch, rec, cfgR, device, n_reseal)
    finally:
        if "cfgP" in locals():
            cfgP["dm"].close()
        cfgR["dm"].close()
    phase_observe_render(obs)
    kernels_line = []
    for name in REPLACES:
        launches = (main2[name] + main3[name] + mainN[name] + mainP[name] + mainR[name]
                    + sum(m[name] for m in main_sh) + sum(m[name] for m in main_ret) + main_rs[name]
                    + obs["launches"][name])
        check(launches > 0 or name in INSIDE or not counted, f"{name} was never launched on the main paths")
        r = rec[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        if name in INSIDE:
            entry["inside"] = INSIDE[name]
        kernels_line.append(entry)
    return kernels_line


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this script runs on an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import mqtt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the mqtt_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--subs", type=int, default=N_SUBS, help="subscriptions per configuration")
    ap.add_argument("--wave", type=int, default=WAVE, help="publishes per wave (three waves each)")
    ap.add_argument("--recrypt", type=int, default=N_RECRYPT, help="encrypted publishes per payload size")
    ap.add_argument("--retained", default=",".join(map(str, RETAINED_SIZES)),
                    help="retained corpus sizes, comma-separated")
    ap.add_argument("--reseal", type=int, default=N_RESEAL, help="retained payloads per size re-sealed at the re-key")
    args = ap.parse_args()
    t0 = time.perf_counter()
    try:
        card = phase_card(torch)["card"]
        phase_build()
        kernels_line = run(torch.device("cuda"), args.subs, args.wave, args.recrypt,
                           tuple(int(x) for x in args.retained.split(",")), args.reseal, card)
    except PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
