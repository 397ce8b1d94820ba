#!/usr/bin/env python3
"""Drive the PyTorch port's publish matcher on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as it ends:

1. The card (``nvidia-smi`` name and power limit) and the toolchain.
2. The kernel build: ``nvcc`` for ``sm_90a`` on every source in
   ``mqtt_tpu_torch/csrc`` (all started together), with ``-Xptxas -v``.
3. The main path's two 1M-subscription configurations (the BASELINE
   configs 2 and 3 of ``bench.py``: 3-level topics with 10% ``+``; 8-level
   topics with 5% ``#``) built as tries and compiled to device indexes.
4. Every kernel against its plain PyTorch version on the card, at the main
   path's shapes (batches of 4096 and 65536 topics on both indexes, a
   compact capacity below the batch's hits, a fold-sized row scatter), with
   tolerance 0 (all outputs are integers); each kernel's CUDA-event time,
   bound and plain time, and ``torch.index_copy``'s time beside the row
   scatter.
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
   ``TopicsIndex.subscribers`` for its topic.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
the main path, worst error, times and bound); the last line is
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
# x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
N_SUBS = 1_000_000
WAVE = 24_576  # publishes per wave; three waves per configuration
BATCHES = (4096, 65536)
MAIN_BATCH = 4096  # MatchStage's max_batch: the kernel shape the main path runs
SOURCE = "mqtt_tpu_torch/csrc/flat_match.cu"
REPLACES = {
    "flat_probe_ranges": "mqtt_tpu/ops/flat.py:1007",
    "flat_match_compact": "mqtt_tpu/ops/flat.py:1052",
    "scatter_rows": "mqtt_tpu/ops/flat.py:1191",
}


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
    kernels.library()
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {source}: {line.strip()}")
    log(f"phase build: ok {dt:.2f} s ({', '.join(kernels.SOURCES)})")
    return dt


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
        gc.freeze()
        gc.enable()
    fl = dm.snapshot.index
    table_bytes = int(dm.snapshot.device_arrays[0].numel() * 4)
    log(f"phase setup {name}: ok {n_subs} subscriptions, trie {t1 - t0:.1f} s, "
        f"index {t2 - t1:.1f} s, entries {fl.n_entries}, P {fl.num_patterns}, "
        f"S {fl.table.shape[0]}, table {table_bytes} B, sat {fl.n_sat}, spill {fl.n_spill}")
    return {"name": name, "index": index, "entries": entries, "topic_gen": topic_gen,
            "rng": rng, "dm": dm, "table_bytes": table_bytes}


def _tokens(torch, flat, topics, fl, device):
    tok1, tok2, lengths, is_dollar, _ = flat.tokenize_topics(topics, fl.max_levels, fl.salt)
    return torch.from_numpy(flat.pack_tokens(tok1, tok2, lengths, is_dollar)).to(device)


def phase_kernels(torch, cfgs: list, device, iters: int = 20) -> dict:
    """Each kernel against its plain version on the same inputs on the
    card; returns the per-kernel record at the main path's shape."""
    from mqtt_tpu_torch.ops import flat
    from mqtt_tpu_torch.ops.matcher import pick_compact_capacity

    on_cuda = device.type == "cuda"

    def measure(fn, n):
        return event_ms(torch, fn, n) if on_cuda else _host_ms(fn, n)

    rec: dict = {k: {"max_abs_err": 0} for k in REPLACES}

    def compare(name, got, want, what):
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name} {what}: shape/dtype differ")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        check(err == 0, f"{name} {what}: kernel disagrees with its plain version (max abs err {err})")

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
        lead = {"flat_probe_ranges": "cfg2", "flat_match_compact": "cfg3", "scatter_rows": "cfg2"}
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
    the device's busy and copy microseconds (the union of the kernel, copy
    and memset spans in the CUDA trace; None off the card or when the
    trace holds no device span)."""
    if not on_cuda:
        results, wall = await _wave(stage, topics)
        return results, wall, None, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results, wall = await _wave(stage, topics)
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if str(e.device_type).endswith("CUDA")
    )
    if not spans:
        return results, wall, None, None
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
    return results, wall, busy + hi - lo, copy


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


def _verify(index, topics, results, what):
    from mqtt_tpu_torch import subscribers_equal

    check(len(results) == len(topics), f"{what}: {len(results)} results for {len(topics)} topics")
    for topic, got in zip(topics, results):
        check(subscribers_equal(got, index.subscribers(topic)), f"{what}: mismatch on {topic!r}")


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
            _verify(index, waves[0], r1, f"{name} wave 1")
            for c, f in sorted(unsub):
                index.unsubscribe(f, c)
            for k, f in enumerate(resub):
                index.subscribe(f"churn{k}", Subscription(filter=f, qos=k % 3, identifier=k + 1))
            r2, t2 = await _wave(stage, waves[1])
            _verify(index, waves[1], r2, f"{name} wave 2 (overlay)")
            deadline = time.perf_counter() + 60
            while dm.pending_deltas and time.perf_counter() < deadline:
                await asyncio.sleep(0.05)
            check(dm.pending_deltas == 0, "the background fold did not drain the overlay")
            r3, t3 = await _wave(stage, waves[2])
            _verify(index, waves[2], r3, f"{name} wave 3 (folded)")
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
        f"final batch cap {paced._batch_cap}, host-walk fallbacks {paced.fallbacks or 0}, "
        f"{pauses.summary(*out['t_paced'])}")
    log(f"  {name} launches on the main path: {launches}")
    return launches


def run(device, n_subs: int = N_SUBS, wave: int = WAVE) -> list:
    import torch

    # off the card (a rehearsal) the wrappers are never called: no counts
    counted = device.type == "cuda"
    cfgs = [
        phase_setup("cfg2", build_cfg2, n_subs, 2, device),
        phase_setup("cfg3", build_cfg3, n_subs, 3, device),
    ]
    try:
        rec = phase_kernels(torch, cfgs, device)
        main2 = phase_main(cfgs[0], wave)
        check(main2["flat_probe_ranges"] > 0 or not counted, "cfg2's main path never launched flat_probe_ranges")
        main3 = phase_main(cfgs[1], wave)
        check(main3["flat_match_compact"] > 0 or not counted, "cfg3's main path never launched flat_match_compact")
    finally:
        for cfg in cfgs:
            cfg["dm"].close()
    kernels_line = []
    for name in REPLACES:
        launches = main2[name] + main3[name]
        check(launches > 0 or not counted, f"{name} was never launched on the main path")
        r = rec[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
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
    args = ap.parse_args()
    t0 = time.perf_counter()
    try:
        phase_card(torch)
        phase_build()
        kernels_line = run(torch.device("cuda"), args.subs, args.wave)
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
