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
   bound and plain time. The row scatter (K3) writes in place: the kernel,
   its plain version and ``Tensor.index_copy_`` (its time beside K3's)
   each write a clone of the table, and K3 is held to its plain version
   also with indices out of range and duplicates. After cfg2's main path,
   K1 again at the smallest batch bucket its default-budget feed launched;
   after cfg3's, K2 likewise.
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
   for the check after its wave. Then a batch of 4096 issued on the
   snapshot is held across two folds (each 40 new clients on its topics'
   filters, then ``flush()``): it must answer with the snapshot it was
   issued against while the standby buffer is written (a topic the
   matcher walked on the host excepted), and the next batch must equal
   the walk; the folds' wall and ``fold_copies`` are printed, and its
   launches apart from the main path's. After each
   configuration's main path,
   and again after its sharded path, phase "materialize": one batch of
   4096 through the kernels, copied to the host once, then resolved in
   turns by the Python plain version, eager C, C views materialized and
   C views' ``targets()`` (all four checked against each other and the
   trie; ns a hit and a topic each), and the batch tokenized by C and by
   Python (equal arrays; µs a topic).
6. The sharded path, on the same cfg2 trie and a cfg3 trie of 262,144
   subscriptions (``SHARDED_CFG3_SUBS``, cut from 1,000,000 for the call's
   time limit; cfg3 at 1,000,000 runs in phase 5): ``MatchStage`` →
   ``DeltaMatcher(mesh=make_mesh(["cuda:0"] * 8))`` (4 subscription shards
   x 2 batch tiles, every position on the one card) →
   ``ShardedTorchMatcher``: the replica tries and the four shard indexes
   built, then one wave of publishes with the launch counts set to 0
   just before (``SHARDED_WAVES``, cut from three for the call's time
   limit), 150 unsubscribes and subscribes and a flush after it, and a
   wave under ``torch.profiler``; each step must
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
   ``MatchStage`` and ``apply``, one wave of JSON publishes
   (``PREDICATE_WAVES``, cut from three for the call's time limit). Every
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
    its plain version at the corpus's capacity. The default run takes the
    50,000 corpus only (``RETAINED_SIZES``; the 1,000,000 one, cut for the
    call's time limit, with ``--retained 50000,1000000``).
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

13. The fan-out's wire and session layer (phase "fanout", run after the
    namespace phase): bench.py's config 4 at full width, 100,000
    ``$SHARE/grp<g>/<region>/<device>/<metric>`` groups x 16 members at
    QoS 1 (1.6M subscriptions, ``build_cfg4``'s generator), matched at
    ``max_levels=4`` as ``run_cfg4`` does. Two waves of 24,576 publishes
    from eight publishers (v4 and v5, QoS 0 and 1, three reading through
    one ``ScanGate``, one sending inbound topic aliases), each encoded by
    the port's codec, fed to a ``StreamReader`` and read by
    ``Client.read`` (``frame_scan``, ``frame_scan_multi``); matched by
    ``MatchStage`` over ``DeltaMatcher`` on the card with lazy views; one
    member selected per group by the port's ``Server.fan_out_targets``
    (``Server._fan_out``'s selection: ``materialize``,
    ``Hooks.on_select_subscribers``, ``select_shared``,
    ``merge_shared_selected``; the second wave with a hook on the seam);
    delivered by the port's ``Server.publish_to_client`` (effective QoS,
    retain flag, identifiers, outbound aliases, ``next_packet_id`` and
    ``Inflight.set``, QoS 0 through one ``_FrameCache`` encode) onto the
    outbound queues of v4, v5 and aliasing v5 ``Client``s, each made with
    its write loop at its first delivery and writing to memory. Config 4
    holds no wildcard filter, so the first wave takes the matchers'
    exact-map route (a host dict probe per topic, as in the JAX package
    and bench.py's ``run_cfg4``; no kernel in either package). Between the
    waves 300 group members (the first of each of the 64 groups the alias
    publisher hits, the rest at random) unsubscribe and subscribe again
    and an audit group of 16 subscribes to ``<region>/+/+``, an addition
    that bench.py does not have (cell ``cfg4+audit``); the fold (K3)
    takes the wildcard, which ends the exact-only regime, so the second
    wave runs on the kernels, and K1, K2, K3 and K7 are then held against
    their plain versions on that table (phase 4's checks at B = 4096 and
    65,536). Every frame written is decoded and must be the next
    one ``FanoutCheck`` derives from the trie's own walk with
    ``select_shared``: the member, QoS, packet id, topic and alias.
    Printed per wave: publishes/s and deliveries/s, the split per batch
    (inbound decode, stage resolve, select + merge, deliver + encode) and
    the route's counters; then frames, bytes, inflight and alias hits,
    and the K1/K2/K3 launches (the second wave must launch K1 or K2, the
    fold K3). ``--groups`` shrinks the configuration.

14. The broker itself (phase "broker", after the re-key re-seal, with the
    earlier phases' tries freed): the port's ``Server`` with an
    ``AllowHook``, a ``MemoryStore`` and a ``TCP`` listener on
    127.0.0.1:0, driven by ``WireClient``s over ``asyncio.open_connection``
    with frames built and parsed by this script's own builders. Cell
    ``broker-legs``: cfgP's 100,000 ``$GT`` rules and 64 windows arrive as
    predicated SUBSCRIBE filters, its ``$CONTAINS``/``$EQS``/``$AND`` rules
    are restored from the store for three persistent sessions; 8,192 JSON
    publishes and 192 hot-topic ones, every delivery the trie's filtered by
    the host interpreter, every aggregate the plain windows' (K4, K5); on a
    second server (tenancy, ``retained_matcher``) cfg11's 50,000 retained
    messages restored (``load_retained`` -> ``bulk_retain`` -> ``reseed``)
    and its 64 wildcard filters SUBSCRIBEd, every retained delivery the
    walk's (K1); cfg10's tenant (100 keyed subscribers, encrypted ``e/``):
    64 encrypted retained messages re-keyed at SUBSCRIBE and 4,096
    encrypted publishes of 256 B, every payload opening under its
    subscriber's key (K6, ``native.assemble_frames``); ``rekey_tenant``
    re-seals the retained ones (``reseal_batch``, K6). Both legs' matchers
    hold a window of 63 ids a filter path, and split the 64 window holders
    and the 100 tenant subscribers over two filter paths each. Printed per
    leg: restore seconds and batches, publishes/s and deliveries/s, the
    stage's batches and resolve p50/max, the publishes the device resolved
    against each host route, and the launches per kernel; each line ends
    with the card's name and power limit. The phase fails unless every
    check holds, deliveries are more than zero, K1-K6 each launch inside
    it, and the device resolves most of each wave. Each server runs the
    matcher's breaker (``matcher_resilience``, the default); at its end
    the breaker's gauges are printed (failures by kind, trips, fallback
    and verified batches) and the phase fails on any failure, any trip,
    any batch the breaker answered from the walk, or a breaker that is
    not closed.

15. The broker's own entry point (phase "entry", after "broker"), config
    2's restart at full width: a ``LogKVStore`` of its 1,000,000
    subscription records (bench.py's generator, made in bulk, the bytes
    ``dumps`` writes) and 1,024 persistent sessions (v4 ``clean=0``, v5
    with a session expiry; the ids the trie walk hits most on the waves'
    topics), written by a process of its own started with the
    script (``entry_fill``: the store's ``_set`` with fsync off, then
    ``snapshot()``); then ``python -m mqtt_tpu_torch serve --config`` with
    a JSON config (the device matcher on the card, its breaker at the
    default, TCP, WebSocket, healthcheck and stats listeners on free
    ports, the ``logkv`` store, an ``AuthHook`` with an inline ledger) in a
    process of its own. ``/healthz`` is polled until 200; the
    ``$SYS/broker/matcher/`` rows, read over MQTT, show when the restore is
    folded (the server folds it once, after ``read_store``) and the
    ``$SYS/broker/durable/`` rows must count every record restored; 512
    sessions reconnect over TCP and 512 over WebSocket (this
    script's ``WsClient``: the upgrade and the masking by hand) with clean
    start off and must find their sessions present; 8
    publishers (v4/v5, QoS 0/1), four a listener, send two waves of 24,576
    cfg2 topics with 300 UNSUBSCRIBE/SUBSCRIBE packets between (the fold:
    K3). Every socket's frames must be the multiset of (topic, QoS,
    payload) that the session's stored filter, as the churn changed it,
    matches by cfg2's rule: the topic itself or the topic with one level
    ``+``, at the lesser QoS; the oracle is built from the records, not
    from the trie the restore built. The device
    must resolve most of each wave; the breaker's ``$SYS`` rows must show
    verified batches, no failure, trip or fallback batch and a closed state;
    ``/healthz`` 200 without breaker degradation and the stats route must
    answer; SIGTERM must end the process with 0, and the store, opened
    again, must hold the 300 churned records as the churn left them.
    Printed: the fill's walls, restore, fold and reconnect seconds,
    publishes/s and deliveries/s a wave by listener, the breaker's gauges.
    The kernels run in the broker's process, so they are not in the
    kernels line. Every phase group's wall is printed (``wall ...``).

16. The event-loop shard fabric (phase "fabric", cell ``fabric-cfg2``,
    after "entry"): entry's store as the fill wrote it (copied before
    entry ran) served again by ``serve`` with ``loop_shards: 4``
    (handoff) and the port's loop witness armed in the broker's process;
    its broker restores its copy while entry's broker restores the store,
    on the same card and host, and entry's waves wait until it settled;
    entry's sessions and publishers, entry's first wave held to the same
    oracle and to entry's device share, then 64 sessions moved onto
    another shard by a takeover (each move seen in ``/metrics``' per-shard
    connections) and one publish to each; every shard served, the stage
    resolved other loops' futures (``match_stage/resolve_marshal``), no
    witness violation, no shed, no breaker failure, SIGTERM exit 0.

17. The worker cluster (phase "cluster", cell ``cluster-cfg2``): ``serve
    --workers 4`` on the one card (the device matcher and the default
    planes in every worker); 262,144 of config 2's filters SUBSCRIBEd in
    one burst over 512 connections the kernel spreads over the workers (no
    connection holds two filters that one topic matches), a wait until
    every governor reads NORMAL and every peer link has drained, a marker from
    each worker's probe client in turn (every worker's interest known at
    the others), every worker's fold; a v4 and a v5 publisher on each
    worker send two waves of 24,576 QoS 0/1 publishes, each subscriber's
    frames the host walk's over all the filters; every worker counts
    ``peers`` 3, no dropped forward, device batches, a closed breaker
    with no fallback batch; SIGTERM to the launcher leaves no worker.
    Printed: the SUBSCRIBE leg's wall (the drain wait printed apart), each wave's publishes/s and
    deliveries/s and the share of deliveries that crossed workers.

18. The scenario lab (phase "scenarios"): ``run_matrix`` over the
    catalog's six rows on the card (the JAX package's seeds, objectives
    and params), one row a call; every row must pass its oracle and its
    SLO gate (a crashed driver is a failed row), and ``tenant_rekey``
    must launch K6. Printed: each row's oracle tallies, metrics, wall and
    launches.

19. The chaos hook (phase "chaos"): a port ``Server`` with the device
    matcher under its breaker and ``ChaosHook`` armed from a fixed seed,
    each fault kind pinned to a dispatch and three errors in a row at the
    end; 32 subscribers on 17,600 filters (the compact route), QoS 1
    publishers in rounds with a churn and a fold (K2, K3) between them.
    Every delivery must be the walk's; the breaker's failures by kind the
    injector's counts; after ``uninstall`` two forced probes close the
    breaker and the last rounds resolve on the card with no fallback; no
    table buffer stays pinned. Printed: ``fold_copies`` before and after.

20. The stress driver (phase "stress"): ``python -m mqtt_tpu_torch.stress
    --serve --device-matcher`` in processes of its own: mqtt-stresser's
    rows of 2 and 10 clients x 10,000 QoS 0 messages and 100 clients x
    1,000 (``STRESS_ROWS``, cut from 10,000 for the call's time limit),
    every message received (wildcard-free: the exact map, no kernel);
    then ``run_storm`` at its defaults on ``storm/#`` (the card), every
    admitted publish delivered, the broker's device batches above 0, its
    breaker closed; SIGTERM exit 0.

21. Config 5 under live churn (phase "cfg5-churn", ``bench.py:743-848``
    at its full size): 200,000 subscriptions over
    ``region/device/metric`` with 10% ``+``, QoS ``i % 3`` and
    identifiers ``i % 200 + 1``, 5,000 retained messages, built from
    bench.py's seed and generators;
    ``DeltaMatcher(background=True, rebuild_after=256,
    rebuild_interval=0.2)`` on the card while a thread subscribes and
    unsubscribes at about 2,000 mutations/s; ``CFG5_BATCHES`` batches of
    4096 issued one ahead, a retained wildcard scan riding each. After
    the churn stops a whole batch of 4096 must equal the trie's walk
    (``canon``, as bench.py compares), before and after a ``flush()``,
    and no table buffer may stay pinned once the matcher is closed; every
    kernel it runs is held against its plain version at its table.
    Printed: matches/s, batch p50 and p99, mutations, folds, rebuilds,
    ``fold_copies``, the host-fallback ratio, the pending deltas at the
    end and the launches by kernel.

22. Config 1 (phase "cfg1-exact", ``bench.py:152-169, 591-604``): 10,000
    exact filters through ``TorchMatcher`` on the card, ``parity_check``
    on 32 topics, then matches/s of batches of 4096 issued one ahead
    against the host walk's rate. The filter set is wildcard-free, so the
    matcher serves it from the exact map, as the JAX matcher does, and
    launches no kernel; the kernels are held against their plain versions
    at its table all the same.

Phase 4 also holds K7 (``flat_match_core``, the single-index entry point
of K8's kernel) and K4-K6 against their plain versions at the shapes these
paths give them (K5's MEAN within ``1e-5 * max(1, |want|)``, the rest with
tolerance 0). K5 takes the ragged layout (``ops.predicates.pack_windows``):
the hot topic's tick of 64 windows with NaN samples, 37 ragged windows
with an all-NaN one, and one window of one sample (its launch floor);
then the wall of one ``agg_reduce_batch`` call a tick (``agg_ticks``:
64 x 64 and the hot topic's two ticks). Phases ``predicates`` and
``broker`` print the ticks their engines reduced on the card and the
wall of each call, and every phase with a device matcher its folds'
wall and ``fold_copies``.

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
import contextlib
import functools
import gc
import json
import math
import os
import random
import signal
import socket
import subprocess
import sys
import time
import weakref
import zlib
from typing import Optional

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
SHARDED_WAVES = 1  # the sharded path's waves before its traced one: cut from three for the call's time limit
SHARDED_CFG3_SUBS = 262_144  # the sharded path's cfg3 leg: cut from 1,000,000 for the call's time limit
PREDICATE_WAVES = 1  # cfgP's waves: cut from three for the call's time limit
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
RETAINED_SIZES = (50_000,)  # 1,000,000 cut for the call's time limit (--retained 50000,1000000)
RET_TENANTS = 4  # tenant namespaces of scoped retained topics beside the global corpus
RET_PER_TENANT = 2_000
RET_CHURN = 300  # retains, and as many clears, between the first two rounds
N_RESEAL = 4096  # cfgR: retained encrypted payloads per size re-sealed at a re-key
# the Server's default planes (telemetry, tracer, host profiler, lock plane,
# SLOs, device stats, governor): every Server phase runs with them on;
# ``--planes-cost`` also runs each Server path with them off, in turns
PLANES_OFF = dict.fromkeys(("telemetry", "trace", "profile", "profile_locks", "slo", "device_stats",
                            "overload_control"), False)
# the rates of the last run of each Server path, for ``planes_cost``
READINGS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# -- configurations (copies of bench.py's build_cfg2 / build_cfg3) ------------


def cfg2_entries(n_subs: int, rng: random.Random):
    """cfg2's subscriptions and topic generator (bench.py:172): 3-level
    topics, 10% single-level + wildcards."""
    from mqtt_tpu_torch import Subscription

    v0 = [f"region{i}" for i in range(100)]
    v1 = [f"device{i}" for i in range(100)]
    v2 = [f"metric{i}" for i in range(100)]
    entries = []
    for i in range(n_subs):
        parts = [rng.choice(v0), rng.choice(v1), rng.choice(v2)]
        if rng.random() < 0.10:
            parts[rng.randrange(3)] = "+"
        entries.append((f"cl{i}", Subscription(filter="/".join(parts), qos=i % 3)))

    def topic_gen():
        return f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"

    return entries, topic_gen


def build_cfg2(n_subs: int, rng: random.Random):
    """cfg2's subscriptions in a trie, and its topic generator."""
    from mqtt_tpu_torch import TopicsIndex

    entries, topic_gen = cfg2_entries(n_subs, rng)
    index = TopicsIndex()
    index.subscribe_bulk(entries)
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


def phase_setup_trie(name: str, make_config, n_subs: int, seed: int) -> dict:
    """A configuration's trie alone (no device matcher), built as
    ``phase_setup`` builds it: the sharded path's cut cfg3 leg."""
    rng = random.Random(seed)
    gc.disable()
    try:
        t0 = time.perf_counter()
        index, entries, topic_gen = make_config(n_subs, rng)
        dt = time.perf_counter() - t0
    finally:
        _settle_gc()
    log(f"phase setup {name} for the sharded path: ok {n_subs} subscriptions (cut from the main path's), "
        f"trie {dt:.1f} s")
    return {"name": name, "index": index, "entries": entries, "topic_gen": topic_gen, "rng": rng}


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
        lib = "" if library is None else f", index_copy_ {row['library_ms']:.4f} ms"
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

        # K3: a fold-sized row scatter (a few hundred touched buckets), in
        # place, each version on its own clone of the table (the matcher's
        # own buffers are left alone); then out-of-range indices and
        # duplicates carrying identical rows
        S = arrays[0].shape[0]
        k = 512
        g = torch.Generator(device="cpu").manual_seed(5)
        idx = torch.randperm(S, generator=g)[:k].to(torch.int32).to(device)
        rows_t = torch.randint(-(2**31), 2**31, (k, 16), generator=g, dtype=torch.int64).to(torch.int32).to(device)
        idx64 = idx.to(torch.int64)
        got, want, lib_t = (arrays[0].clone() for _ in range(3))
        flat.scatter_rows(got, idx, rows_t)
        flat.scatter_rows_plain(want, idx, rows_t)
        lib_t.index_copy_(0, idx64, rows_t)
        compare("scatter_rows", got, want, f"{cfg['name']} k={k}")
        check(torch.equal(lib_t, got), "K3 disagrees with index_copy_")
        odd = torch.tensor([-1, S, S + 5, -(2**31)], dtype=torch.int32, device=device)
        idx_x = torch.cat([idx[:64], odd, idx[:32]])
        rows_x = torch.cat([rows_t[:64], rows_t[:4], rows_t[:32]])
        got_x, want_x = arrays[0].clone(), arrays[0].clone()
        flat.scatter_rows(got_x, idx_x, rows_x)
        flat.scatter_rows_plain(want_x, idx_x, rows_x)
        compare("scatter_rows", got_x, want_x, f"{cfg['name']} k={idx_x.numel()} (4 out of range, 32 duplicates)")
        del got_x, want_x
        # the in-place work's bytes: k indices and k rows read, k rows
        # written; the functional update it replaced also copied the table
        functional_ms, _ = bound(2 * S * 64 + k * 4 + k * 64, 0)
        timed(
            "scatter_rows", cfg["name"], MAIN_BATCH,
            f"S={S} k={k} in place (the functional copy's bound was {functional_ms:.4f} ms)",
            lambda: flat.scatter_rows(got, idx, rows_t),
            lambda: flat.scatter_rows_plain(want, idx, rows_t),
            k * 4 + 2 * k * 64, 0,
            library=lambda: lib_t.index_copy_(0, idx64, rows_t),
            plain_iters=5,
        )
        del got, want, lib_t
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


def _folds_under_a_batch(cfg: dict, n_topics: int = MAIN_BATCH, n_churn: int = 40) -> str:
    """The double-buffered fold under a batch in flight. A batch of
    ``n_topics`` is issued on the snapshot (its first ``2 * n_churn``
    topics from known filters), then twice over ``n_churn`` new clients
    subscribe to those filters and ``flush()`` folds them (K3 into the
    standby buffer; the second fold's standby is the buffer the batch
    captured), then the batch resolves. Each answer must be the walk's
    before the churn, except where the matcher walked the topic on the
    host (then the walk's after it); at least one topic the churn changed
    must answer from the issued snapshot; and the next batch must equal
    the trie's walk."""
    from mqtt_tpu_torch import Subscription, subscribers_equal

    index, dm, rng, gen = cfg["index"], cfg["dm"], cfg["rng"], cfg["topic_gen"]
    snap = dm.snapshot
    entries = cfg["entries"]
    flts = [entries[rng.randrange(len(entries))][1].filter for _ in range(2 * n_churn)]
    topics = [topic_for(f, rng) for f in flts] + [gen() for _ in range(n_topics - 2 * n_churn)]
    check(not dm.pending_deltas, "the overlay was not empty before the batch")
    before = [index.subscribers(t) for t in topics]
    st = snap.stats
    folds0, copies0, fb0 = st.folds, st.fold_copies, st.host_fallbacks
    secs0 = FOLD_WALL.get(snap, (0.0,))[0]
    resolver = snap.match_topics_async(topics)
    for r in range(2):
        for k in range(n_churn):
            index.subscribe(f"held{r}_{k}", Subscription(filter=flts[r * n_churn + k], qos=1))
        dm.flush()
    got = resolver()
    after = [index.subscribers(t) for t in topics]
    folds, copies = st.folds - folds0, st.fold_copies - copies0
    walked = st.host_fallbacks - fb0
    held = live = 0
    for t, g, b, a in zip(topics, got, before, after):
        if subscribers_equal(b, a):
            check(subscribers_equal(g, b), f"{cfg['name']} held batch: {t!r} differs from the walk")
        elif subscribers_equal(g, b):
            held += 1
        else:
            check(subscribers_equal(g, a), f"{cfg['name']} held batch: {t!r} is neither snapshot's")
            live += 1
    # the background fold may split a round's mutations over two folds
    check(folds >= 2, f"{cfg['name']} held batch: {folds} folds, not 2 (a full rebuild took one)")
    check(held > 0 and live <= walked, f"{cfg['name']} held batch: {held} changed topics from the issued "
          f"snapshot, {live} from the live trie with {walked} walked on the host")
    _verify(index, topics, dm.match_topics(topics), f"{cfg['name']} the batch after the two folds")
    return (f"{n_topics} topics issued, {folds} folds ({FOLD_WALL.get(snap, (0.0,))[0] - secs0:.3f} s, fold_copies {copies}) before "
            f"the resolve; {held} topics the churn changed answered from the issued snapshot, {live} walked on "
            f"the host; the next batch equal to the walk")


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
    # the batch held across two folds is not the main path: counted apart
    kernels.reset_launches()
    held = _folds_under_a_batch(cfg)
    held_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
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
    log(f"  {name} folds under a batch in flight: {held}; its launches (not the main path's): {held_launches}")
    log(f"  {name} the matcher over the phase: {fold_summary(dm)} (counted from the setup's rebuild)")
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


def phase_sharded(sh: dict, wave: int, n_waves: int = SHARDED_WAVES, n_churn: int = 150) -> dict:
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
    views (the default) and with eager results from the C materializer,
    each after one batch resolved outside the counts (the compact
    capacity learns the corpus's hits); every result must equal the trie's, no global wildcard client may
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
            # one batch resolved before the stage's, so the capacity has
            # learned the corpus's hits: the stage issues its second batch
            # before the first resolves, and a batch that outgrew its pair
            # buffer resolves eagerly on the sharded matcher
            dm.match_topics(topics[:MAIN_BATCH])
            kernels.reset_launches()
            results = asyncio.run(drive())
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            stats = dm.stats.as_dict()
        finally:
            dm.close()
        n_views = _verify(index, topics, results, f"namespace {what}")
        check((n_views > 0) == lazy,
              f"namespace {what}: {n_views} lazy views, compact_batches {stats['compact_batches']}, "
              f"compact_overflows {stats['compact_overflows']}")
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
            f"compact_batches {stats['compact_batches']}, compact_overflows {stats['compact_overflows']}")
    if device.type == "cuda":
        check(launches["flat_probe_ranges"] + launches["flat_match_compact"] > 0
              and launches["sharded_step"] > 0, f"the namespace phase ran no matcher kernel: {launches}")
    log(f"  namespace launches: {launches}")
    return launches


# -- the fan-out's wire and session layer (cfg4) -------------------------------

N_GROUPS = 100_000  # bench.py config 4: $SHARE groups ...
GROUP_MEMBERS = 16  # ... of 16 members each, QoS 1
FANOUT_CHURN = 300  # group members unsubscribing and subscribing again between the waves
FANOUT_HOT = 64  # the alias publisher's topics, each a group's inner filter
# config 4 holds no wildcard filter, so neither package's matcher launches
# a kernel on it; the phase's second wave adds an audit group on
# <region>/+/+, which bench.py does not have, and is named apart
AUDIT_CELL = "cfg4+audit"
# the publishers of a wave: (protocol version, QoS, through the shared
# ScanGate, with inbound topic aliases); each sends every 8th topic
PUBLISHERS = (
    (4, 0, False, False), (4, 1, False, False), (5, 0, False, False), (5, 1, False, False),
    (4, 0, True, False), (5, 1, True, False), (5, 0, True, False), (5, 1, False, True),
)
ALIAS_MAX = 8  # the outbound topic alias maximum of a third of the subscribers (v5)


def subscriber_kind(cid: str) -> tuple:
    """A subscriber's protocol version and outbound topic alias maximum,
    by its client id: v4, v5, or v5 with ``ALIAS_MAX`` aliases, a third
    each."""
    return ((4, 0), (5, 0), (5, ALIAS_MAX))[zlib.crc32(cid.encode()) % 3]


def build_cfg4(n_groups: int, members: int, rng: random.Random):
    """100k ``$share`` groups x 16 members, QoS1 (bench.py:218-236), the
    trie filled in the generator's order under one lock acquisition."""
    from mqtt_tpu_torch import SHARE_PREFIX, Subscription, TopicsIndex

    v0 = [f"region{i}" for i in range(100)]
    v1 = [f"device{i}" for i in range(100)]
    v2 = [f"metric{i}" for i in range(100)]
    entries = []
    for g in range(n_groups):
        flt = f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"
        for m in range(members):
            entries.append((f"g{g}m{m}", Subscription(filter=f"{SHARE_PREFIX}/grp{g}/{flt}", qos=1)))
    index = TopicsIndex()
    index.subscribe_bulk(entries)

    def topic_gen():
        return f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"

    return index, entries, topic_gen


class MemWriter:
    """An in-memory stand-in for a client's ``asyncio.StreamWriter``."""

    def __init__(self) -> None:
        self.data = bytearray()

    def write(self, b) -> None:
        self.data += b

    def get_extra_info(self, name, default=None):
        return default


def split_frames(data: bytes) -> list:
    """Split a byte stream of whole MQTT packets at their fixed headers."""
    out, pos = [], 0
    while pos < len(data):
        n, shift, k = 0, 0, pos + 1
        while True:
            b = data[k]
            n |= (b & 0x7F) << shift
            k += 1
            if not b & 0x80:
                break
            shift += 7
        out.append(bytes(data[pos : k + n]))
        pos = k + n
    return out


class Fanout:
    """The fan-out's wire and session layer of one package, beneath its
    server's listeners: publishers' frames read by ``Client.read``
    (``frame_scan``, or ``ScanGate``/``frame_scan_multi``) and decoded by
    the codec, inbound topic aliases resolved; each result of the stage's
    match taken by the server's ``fan_out_targets`` (``Server._fan_out``'s
    selection: a view without shared or inline entries through
    ``targets()``, else materialized; ``Hooks.on_select_subscribers``,
    then ``select_shared`` unless a hook selected, and
    ``merge_shared_selected``); each target delivered by the server's
    ``publish_to_client`` onto the client's outbound queue, which the
    client's write loop drains into an in-memory writer. QoS 0 targets share one encode through
    ``_FrameCache``; the others take the effective QoS, the retain flag,
    subscription identifiers, outbound aliases, ``next_packet_id`` and
    ``Inflight.set``, then ``write_packet``.

    ``mods`` names the package's modules (``packets``, ``clients``,
    ``hooks``, ``topics``, ``server``, ``system``, ``native``), so the same
    steps run over the port and, in the tests, over the JAX package.
    ``srv`` is the server whose ``fan_out_targets``, ``deliver_inline``,
    ``publish_to_client`` and ``_ops`` the steps use: by default a port
    ``Server`` without its device planes (``predicate_filters=False``,
    ``device_stats=False``; its telemetry counts the fan-out); in
    the tests a stand-in over a JAX ``Server``. Its QoS 0 frame passthrough
    is switched off (it would answer these publishers from the server's
    empty trie). A subscriber's ``Client`` is made, and its write loop
    started, when it first receives."""

    def __init__(self, mods, srv=None, planes: bool = True) -> None:
        self.m = mods
        hk = mods.hooks
        if srv is None:
            opts = dict({} if planes else PLANES_OFF, predicate_filters=False, device_stats=False, gc_tuning=False)
            srv = mods.server.Server(mods.server.Options(**opts))
        self.srv = srv
        self.ops = srv._ops
        self.ops.fast_publish = self.ops.fast_publish_eligible = None

        class Allow(hk.Hook):
            """Allows every client and topic (the auth hooks arrive with
            the server)."""

            def id(self):
                return "allow-all"

            def provides(self, b):
                return b in (hk.ON_ACL_CHECK, hk.ON_CONNECT_AUTHENTICATE)

            def on_acl_check(self, cl, topic, write):
                return True

            def on_connect_authenticate(self, cl, pk):
                return True

        class Select(hk.Hook):
            """The selection seam: selects as the server would, and counts."""

            def __init__(self):
                super().__init__()
                self.calls = 0

            def id(self):
                return "select-shared"

            def provides(self, b):
                return b == hk.ON_SELECT_SUBSCRIBERS

            def on_select_subscribers(self, subs, pk):
                self.calls += 1
                subs.select_shared()
                return subs

        self.ops.hooks.add(Allow(), None)
        self.select_hook = Select()
        self.clients = mods.clients.Clients()
        self.writers: dict = {}
        acc = mods.native.accel()
        self.view_t = getattr(acc, "SubscribersView", None) if acc is not None else None
        self.gate = mods.clients.ScanGate()
        self.inbound_alias_hits = 0
        self.dropped = 0

    def add_select_hook(self) -> None:
        self.ops.hooks.add(self.select_hook, None)

    # -- inbound --------------------------------------------------------------

    def connect(self, cid: str, version: int, alias_max: int = 0, writer=None):
        """A ``Client`` after ``parse_connect`` of its CONNECT."""
        p = self.m.packets
        pk = p.Packet(
            fixed_header=p.FixedHeader(type=p.CONNECT), protocol_version=version,
            connect=p.ConnectParams(protocol_name=b"MQTT", clean=True, keepalive=30, client_identifier=cid),
            properties=p.Properties(topic_alias_maximum=alias_max),
        )
        cl = self.m.clients.Client(None, writer, self.ops)
        cl.parse_connect("fanout", pk)
        return cl

    def publish_frames(self, topics: list, wave: int, hot: list) -> list:
        """Each publisher's PUBLISH frames, encoded by the codec: every 8th
        topic (the alias publisher sends the hot topics in turn, each with
        its alias the first time and the alias alone after); payloads name
        the wave, the publisher and the publish."""
        p = self.m.packets
        out = []
        for k, (version, qos, _gated, aliased) in enumerate(PUBLISHERS):
            buf = bytearray()
            aliases: dict = {}
            for i, topic in enumerate(topics[k :: len(PUBLISHERS)]):
                pk = p.Packet(fixed_header=p.FixedHeader(type=p.PUBLISH, qos=qos), protocol_version=version,
                              payload=f"w{wave}p{k}n{i}".encode(), topic_name=topic,
                              packet_id=1 + i % 0xFFFF if qos else 0)
                if aliased:
                    topic = hot[i % len(hot)]
                    alias = aliases.get(topic)
                    pk.topic_name = "" if alias is not None else topic
                    if alias is None:
                        alias = aliases[topic] = len(aliases) + 1
                    pk.properties.topic_alias, pk.properties.topic_alias_flag = alias, True
                buf += p.encode_packet(pk)
            out.append(bytes(buf))
        return out

    async def inbound(self, frames: list) -> list:
        """Every publisher's frames through ``Client.read`` over a fed and
        closed ``StreamReader`` (the read loop ends at its EOF), the gated
        publishers' scans coalesced by one ``ScanGate``; returns the
        publishes in publisher order, aliases resolved."""
        p, m = self.m.packets, self.m
        got: list = [[] for _ in frames]

        def handler_for(k):
            def handle(cl, pk):
                if pk.fixed_header.type != p.PUBLISH:
                    return None
                if pk.properties.topic_alias_flag and pk.properties.topic_alias > 0:  # [MQTT-3.3.2-11]
                    self.inbound_alias_hits += pk.topic_name == ""
                    pk.topic_name = cl.state.topic_aliases.inbound.set(pk.properties.topic_alias, pk.topic_name)
                if m.topics.is_valid_filter(pk.topic_name, True):
                    pk.origin = cl.id
                    got[k].append(pk)
                return None

            return handle

        async def one(k, data):
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            cl = self.connect(f"pub{k}", PUBLISHERS[k][0])
            cl.net.reader = reader
            if PUBLISHERS[k][2]:
                cl.scan_gate = self.gate
            try:
                await cl.read(handler_for(k))
            except m.clients.ConnectionClosedError:
                pass  # the reader's EOF

        await asyncio.gather(*(one(k, d) for k, d in enumerate(frames)))
        return [pk for pks in got for pk in pks]

    # -- select and deliver ---------------------------------------------------

    def subscriber(self, cid: str):
        """The subscriber's ``Client`` (of its ``subscriber_kind``), made
        with its write loop at its first delivery."""
        cl = self.clients.get(cid)
        if cl is None:
            w = MemWriter()
            cl = self.connect(cid, *subscriber_kind(cid), w)
            self.clients.add_client(cl)
            self.writers[cid] = w
            cl.start_write_loop()
        return cl

    async def wave(self, stage, topics: list, wave: int, hot: list) -> dict:
        """One wave through every step; the legs' seconds and the
        publishes and targets, for the check."""
        hk = self.m.hooks
        frames = self.publish_frames(topics, wave, hot)
        t0 = time.perf_counter()
        pks = await self.inbound(frames)
        t1 = time.perf_counter()
        results = await asyncio.gather(*(stage.submit(pk.topic_name) for pk in pks))
        t2 = time.perf_counter()
        srv = self.srv
        targets = []
        for pk, r in zip(pks, results):
            items, inline, _ = srv.fan_out_targets(pk, r)
            targets.append(list(items))
            srv.deliver_inline(inline, pk)
        t3 = time.perf_counter()
        share = not self.ops.hooks.provides(hk.ON_PACKET_ENCODE, hk.ON_PACKET_SENT)
        touched = {}
        for pk, items in zip(pks, targets):
            fast = self.m.server._FrameCache(pk) if pk.fixed_header.qos == 0 and share else None
            for cid, sub in items:
                cl = touched[cid] = self.subscriber(cid)
                try:
                    srv.publish_to_client(cl, sub, pk, fast)
                except self.m.packets.Code:
                    self.dropped += 1
        # the write loops drain the outbound queues
        while any(not cl.state.outbound.empty() for cl in touched.values()):
            await asyncio.sleep(0)
        t4 = time.perf_counter()
        return {"pks": pks, "targets": targets, "frames": frames, "results": results,
                "inbound_s": t1 - t0, "resolve_s": t2 - t1, "select_s": t3 - t2, "deliver_s": t4 - t3}

    def outbound(self) -> dict:
        return {cid: bytes(w.data) for cid, w in self.writers.items()}

    async def close(self) -> None:
        """Stop every subscriber's ``Client``: its write loop ends."""
        for cid in self.writers:
            self.clients.get(cid).stop()
        await asyncio.sleep(0)


def fanout_modules():
    """The port's modules the fan-out harness drives."""
    from types import SimpleNamespace

    from mqtt_tpu_torch import clients, hooks, native, packets, server, system, topics

    return SimpleNamespace(clients=clients, hooks=hooks, native=native, packets=packets, server=server,
                           system=system, topics=topics)


class FanoutCheck:
    """The plain reference for the delivered frames: per publish, the
    trie's own walk (``TopicsIndex.subscribers``) with ``select_shared``
    and ``merge_shared_selected``; per subscriber, the protocol version of
    its kind, packet ids counted from 1 for its QoS 1 deliveries, and its
    outbound aliases. Every frame the clients' writers hold since the last
    check is decoded with the port's codec and must be the next one
    expected."""

    def __init__(self) -> None:
        self.offsets: dict = {}
        self.pids: dict = {}
        self.aliases: dict = {}  # cid -> {topic: alias}
        self.frames = self.bytes = self.alias_hits = 0

    def __call__(self, index, fan, pks: list, what: str) -> int:
        from mqtt_tpu_torch import packets as p

        want: dict = {}
        for pk in pks:
            s = index.subscribers(pk.topic_name)
            s.select_shared()
            s.merge_shared_selected()
            for cid, sub in s.subscriptions.items():
                if sub.no_local and pk.origin == cid:
                    continue
                want.setdefault(cid, []).append((pk.topic_name, bytes(pk.payload), min(pk.fixed_header.qos, sub.qos)))
        n = 0
        check(set(want) <= set(fan.writers), f"{what}: {len(set(want) - set(fan.writers))} subscribers never written")
        for cid, w in fan.writers.items():
            start = self.offsets.get(cid, 0)
            frames = split_frames(bytes(w.data[start:]))
            self.offsets[cid] = len(w.data)
            self.bytes += len(w.data) - start
            exp = want.get(cid, [])
            check(len(frames) == len(exp), f"{what}: {cid} got {len(frames)} frames, the trie selects it {len(exp)} times")
            version, alias_max = subscriber_kind(cid)
            amap = self.aliases.setdefault(cid, {})
            for raw, (topic, payload, qos) in zip(frames, exp):
                got = p.decode_packet(raw, version)
                check(got.fixed_header.type == p.PUBLISH and bytes(got.payload) == payload
                      and got.fixed_header.qos == qos and not got.fixed_header.retain and not got.fixed_header.dup,
                      f"{what}: {cid} got {got.fixed_header} {bytes(got.payload)!r}, want {payload!r} at QoS {qos}")
                pid = 0
                if qos:
                    pid = self.pids[cid] = self.pids.get(cid, 0) + 1
                check(got.packet_id == pid, f"{what}: {cid} packet id {got.packet_id}, want {pid}")
                alias = 0
                if alias_max:
                    alias = amap.get(topic, 0)
                    if alias == 0 and len(amap) < alias_max:
                        alias = amap[topic] = len(amap) + 1
                        wire = topic
                    else:
                        wire = "" if alias else topic
                        self.alias_hits += alias > 0
                else:
                    wire = topic
                check(got.properties.topic_alias == alias and got.topic_name == wire,
                      f"{what}: {cid} topic {got.topic_name!r} alias {got.properties.topic_alias}, "
                      f"want {wire!r} alias {alias}")
                n += 1
        self.frames += n
        return n


# -- MQTT frames built and parsed by hand, and a client over TCP (phase broker)


def _vbi(n: int) -> bytes:
    """A variable byte integer (MQTT 5 section 1.5.5)."""
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _utf8(s) -> bytes:
    b = s.encode() if isinstance(s, str) else bytes(s)
    return len(b).to_bytes(2, "big") + b


# property identifiers by type (MQTT 5 section 2.2.2.2)
_PROP_BYTE = {0x01, 0x17, 0x19, 0x24, 0x25, 0x28, 0x29, 0x2A}
_PROP_U16 = {0x13, 0x21, 0x22, 0x23}
_PROP_U32 = {0x02, 0x11, 0x18, 0x27}
_PROP_VBI = {0x0B}
_PROP_STR = {0x03, 0x08, 0x12, 0x15, 0x1A, 0x1C, 0x1F, 0x09, 0x16}  # strings and binary data
P_MESSAGE_EXPIRY, P_SUB_ID, P_SESSION_EXPIRY, P_WILL_DELAY = 0x02, 0x0B, 0x11, 0x18
P_RECEIVE_MAX, P_ALIAS_MAX, P_ALIAS, P_USER = 0x21, 0x22, 0x23, 0x26


def wire_props(props) -> bytes:
    """An MQTT 5 property block from ``(identifier, value)`` pairs."""
    body = bytearray()
    for pid, v in props:
        body.append(pid)
        if pid in _PROP_BYTE:
            body.append(v)
        elif pid in _PROP_U16:
            body += v.to_bytes(2, "big")
        elif pid in _PROP_U32:
            body += v.to_bytes(4, "big")
        elif pid in _PROP_VBI:
            body += _vbi(v)
        elif pid in _PROP_STR:
            body += _utf8(v)
        elif pid == P_USER:
            body += _utf8(v[0]) + _utf8(v[1])
        else:
            raise ValueError(f"property {pid:#x}")
    return _vbi(len(body)) + bytes(body)


def parse_props(buf: bytes, off: int) -> tuple:
    """An MQTT 5 property block at ``off``: ``({identifier: value or
    [values]}, offset after it)``."""
    n, shift = 0, 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    end, out = off + n, {}
    while off < end:
        pid = buf[off]
        off += 1
        if pid in _PROP_BYTE:
            v, off = buf[off], off + 1
        elif pid in _PROP_U16:
            v, off = int.from_bytes(buf[off:off + 2], "big"), off + 2
        elif pid in _PROP_U32:
            v, off = int.from_bytes(buf[off:off + 4], "big"), off + 4
        elif pid in _PROP_VBI:
            v, shift = 0, 0
            while True:
                b = buf[off]
                off += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif pid in _PROP_STR or pid == P_USER:
            ln = int.from_bytes(buf[off:off + 2], "big")
            v, off = bytes(buf[off + 2:off + 2 + ln]), off + 2 + ln
            if pid == P_USER:
                ln = int.from_bytes(buf[off:off + 2], "big")
                v, off = (v, bytes(buf[off + 2:off + 2 + ln])), off + 2 + ln
        else:
            raise ValueError(f"property {pid:#x}")
        if pid in out:
            out[pid] = (out[pid] if isinstance(out[pid], list) else [out[pid]]) + [v]
        else:
            out[pid] = v
    return out, end


def wire_frame(first: int, body: bytes) -> bytes:
    return bytes([first]) + _vbi(len(body)) + body


def connect_frame(cid: str, version: int = 4, clean: bool = True, keepalive: int = 60, props=(),
                  will=None, username=None, password=None) -> bytes:
    """CONNECT; ``will`` is ``(topic, payload, qos, retain, props)``."""
    flags = 0x02 if clean else 0
    if will is not None:
        flags |= 0x04 | (will[2] << 3) | (0x20 if will[3] else 0)
    if username is not None:
        flags |= 0x80
    if password is not None:
        flags |= 0x40
    body = _utf8(b"MQIsdp" if version == 3 else b"MQTT") + bytes([version, flags]) + keepalive.to_bytes(2, "big")
    if version == 5:
        body += wire_props(props)
    body += _utf8(cid)
    if will is not None:
        if version == 5:
            body += wire_props(will[4])
        body += _utf8(will[0]) + _utf8(will[1])
    if username is not None:
        body += _utf8(username)
    if password is not None:
        body += _utf8(password)
    return wire_frame(0x10, body)


def subscribe_frame(pid: int, filters, version: int = 4, props=()) -> bytes:
    """SUBSCRIBE of ``(filter, qos, option bits)`` entries (no local 0x04,
    retain as published 0x08, retain handling << 4)."""
    body = pid.to_bytes(2, "big") + (wire_props(props) if version == 5 else b"")
    for flt, qos, opts in filters:
        body += _utf8(flt) + bytes([qos | opts])
    return wire_frame(0x82, body)


def unsubscribe_frame(pid: int, filters, version: int = 4) -> bytes:
    body = pid.to_bytes(2, "big") + (wire_props(()) if version == 5 else b"")
    for flt in filters:
        body += _utf8(flt)
    return wire_frame(0xA2, body)


def publish_frame(topic: str, payload: bytes, qos: int = 0, pid: int = 0, retain: bool = False,
                  dup: bool = False, version: int = 4, props=()) -> bytes:
    first = 0x30 | (0x08 if dup else 0) | (qos << 1) | (0x01 if retain else 0)
    body = _utf8(topic) + (pid.to_bytes(2, "big") if qos else b"") + (wire_props(props) if version == 5 else b"")
    return wire_frame(first, body + payload)


PUBACK, PUBREC, PUBREL, PUBCOMP = 4, 5, 6, 7
PINGREQ_FRAME = b"\xc0\x00"


def ack_frame(kind: int, pid: int) -> bytes:
    """PUBACK, PUBREC, PUBREL (flags 0010) or PUBCOMP, reason success."""
    return wire_frame((kind << 4) | (0x02 if kind == PUBREL else 0), pid.to_bytes(2, "big"))


def disconnect_frame(version: int = 4, reason: int = 0, props=()) -> bytes:
    if version == 5 and (reason or props):
        return wire_frame(0xE0, bytes([reason]) + wire_props(props))
    return b"\xe0\x00"


def frame_parts(raw: bytes) -> tuple:
    """``(first byte, body)`` of one whole frame."""
    k = 1
    while raw[k] & 0x80:
        k += 1
    return raw[0], raw[k + 1:]


def parse_publish(raw: bytes, version: int) -> dict:
    """A PUBLISH frame's fields."""
    first, body = frame_parts(raw)
    qos = (first >> 1) & 3
    tl = int.from_bytes(body[0:2], "big")
    topic, off = body[2:2 + tl].decode(), 2 + tl
    pid = 0
    if qos:
        pid, off = int.from_bytes(body[off:off + 2], "big"), off + 2
    props = {}
    if version == 5:
        props, off = parse_props(body, off)
    return {"topic": topic, "qos": qos, "pid": pid, "retain": bool(first & 1), "dup": bool(first & 8),
            "props": props, "payload": bytes(body[off:])}


class WireClient:
    """One MQTT client over TCP (``asyncio.open_connection``): it sends the
    frames above, and a reader task keeps every byte the broker sends, one
    buffer per connection (``conns``), until the broker ends it."""

    def __init__(self, name: str, version: int = 4) -> None:
        self.name = name
        self.version = version
        self.conns: list = []
        self.writer = None
        self.task = None
        self._got = asyncio.Event()

    async def open(self, host: str, port: int) -> None:
        reader, self.writer = await asyncio.open_connection(host, port)
        buf = bytearray()
        self.conns.append(buf)
        self.task = asyncio.get_running_loop().create_task(self._read(reader, buf))

    async def _read(self, reader, buf: bytearray) -> None:
        try:
            while True:
                chunk = await reader.read(1 << 16)
                if not chunk:
                    return
                buf += chunk
                self._got.set()
        except ConnectionError:
            return
        finally:
            self._got.set()

    def send(self, data: bytes) -> None:
        self.writer.write(data)

    def frames(self) -> list:
        """The whole frames of the current connection so far."""
        buf = bytes(self.conns[-1])
        out, pos = [], 0
        while pos + 1 < len(buf):
            n, shift, k = 0, 0, pos + 1
            while k < len(buf):
                b = buf[k]
                n |= (b & 0x7F) << shift
                k += 1
                if not b & 0x80:
                    break
                shift += 7
            else:
                break
            if k + n > len(buf):
                break
            out.append(buf[pos:k + n])
            pos = k + n
        return out

    async def wait_frames(self, n: int, limit: float = 30.0, stall: Optional[float] = None) -> list:
        """The current connection's frames once it holds ``n`` (or once the
        broker ended it). With ``stall``, also once no byte arrived for
        ``stall`` seconds: the caller then accounts for what is missing."""
        deadline = time.monotonic() + limit
        size, t_grew = -1, time.monotonic()
        while True:
            frames = self.frames()
            if len(frames) >= n or self.task.done():
                return frames
            if len(self.conns[-1]) != size:
                size, t_grew = len(self.conns[-1]), time.monotonic()
            elif stall is not None and time.monotonic() - t_grew >= stall:
                return frames
            self._got.clear()
            left = deadline - time.monotonic()
            if left <= 0:
                raise PhaseFailed(f"{self.name}: {len(frames)} of {n} frames within {limit} s")
            if stall is not None:
                left = min(left, max(0.01, t_grew + stall - time.monotonic()))
            try:
                await asyncio.wait_for(self._got.wait(), left)
            except asyncio.TimeoutError:
                pass

    async def half_close(self, limit: float = 30.0) -> None:
        """Send EOF and wait for the broker to end the connection."""
        self.writer.write_eof()
        await self.ended(limit)

    async def ended(self, limit: float = 30.0) -> None:
        await asyncio.wait_for(asyncio.shield(self.task), limit)
        self.writer.close()


WS_KEY = "dGhlIHNhbXBsZSBub25jZQ=="  # RFC 6455's sample nonce
WS_ACCEPT = b"s3pPLMBiTxaQ9kYGzzhZRbK+xOo="  # its Sec-WebSocket-Accept


class WsClient(WireClient):
    """One MQTT client over WebSocket (RFC 6455), spoken by hand: the HTTP
    upgrade asking for the ``mqtt`` subprotocol, every send one masked
    binary frame, and the reader task unwrapping the broker's frames into
    the MQTT byte stream that ``frames()`` reads, one buffer per
    connection."""

    def __init__(self, name: str, version: int = 4, path: str = "/mqtt") -> None:
        super().__init__(name, version)
        self.path = path
        self._mask = zlib.crc32(name.encode()) | 1  # a client's masking keys, seeded by its name

    async def open(self, host: str, port: int) -> None:
        reader, self.writer = await asyncio.open_connection(host, port)
        self.writer.write((f"GET {self.path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {WS_KEY}\r\n"
                           "Sec-WebSocket-Protocol: mqtt\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 30.0)
        if not head.startswith(b"HTTP/1.1 101") or b"Sec-WebSocket-Accept: " + WS_ACCEPT not in head \
                or b"Sec-WebSocket-Protocol: mqtt" not in head:
            raise PhaseFailed(f"{self.name}: websocket upgrade refused: {head[:120]!r}")
        buf = bytearray()
        self.conns.append(buf)
        self.task = asyncio.get_running_loop().create_task(self._read_ws(reader, buf))

    async def _read_ws(self, reader, buf: bytearray) -> None:
        """Unwrap the broker's frames (unmasked, FIN set) into ``buf``;
        return at a close frame or EOF."""
        pending = bytearray()
        try:
            while True:
                chunk = await reader.read(1 << 16)
                if not chunk:
                    return
                pending += chunk
                pos, grew = 0, False
                while len(pending) - pos >= 2:
                    op, n, k = pending[pos] & 0x0F, pending[pos + 1] & 0x7F, pos + 2
                    if n == 126:
                        if len(pending) - k < 2:
                            break
                        n, k = int.from_bytes(pending[k:k + 2], "big"), k + 2
                    elif n == 127:
                        if len(pending) - k < 8:
                            break
                        n, k = int.from_bytes(pending[k:k + 8], "big"), k + 8
                    if len(pending) - k < n:
                        break
                    if op == 0x8:
                        return
                    if op in (0x0, 0x2):
                        buf += pending[k:k + n]
                        grew = True
                    pos = k + n
                del pending[:pos]
                if grew:
                    self._got.set()
        except ConnectionError:
            return
        finally:
            self._got.set()

    def send(self, data: bytes) -> None:
        self._mask = (self._mask * 1103515245 + 12345) & 0xFFFFFFFF
        mask = self._mask.to_bytes(4, "big")
        n = len(data)
        if n < 126:
            head = bytes([0x82, 0x80 | n])
        elif n < 1 << 16:
            head = bytes([0x82, 0x80 | 126]) + n.to_bytes(2, "big")
        else:
            head = bytes([0x82, 0x80 | 127]) + n.to_bytes(8, "big")
        key = (mask * (n // 4 + 1))[:n]
        body = (int.from_bytes(data, "big") ^ int.from_bytes(key, "big")).to_bytes(n, "big") if n else b""
        self.writer.write(head + mask + body)


async def http_get(host: str, port: int, path: str, limit: float = 30.0) -> tuple:
    """``GET path`` over one HTTP/1.1 connection: the status code and the
    body (the broker's HTTP listeners close after each answer)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
        raw = await asyncio.wait_for(reader.read(-1), limit)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


def phase_setup_fanout(n_groups: int, device, card: str) -> dict:
    from mqtt_tpu_torch import DeltaMatcher

    rng = random.Random(4)
    gc.disable()
    try:
        t0 = time.perf_counter()
        index, entries, topic_gen = build_cfg4(n_groups, GROUP_MEMBERS, rng)
        t1 = time.perf_counter()
        # bench.py's run_cfg4 matches at max_levels=4
        dm = DeltaMatcher(index, max_levels=4, rebuild_interval=0.5, device=device)
        t2 = time.perf_counter()
    finally:
        _settle_gc()
    fl = dm.snapshot.index
    log(f"phase setup cfg4: ok {len(entries)} subscriptions ({n_groups} $SHARE groups x {GROUP_MEMBERS}, QoS 1), "
        f"trie {t1 - t0:.1f} s, index {t2 - t1:.1f} s, entries {fl.n_entries}, P {fl.num_patterns}, "
        f"S {fl.table.shape[0]}, sat {fl.n_sat}, spill {fl.n_spill}; {card}")
    return {"name": "cfg4", "index": index, "entries": entries, "topic_gen": topic_gen, "rng": rng, "dm": dm}


def phase_fanout(cfg: dict, wave: int, card: str, n_churn: int = FANOUT_CHURN, planes: bool = True) -> dict:
    """Config 4 delivered to clients (launch counts reset just before):
    two waves of ``wave`` publishes from eight publishers (v4 and v5, QoS
    0 and 1, three through one ``ScanGate``, one with inbound topic
    aliases) read, decoded, matched by ``MatchStage`` over
    ``DeltaMatcher``, one member selected per group, and delivered to
    v4, v5 and aliasing v5 subscribers. Config 4's filters hold no
    wildcard, so the first wave takes the matchers' exact-map route (a
    host dict probe per topic, as the JAX matcher takes it; no kernel).
    Between the waves ``n_churn`` group members unsubscribe and subscribe
    again, and an audit group of ``GROUP_MEMBERS`` subscribes to
    ``<region>/+/+`` (not in bench.py: cell ``AUDIT_CELL``): its wildcard
    ends the exact-only regime at the fold (K3), so the second wave, with
    a hook on the selection seam, runs on the kernels. Every frame must be the plain reference's
    (``FanoutCheck``). ``planes=False`` builds the stand-in server without
    its default planes (``PLANES_OFF``)."""
    from mqtt_tpu_torch import SHARE_PREFIX, MatchStage, Subscription
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.topics import shared_inner

    index, dm, rng, gen, entries = cfg["index"], cfg["dm"], cfg["rng"], cfg["topic_gen"], cfg["entries"]
    on_cuda = dm.snapshot.device.type == "cuda"
    fan = Fanout(fanout_modules(), planes=planes)
    verify = FanoutCheck()
    hot = [shared_inner(entries[g * GROUP_MEMBERS][1].filter) for g in range(min(FANOUT_HOT, len(entries) // GROUP_MEMBERS))]
    # the first member of every hot group, then members at random: a
    # churned first member moves to the end of its group, so the second
    # wave selects another member for it (from the folded device rows)
    churn = dict(entries[g * GROUP_MEMBERS] for g in range(len(hot)))
    churn.update(entries[rng.randrange(len(entries))] for _ in range(n_churn - len(churn)))
    audit = f"{SHARE_PREFIX}/audit/{hot[0].split('/')[0]}/+/+"
    check(dm.snapshot.index.exact_map is not None, "cfg4: a wildcard-free filter set without the exact map")
    rows = []

    async def drive():
        stage = MatchStage(dm, index.subscribers, max_batch=MAIN_BATCH, latency_budget_s=None,
                           max_pending=1 << 20)
        stage.start()
        try:
            for w in range(2):
                if w == 1:
                    for cid, sub in churn.items():
                        index.unsubscribe(sub.filter, cid)
                    for cid, sub in churn.items():
                        index.subscribe(cid, Subscription(filter=sub.filter, qos=1))
                    for m in range(GROUP_MEMBERS):
                        index.subscribe(f"audit{m}", Subscription(filter=audit, qos=1))
                    deadline = time.perf_counter() + 60
                    while dm.pending_deltas and time.perf_counter() < deadline:
                        await asyncio.sleep(0.05)
                    check(dm.pending_deltas == 0, "cfg4: the background fold did not drain the overlay")
                    check(dm.snapshot.index.exact_map is None, "cfg4: the wildcard did not end the exact map")
                    fan.add_select_hook()
                batches0, stats0 = len(stage.service_log), dict(dm.stats.as_dict())
                launches0 = dict(kernels.LAUNCHES)
                t0 = time.perf_counter()
                r = await fan.wave(stage, [gen() for _ in range(wave)], w, hot)
                r["wall_s"] = time.perf_counter() - t0
                r["launches"] = {k: v - launches0[k] for k, v in kernels.LAUNCHES.items()}
                r["batches"] = len(stage.service_log) - batches0
                r["stats"] = {k: v - stats0[k] for k, v in dm.stats.as_dict().items()
                              if isinstance(v, (int, float)) and k in stats0}
                r["frames_out"] = verify(index, fan, r["pks"], f"cfg4 wave {w + 1}")
                rows.append(r)
        finally:
            await fan.close()
            await stage.stop()
        check(stage.admission_fallbacks == 0 and not stage.fallbacks,
              f"cfg4: the stage fell back to the host walk: {stage.fallbacks}")

    t_phase = time.perf_counter()
    folds0 = dm.stats.as_dict()["folds"]
    kernels.reset_launches()
    asyncio.run(drive())
    launches = dict(kernels.LAUNCHES)
    for w, r in enumerate(rows):
        n_pub = len(r["pks"])
        check(n_pub == wave, f"cfg4 wave {w + 1}: {n_pub} of {wave} publishes read")
        nb = max(1, r["batches"])
        n_del = sum(len(t) for t in r["targets"])
        st = r["stats"]
        cell = "cfg4" if w == 0 else f"{AUDIT_CELL} (the audit wildcard is not from bench.py)"
        READINGS[f"fanout wave {w + 1} publishes/s"] = n_pub / r["wall_s"]
        log(f"phase fanout {cell} wave {w + 1}: ok {n_pub} publishes, {n_del} deliveries "
            f"({n_del / n_pub:.4f} a publish), every frame the trie's selection; "
            f"{n_pub / r['wall_s']:.1f} publishes/s, {n_del / r['wall_s']:.1f} deliveries/s through the whole path "
            f"({r['wall_s']:.3f} s); per batch of {MAIN_BATCH} ({r['batches']} batches): inbound decode "
            f"{r['inbound_s'] / nb * 1e3:.3f} ms, stage resolve {r['resolve_s'] / nb * 1e3:.3f} ms, "
            f"select + merge {r['select_s'] / nb * 1e3:.3f} ms, deliver + encode {r['deliver_s'] / nb * 1e3:.3f} ms; "
            f"route {'exact map (host dict probe)' if w == 0 else 'kernels'}: host_fast {st.get('host_fast', 0)}, "
            f"host_fallbacks {st.get('host_fallbacks', 0)}, compact_batches {st.get('compact_batches', 0)}, "
            f"compact_overflows {st.get('compact_overflows', 0)}, K1 {r['launches']['flat_probe_ranges']}, "
            f"K2 {r['launches']['flat_match_compact']}; selection hook {'on' if w else 'off'}; {card}")
    inflight = sum(len(fan.clients.get(c).state.inflight) for c in fan.writers)
    folds = dm.stats.as_dict()["folds"] - folds0
    log(f"  cfg4 outbound: {verify.frames} frames, {verify.bytes} bytes to {len(fan.writers)} subscribers, "
        f"QoS 1 inflight {inflight}, outbound alias hits {verify.alias_hits}, inbound alias hits "
        f"{fan.inbound_alias_hits}, scan gate {fan.gate.batches} batches of {fan.gate.scans} scans, "
        f"selection seam {fan.select_hook.calls} calls, {len(churn)} members churned and {GROUP_MEMBERS} "
        f"subscribed to {audit}, folds {folds}; {card}")
    log(f"  cfg4 launches: flat_probe_ranges {launches['flat_probe_ranges']}, flat_match_compact "
        f"{launches['flat_match_compact']}, scatter_rows {launches['scatter_rows']} (the fold); "
        f"phase {time.perf_counter() - t_phase:.1f} s; {card}")
    check(folds >= 1, "cfg4: the churn was not folded")
    if on_cuda:
        check(rows[1]["launches"]["flat_probe_ranges"] + rows[1]["launches"]["flat_match_compact"] > 0,
              f"cfg4: the second wave launched neither flat_probe_ranges nor flat_match_compact: {launches}")
        check(launches["scatter_rows"] > 0, "cfg4: the fold did not launch scatter_rows")
    check(fan.select_hook.calls > 0, "cfg4: the selection seam was never called")
    check(fan.dropped == 0, f"cfg4: {fan.dropped} deliveries refused")
    return launches


# -- the predicate path (cfgP) and the re-encryption path (cfgR) ---------------


def cfgP_entries(n_subs: int, rng: random.Random, predicated_only: bool = False):
    """cfg2's population (bench.py:172) with predicates: every 10th filter
    carries a distinct ``$GT{v:t}``, t uniform in [0, 1) (bench.py cfg9,
    849-870, at its full 100,000 rules for 1M filters); filters 1, 3 and 7
    of every thousand carry a distinct ``$CONTAINS{x<k>y}``,
    ``$EQS{s:w<k>}`` or ``$AND{$GT{v:a}$LT{v:b}}``; and HOT_TOPIC has 64
    subscribers holding ``$MEAN{v:32}``, ``$MAX{v:32}`` or ``$MIN{v:64}``."""
    from mqtt_tpu_torch import Subscription

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
        if predicated_only and not pred:
            continue
        preds = (pred,) if pred else ()
        suffixes.extend(preds)
        entries.append((f"cl{i}", Subscription(filter="/".join(parts), qos=i % 3, predicates=preds)))
    for k in range(64):
        pred = ("$MEAN{v:32}", "$MAX{v:32}", "$MIN{v:64}")[k % 3]
        suffixes.append(pred)
        entries.append((f"agg{k}", Subscription(filter=HOT_TOPIC, qos=1, predicates=(pred,))))

    def topic_gen():
        return f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"

    return entries, topic_gen, suffixes


def build_cfgP(n_subs: int, rng: random.Random):
    """cfgP's subscriptions in a trie (``cfgP_entries``)."""
    from mqtt_tpu_torch import TopicsIndex

    entries, topic_gen, suffixes = cfgP_entries(n_subs, rng)
    index = TopicsIndex()
    index.subscribe_bulk(entries)
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


@contextlib.contextmanager
def timed_ticks():
    """While open, time each ``agg_reduce_batch`` call the predicate
    engines make (they import it at the call) on the host clock: yields
    the list it fills with (windows, samples, seconds) a tick."""
    from mqtt_tpu_torch.ops import predicates as pops

    call = pops.agg_reduce_batch
    ticks: list = []

    def timed(pending, device):
        t0 = time.perf_counter()
        out = call(pending, device)
        ticks.append((len(pending), sum(len(v) for _op, v in pending), time.perf_counter() - t0))
        return out

    pops.agg_reduce_batch = timed
    try:
        yield ticks
    finally:
        pops.agg_reduce_batch = call


def agg_tick_summary(ticks) -> str:
    """One line on the window-reduction ticks an engine sent to the card
    (``timed_ticks``): count, shapes and the wall of the
    ``agg_reduce_batch`` call a tick."""
    if not ticks:
        return "no window reduction on the card"
    walls = [w for _n, _s, w in ticks]
    shapes: dict = {}
    for n, samples, _w in ticks:
        shapes[(n, samples)] = shapes.get((n, samples), 0) + 1
    return (f"{len(ticks)} ticks reduced on the card (windows x samples: "
            + ", ".join(f"{n} x {smp} {c} times" for (n, smp), c in sorted(shapes.items()))
            + f"), agg_reduce_batch {sum(walls) / len(walls) * 1e6:.1f} us a tick mean, p50 "
            f"{_pct(walls, 0.5) * 1e6:.1f} us, max {max(walls) * 1e6:.1f} us (host clock)")


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


def phase_predicates(cfg: dict, wave: int, n_waves: int = PREDICATE_WAVES) -> dict:
    """cfgP's main path (launch counts reset just before): ``n_waves``
    waves of ``wave`` JSON publishes through ``MatchStage`` with the predicate
    engine attached (fixed batch of 4096, no budget), then ``apply`` in
    submission order; each result and emission held against the
    reference."""
    from mqtt_tpu_torch import MatchStage, subscribers_equal
    from mqtt_tpu_torch.ops import kernels

    index, dm, eng, rng, gen = cfg["index"], cfg["dm"], cfg["eng"], cfg["rng"], cfg["topic_gen"]
    on_cuda = dm.snapshot.device.type == "cuda"
    ref = PredicateReference(index)
    waves = []
    for _ in range(n_waves):
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
    with timed_ticks() as ticks:
        asyncio.run(drive())
    launches = dict(kernels.LAUNCHES)
    g = eng.gauges()
    n = n_waves * wave
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
    log(f"  cfgP windows: {agg_tick_summary(ticks)}")
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


def agg_ticks(g) -> dict:
    """The window reductions a tick hands ``agg_reduce_batch``, as
    ``(op, samples)`` lists: 64 windows of 64 samples, and the hot topic's
    two ticks (its 64 holders keep ``$MEAN``/``$MAX`` windows of 32 and
    ``$MIN`` windows of 64: 43 windows complete every 32 publishes, and all
    64 every 64)."""
    from mqtt_tpu_torch.ops.predicates import OP_MAX, OP_MEAN, OP_MIN

    ops = [(OP_MEAN, OP_MAX, OP_MIN)[k % 3] for k in range(64)]

    def tick(lengths):
        return [(op, [float(x) for x in g.random(n)]) for op, n in zip(ops, lengths)]

    return {"64 x 64": tick([64] * 64), "43 x 32": tick([32] * 43),
            "43 x 32 + 21 x 64": tick([64 if k % 3 == 2 else 32 for k in range(64)])}


def agg_tick_walls(agg_reduce_batch, pending: list, device, n: int = 200) -> list:
    """Host seconds of ``n`` calls of ``agg_reduce_batch`` on one tick,
    after five to warm up."""
    for _ in range(5):
        agg_reduce_batch(pending, device)
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        agg_reduce_batch(pending, device)
        walls.append(time.perf_counter() - t0)
    return walls


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
        return row

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

    # K5 on the ragged layout: the hot topic's tick, 64 windows of 32 or
    # 64 samples, a tenth of them NaN (the main shape); 37 windows of 1 to
    # 90 samples (W not a power of two) whose first is all NaN; and the
    # launch floor, one window of one sample
    def agg_case(what, windows, ops, main=False):
        W = len(windows)
        buf = torch.from_numpy(pops.pack_windows(windows, ops)).to(device)
        got = pops.agg_reduce(buf, W).cpu().numpy()
        want = pops.agg_reduce_plain(buf, W).cpu().numpy()
        exact = ops != pops.OP_MEAN
        check(np.array_equal(got[exact].view(np.uint32), want[exact].view(np.uint32)),
              f"agg_reduce {what}: MAX/MIN differ from the plain version")
        check((np.abs(got - want) <= MEAN_TOL * np.maximum(1.0, np.abs(want))).all(),
              f"agg_reduce {what}: MEAN outside its tolerance")
        finite = np.isfinite(want)
        err = float(np.abs(got[finite] - want[finite]).max()) if finite.any() else 0.0
        check(np.array_equal(np.isfinite(got), finite), f"agg_reduce {what}: infinities differ")
        n = buf.numel() - (3 * W + 1)
        return timed("agg_reduce", f"{what} W={W} samples={n}", lambda: pops.agg_reduce(buf, W),
                     lambda: pops.agg_reduce_plain(buf, W), buf.numel() * 4 + W * 4, 4 * n, err, main,
                     plain_iters=iters)

    W, N = 64, 64
    lengths = np.where(np.arange(W) % 3 == 2, 64, 32)
    ops = np.array([(pops.OP_MEAN, pops.OP_MAX, pops.OP_MIN)[k % 3] for k in range(W)], np.int32)
    hot = [g.random(n, dtype=np.float32) for n in lengths]
    for v in hot:
        v[g.random(v.shape[0]) < 0.1] = np.nan
    agg_case("the hot tick", hot, ops, main=True)
    ragged = [g.normal(scale=40.0, size=int(g.integers(1, 91))).astype(np.float32) for _ in range(37)]
    ragged[0][:] = np.nan
    for v in ragged[1:]:
        v[g.random(v.shape[0]) < 0.2] = np.nan
    agg_case("ragged", ragged, g.integers(pops.OP_MEAN, pops.OP_MIN + 1, 37).astype(np.int32))
    floor = agg_case("the launch floor", [np.ones(1, np.float32)], np.array([pops.OP_MAX], np.int32))
    log(f"    agg_reduce: the launch floor (one window of one sample) is {floor['ms']:.4f} ms, the hot tick's "
        f"bound {rec['agg_reduce']['bound_ms']:.7f} ms: the kernel sits at the floor")
    if on_cuda:
        # the wall of the whole call a tick (pack, one copy in, K5, one copy
        # out, one event wait) at W = N = 64 and at the two tick shapes of
        # the hot topic's holders (cfgP, broker-legs)
        for what, pending in agg_ticks(g).items():
            walls = agg_tick_walls(pops.agg_reduce_batch, pending, device)
            # the host's share: packing the tick's Python floats into the layout
            windows, ops_t = [v for _, v in pending], np.array([op for op, _ in pending], np.int32)
            packs = agg_tick_walls(lambda *_a: pops.pack_windows(windows, ops_t), pending, device)
            log(f"    agg_reduce_batch {what} ({len(pending)} windows, {sum(len(v) for v in windows)} samples): "
                f"{sum(walls) / len(walls) * 1e6:.1f} us a tick mean, p50 {_pct(walls, 0.5) * 1e6:.1f} us, of which "
                f"pack_windows p50 {_pct(packs, 0.5) * 1e6:.1f} us ({len(walls)} calls each, host clock)")

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


# -- the broker itself (phase broker) ----------------------------------------

BROKER_SESSIONS = 1024  # phase entry: persistent sessions restored, then reconnected
# phase entry's eight publishers: (protocol version, QoS)
BROKER_PUBLISHERS = ((4, 0), (4, 1), (5, 0), (5, 1), (4, 0), (4, 1), (5, 0), (5, 1))
BROKER_CHURN = 300  # SUBSCRIBE and UNSUBSCRIBE packets between phase entry's waves
PRED_WAVE = 8192  # the legs cell's predicated publishes, beside HOT_PER_WAVE hot-topic ones
PRED_HOLDERS = 100  # connections that SUBSCRIBE cfgP's $GT rules, about 1,000 filters each
PRED_PER_PACKET = 250  # filters per SUBSCRIBE packet
BROKER_RECRYPT = 4096  # bench.py cfg10: encrypted publishes of 256 B
RET_SEALED = 64  # the tenant's encrypted retained messages, re-sealed at the re-key
LEGS_CELL = "broker-legs"
CHURN_PID = 0xFFF0  # the churn's packet ids: above every id the broker gives a session's deliveries here
LEGS_WINDOW = 63  # the legs' matcher window: ids a filter path holds on the card (default 16, at most 63)


class _Cfg2Wave:
    """One wave of cfg2 topics from the eight ``BROKER_PUBLISHERS``, round
    robin: each publisher's frames (payloads tagged with ``tag``), how many
    each sends, and each session's expected multiset of (topic, QoS,
    payload) by cfg2's rule (a topic's matches are its exact filter and
    its three one-``+`` ones) over the filters ``held`` (filter ->
    [(client id, QoS)]), at the lesser QoS; and each publish's recipients,
    so a publish the overload governor shed is accounted for."""

    # seconds without a byte to a session after which its deliveries are
    # taken as they stand (a shed publish delivers nothing)
    STALL_S = 15.0

    def __init__(self, topics: list, tag: bytes, held: dict, clients: dict, pubs: list) -> None:
        from collections import Counter

        self.clients, self.pubs = clients, pubs
        self.exp = {cid: Counter() for cid in clients}
        self.bufs = [bytearray() for _ in pubs]
        self.n_pub = [0] * len(pubs)
        self.recipients: dict = {}  # payload -> the sessions it reaches
        self.v5_qos1: dict = {}  # (publisher, packet id) -> payload of a v5 QoS 1 publish
        for i, t in enumerate(topics):
            k = i % len(pubs)
            v, q = BROKER_PUBLISHERS[k]
            payload = tag + b"p%dn%d" % (k, i)
            pid = self.n_pub[k] % 65535 + 1 if q else 0
            self.bufs[k] += publish_frame(t, payload, q, pid, version=v)
            self.n_pub[k] += 1
            if v == 5 and q:
                self.v5_qos1[(k, pid)] = payload
            a, b, c = t.split("/")
            to = self.recipients[payload] = set()
            for f in (t, f"+/{b}/{c}", f"{a}/+/{c}", f"{a}/{b}/+"):
                for cid, sq in held.get(f, ()):
                    self.exp[cid][(t, min(q, sq), payload)] += 1
                    to.add(cid)

    async def send(self) -> float:
        """Send every publisher's frames; the seconds until every QoS 1
        publisher holds its acks (every publish is acked, shed or not) and
        every session its expected deliveries, or has had none for
        ``STALL_S``."""
        self.off = {cid: len(c.frames()) for cid, c in self.clients.items()}
        self.pub_off = [len(c.frames()) for c in self.pubs]
        t0 = time.perf_counter()
        for c, buf in zip(self.pubs, self.bufs):
            c.send(bytes(buf))
        for k, c in enumerate(self.pubs):
            if BROKER_PUBLISHERS[k][1]:
                await c.wait_frames(self.pub_off[k] + self.n_pub[k], 300.0)
        for cid, c in self.clients.items():
            await c.wait_frames(self.off[cid] + sum(self.exp[cid].values()), 300.0, stall=self.STALL_S)
        return time.perf_counter() - t0

    def check(self, what: str, sheds: int) -> dict:
        """Every socket's frames are its expected multiset, apart from the
        publishes the governor shed (``sheds``, its counter's rise over the
        wave): such a publish reached none of its sessions, a v5 QoS 1 one
        was acked 0x97, and every publish missing everywhere is counted in
        ``sheds`` (a shed publish no session holds is seen in the counter
        alone). Every QoS 1 publish got its PUBACK and nothing else. The
        accounting: the counts of shed publishes by what shows them."""
        from collections import Counter

        bad = 0
        missing: dict = {}
        for cid, c in self.clients.items():
            got = Counter((p["topic"], p["qos"], p["payload"]) for p in _publishes(c, self.off[cid]))
            extra, short = got - self.exp[cid], self.exp[cid] - got
            for (_t, _q, payload) in short:
                missing.setdefault(payload, set()).add(cid)
            if extra:
                bad += 1
                if bad <= 3:
                    log(f"  {cid}: got {sorted(extra)[:3]} beyond the stored filters' matches")
        partial = [p for p, cids in missing.items() if cids != self.recipients[p]]
        for p in partial[:3]:
            log(f"  {p!r} missing at {len(missing[p])} of its {len(self.recipients[p])} sessions")
        check(bad == 0 and not partial,
              f"{what}: {bad} sockets hold frames beyond their filters' matches, {len(partial)} publishes reached "
              f"part of their sessions")
        refused = set()
        for k, c in enumerate(self.pubs):
            acks = c.frames()[self.pub_off[k]:]
            n = self.n_pub[k] if BROKER_PUBLISHERS[k][1] else 0
            check(len(acks) == n and all(f[0] == 0x40 for f in acks),
                  f"{what}: publisher {k} got {len(acks)} frames for {self.n_pub[k]} publishes")
            for f in acks:
                if len(f) > 4 and f[4] == 0x97:  # a v5 PUBACK's reason code
                    refused.add(self.v5_qos1[(k, int.from_bytes(f[2:4], "big"))])
        shed = set(missing)
        unseen = sum(1 for to in self.recipients.values() if not to)
        check(refused <= shed and shed & set(self.v5_qos1.values()) <= refused,
              f"{what}: the 0x97 PUBACKs ({len(refused)}) are not the undelivered v5 QoS 1 publishes")
        check(len(shed) <= sheds <= len(shed) + unseen,
              f"{what}: {len(shed)} publishes undelivered, the governor counted {sheds} sheds")
        return {"sheds": sheds, "undelivered": len(shed), "refused_0x97": len(refused)}


def _raise_nofile(want: int) -> int:
    """This process's open-file limit, raised toward ``want`` (within the
    hard limit): every session is two sockets of this process."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < want:
        soft = want if hard == resource.RLIM_INFINITY else min(want, hard)
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
    return soft


def _sub_record(cid: str, flt: str, qos: int) -> bytes:
    """The bytes ``hooks.storage.base.dumps`` writes for a plain
    subscription record (checked against ``dumps`` on a sample): the store
    of a million records is made in bulk."""
    return ('{"t": "SUB", "client": %s, "filter": %s, "identifier": 0, "retain_handling": 0, "qos": %d, '
            '"retain_as_published": false, "no_local": false, "predicates": []}'
            % (json.dumps(cid), json.dumps(flt), qos)).encode()


def _hot_sessions(entries, waves: list, n_sessions: int) -> tuple:
    """The ``n_sessions`` cfg2 client ids the trie walk hits most often on
    the waves' topics (cfg2's filters have 3 levels and at most one '+', so
    a topic's matches are its exact filter and its three one-'+' ones),
    and the hit counts."""
    from collections import Counter

    by_filter: dict = {}
    for cid, sub in entries:
        by_filter.setdefault(sub.filter, []).append(cid)
    hits: Counter = Counter()
    for topics in waves:
        for t in topics:
            a, b, c = t.split("/")
            for f in (t, f"+/{b}/{c}", f"{a}/+/{c}", f"{a}/{b}/+"):
                for cid in by_filter.get(f, ()):
                    hits[cid] += 1
    sessions = [cid for cid, _n in sorted(hits.items(), key=lambda kv: (-kv[1], int(kv[0][2:])))[:n_sessions]]
    return sessions, hits


def _session_record(cid: str, version: int) -> bytes:
    """A persistent session's stored client record: v4 ``clean=0``, v5
    with a session expiry of an hour."""
    from mqtt_tpu_torch.hooks.storage import Client as SClient, ClientProperties
    from mqtt_tpu_torch.hooks.storage.base import dumps

    v5 = version == 5
    return dumps(SClient(id=cid, listener="t", clean=False, protocol_version=version,
                         properties=ClientProperties(session_expiry_interval=3600 if v5 else 0,
                                                     session_expiry_interval_flag=v5)))


async def _serve(srv) -> tuple:
    """``serve()`` (the restore included) with the cyclic collector off;
    the listener's address and the seconds serve took."""
    gc.disable()
    try:
        t0 = time.perf_counter()
        await srv.serve()
        dt = time.perf_counter() - t0
    finally:
        _settle_gc()
    host, port = srv.listeners.get("t").address().rsplit(":", 1)
    return host, int(port), dt


async def _connect_all(clients: list, host: str, port: int, frames: list, limit: float = 120.0) -> list:
    """Open every client, send its CONNECT; every client's CONNACK."""
    for c, f in zip(clients, frames):
        await c.open(host, port)
        c.send(f)
    out = []
    for c in clients:
        got = await c.wait_frames(1, limit)
        check(got and got[0][0] == 0x20 and got[0][3] == 0,
              f"{c.name}: CONNACK {bytes(got[0]) if got else None!r}")
        out.append(got[0])
    return out


# each device matcher's fold calls so far (time_folds): host seconds of
# those that folded, and the count and seconds of those that gave up (a
# full rebuild follows them)
FOLD_WALL: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def time_folds() -> None:
    """Time every ``TorchMatcher.fold`` from here on, on the host clock,
    into ``FOLD_WALL`` by matcher: the trie's walk, the K3 launch and the
    swap (the harness's timer; the matcher keeps only ``rebuild_seconds``,
    folds and rebuilds together)."""
    from mqtt_tpu_torch.ops.matcher import TorchMatcher

    fold = TorchMatcher.fold
    if getattr(fold, "timed", False):
        return

    @functools.wraps(fold)
    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        ok = False
        try:
            ok = fold(self, *args, **kwargs)
            return ok
        finally:
            w = FOLD_WALL.setdefault(self, [0.0, 0, 0.0])
            if ok:
                w[0] += time.perf_counter() - t0
            else:
                w[1] += 1
                w[2] += time.perf_counter() - t0

    timed.timed = True
    TorchMatcher.fold = timed


def fold_summary(m) -> str:
    """A ``DeltaMatcher``'s folds so far: how many, their wall seconds
    (``time_folds``), the calls that gave up to a rebuild, and how many
    folds found the standby buffer held by a batch and copied the live
    table."""
    st = m.stats
    ok_s, n_gave_up, gave_up_s = FOLD_WALL.get(m.snapshot, (0.0, 0, 0.0))
    return (f"{st.folds} folds in {ok_s:.3f} s ({n_gave_up} calls gave up to a rebuild, {gave_up_s:.3f} s), "
            f"fold_copies {st.fold_copies}")


async def _await_fold(dm, what: str, limit: float = 600.0) -> float:
    t0 = time.perf_counter()
    while dm.pending_deltas:
        check(time.perf_counter() - t0 < limit, f"{what}: the overlay was not folded within {limit} s")
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


async def _await_idle(srv) -> None:
    """The stage holds nothing and every outbound queue is drained."""
    st = srv._stage
    for _ in range(20000):
        busy = st is not None and (st._pending or st.inflight_batches)
        if not busy and all(cl.state.outbound.empty() for cl in srv.clients.get_all().values()):
            break
        await asyncio.sleep(0.005)
    await asyncio.sleep(0.1)


def _publishes(c, start: int) -> list:
    """The PUBLISH frames of ``c``'s current connection from frame
    ``start`` on, parsed."""
    return [parse_publish(f, c.version) for f in c.frames()[start:] if f[0] >> 4 == 3]


def _stage_split(srv, batches0: int) -> str:
    log_ = list(srv._stage.service_log)[batches0:]
    if not log_:
        return "stage 0 batches"
    res = sorted(dt for _n, dt in log_)
    return (f"stage {len(log_)} batches (mean {sum(n for n, _ in log_) / len(log_):.1f} publishes), "
            f"resolve p50 {_exact_pct(res, 0.5) * 1e3:.3f} ms max {res[-1] * 1e3:.3f} ms")


def _route_counts(dm) -> dict:
    """The matcher's counters and, behind the breaker, the topics its
    fallback batches answered from the walk."""
    out = dict(dm.stats.as_dict())
    out["breaker"] = dm.breaker_gauges()["fallback_topics"] if hasattr(dm, "breaker_gauges") else 0
    return out


def route_split(d: dict) -> dict:
    """Publishes resolved by the device and by each host route, from the
    deltas of the matcher's counters and the breaker's fallback topics:
    the delta overlay, device-side overflow (spilled, saturated,
    over-deep), the exact map and the breaker. A batch the breaker answers
    from the walk may already be in the wrapped matcher's ``topics`` (a
    ``corrupt`` verdict counts it there first), so the device's share
    leaves the breaker's topics out: it is never overstated."""
    return {"device": d["topics"] - d["host_fallbacks"] - d["host_fast"] - d["breaker"],
            "overlay": d["host_fallbacks"] - d["overflows"], "overflow": d["overflows"], "exact_map": d["host_fast"],
            "breaker": d["breaker"]}


def _routes(dm, stage, stats0: dict, fb0: dict) -> dict:
    """``route_split`` since ``stats0`` (``_route_counts``), and the
    stage's own routes since ``fb0``."""
    st = _route_counts(dm)
    out = route_split({k: st[k] - stats0[k] for k in ("topics", "host_fallbacks", "overflows", "host_fast",
                                                      "breaker")})
    for k, v in stage.fallbacks.items():
        out["stage_" + k] = v - fb0.get(k, 0)
    out["stage_admission"] = out.get("stage_admission", 0)
    return out


def breaker_summary(g: dict, what: str, card: str) -> None:
    """Log a breaker's gauges (``ResilientMatcher.breaker_gauges``, or the
    same rows read over ``$SYS``) and fail on any failure of any kind, any
    trip, any batch answered from the walk (``fallback_batches``: a
    failure, a ``corrupt`` verdict of the verify sample or a saturated
    guard pool) and a state other than closed. A trip that probes closed
    again, or a ``corrupt`` batch the walk answered, would hide a kernel's
    fault behind correct frames; no phase passes with one."""
    kinds = {k[len("failures_"):]: int(v) for k, v in g.items() if k.startswith("failures_") and int(v)}
    log(f"  {what} breaker: state {g['state']}, failures {g['failures']}, failure kinds {kinds or 'none'}, "
        f"fallback_batches {g['fallback_batches']}, fallback_topics {g['fallback_topics']}, verified_batches "
        f"{g['verified_batches']}, trips {g['trips']}, probes {g['probes']}, wedged_workers "
        f"{g['wedged_workers']}; {card}")
    check(not kinds and int(g["failures"]) == 0, f"{what}: the breaker counted failures: {kinds}")
    check(int(g["trips"]) == 0, f"{what}: the breaker tripped {g['trips']} times")
    check(int(g["fallback_batches"]) == 0,
          f"{what}: the breaker answered {g['fallback_batches']} batches ({g['fallback_topics']} topics) from the walk")
    check(str(g["state"]) == "closed", f"{what}: the breaker is {g['state']}, not closed")


def phase_broker_legs(torch, device, card: str, n_subs: int = N_SUBS, n_retained: int = RETAINED_SIZES[0],
                      n_recrypt: int = BROKER_RECRYPT, pred_wave: int = PRED_WAVE, planes: bool = True) -> dict:
    """Cell ``broker-legs``: the engines at their call sites in the port's
    ``Server``, over TCP.

    Predicates (one server): cfgP's ``$GT`` rules arrive as predicated
    SUBSCRIBE filters from ``PRED_HOLDERS`` connections and the 64
    aggregation windows from 64 more; its ``$CONTAINS``, ``$EQS`` and
    ``$AND`` rules are restored from the store for three persistent
    sessions (``load_subscriptions`` re-registers them), which reconnect.
    ``pred_wave`` JSON publishes and the hot topic's ``HOT_PER_WAVE``; every
    delivery must be the trie's selection filtered by the host interpreter,
    every aggregate the plain windows' (K4, K5).

    Tenancy and retained (a second server, ``tenancy`` on with
    ``retained_matcher``): cfg11's ``n_retained`` retained messages restored
    through ``load_retained`` -> ``bulk_retain`` -> ``reseed()``; cfg11's 64
    wildcard filters SUBSCRIBEd over TCP, every retained delivery the
    trie's retained walk (K1 run in reverse). cfgR's tenant as bench.py's
    ``run_cfg10`` builds it (encrypted ``e/``, a publisher and 100 keyed
    subscribers, the device threshold): ``RET_SEALED`` encrypted retained
    messages, delivered re-keyed at SUBSCRIBE, then ``n_recrypt`` encrypted
    publishes of 256 B; every payload must open under its subscriber's key
    to the plaintext (K6). Then ``rekey_tenant`` re-seals the retained
    payloads through ``reseal_batch`` (K6), each opening under the new key.
    ``planes=False`` runs both servers without their default planes
    (``PLANES_OFF``)."""
    from collections import Counter

    import numpy as np
    from mqtt_tpu_torch.hooks.auth import AllowHook
    from mqtt_tpu_torch.hooks.storage import (
        CLIENT_KEY, RETAINED_KEY, SUBSCRIPTION_KEY, Client as SClient, Message, Subscription as SSub)
    from mqtt_tpu_torch.hooks.storage.base import dumps
    from mqtt_tpu_torch.hooks.storage.memory import MemoryStore
    from mqtt_tpu_torch.listeners import TCP, Config
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.ops import recrypt as rops
    from mqtt_tpu_torch.predicates import OP_MAX, OP_MEAN
    from mqtt_tpu_torch.server import Options, Server

    t_phase = time.perf_counter()
    _raise_nofile(1024)
    kernels.reset_launches()
    info: dict = {}

    # -- predicates ----------------------------------------------------------
    rng = random.Random(9)
    gc.disable()
    try:
        entries, topic_gen, _sfx = cfgP_entries(n_subs, rng, predicated_only=True)
    finally:
        _settle_gc()
    restored = {"$CONTAINS": "pc", "$EQS{": "pe", "$AND": "pa"}
    store = MemoryStore()
    gt_holders: dict = {}
    agg = []
    n_rest = 0
    for cid, sub in entries:
        pred = sub.predicates[0]
        if cid.startswith("agg"):
            agg.append((cid, sub))
            continue
        holder = next((h for pfx, h in restored.items() if pred.startswith(pfx)), None)
        if holder is not None:
            store.data[SUBSCRIPTION_KEY + "_" + holder + ":" + sub.filter] = dumps(
                SSub(client=holder, filter=sub.filter, qos=sub.qos, predicates=[pred]))
            n_rest += 1
        else:
            gt_holders.setdefault(f"g{(int(cid[2:]) // 10) % PRED_HOLDERS}", []).append(sub.filter + pred)
    for holder in restored.values():
        store.data[CLIENT_KEY + "_" + holder] = dumps(SClient(id=holder, listener="t", protocol_version=4))
    n_gt = sum(len(v) for v in gt_holders.values())
    del entries
    # a window of 63 ids a filter path (the default 16 leaves a path with
    # more holders to the host): the hot topic's 64 window holders split
    # over two filter paths, HOT_TOPIC and its middle level wildcarded
    off = {} if planes else PLANES_OFF
    srvP = Server(Options(device_matcher=True, matcher_opts={"window": LEGS_WINDOW}, device=str(device), **off))
    srvP.add_hook(AllowHook())
    srvP.add_hook(store)
    srvP.add_listener(TCP(Config(type="tcp", id="t", address="127.0.0.1:0")))

    async def drive_predicates():
        host, port, t_serve = await _serve(srvP)
        eng = srvP._predicates
        info["p_restore"] = (t_serve, dict(srvP._durable), eng.rule_count)
        holders = {h: WireClient(h, 4) for h in sorted(gt_holders)}
        aggs = {cid: WireClient(cid, 4) for cid, _s in agg}
        back = {h: WireClient(h, 4) for h in restored.values()}
        pub = WireClient("ppub", 4)
        every = list(holders.values()) + list(aggs.values())
        await _connect_all(every + list(back.values()) + [pub], host, port,
                           [connect_frame(c.name, 4) for c in every]
                           + [connect_frame(c.name, 4, clean=False) for c in back.values()]
                           + [connect_frame("ppub", 4)])
        t0 = time.perf_counter()
        n_packets = 0
        for h, c in holders.items():
            flts = gt_holders[h]
            for j in range(0, len(flts), PRED_PER_PACKET):
                c.send(subscribe_frame(j // PRED_PER_PACKET + 1, [(f, 1, 0) for f in flts[j:j + PRED_PER_PACKET]]))
                n_packets += 1
        for k, (cid, sub) in enumerate(agg):
            flt = sub.filter if k % 2 == 0 else HOT_TOPIC.replace("/agg/", "/+/")
            aggs[cid].send(subscribe_frame(1, [(flt + sub.predicates[0], 1, 0)]))
            n_packets += 1
        for h, c in holders.items():
            await c.wait_frames(1 + -(-len(gt_holders[h]) // PRED_PER_PACKET), 600.0)
        for c in aggs.values():
            await c.wait_frames(2, 600.0)
        t_sub = time.perf_counter() - t0
        fold = await _await_fold(srvP.matcher, LEGS_CELL + " predicates")
        info["p_sub"] = (n_packets, t_sub, fold, eng.rule_count)
        ref = PredicateReference(srvP.topics)
        exp = {c.name: Counter() for c in every + list(back.values())}
        emits = {cid: [] for cid in aggs}
        buf = bytearray()
        total = pred_wave + HOT_PER_WAVE
        hot_at = {j * total // HOT_PER_WAVE for j in range(HOT_PER_WAVE)}  # the hot topic, spread evenly
        n_pub = 0
        for i in range(total):
            topic = HOT_TOPIC if i in hot_at else topic_gen()
            payload = cfgP_payload(rng)
            buf += publish_frame(topic, payload)
            n_pub += 1
            subs, done = ref.expect(topic, payload)
            for cid, sub in subs.subscriptions.items():
                if cid in exp:
                    exp[cid][(topic, 0, payload)] += 1
            for cid, (op, values) in done.items():
                emits[cid].append((op, values))
        off = {c.name: len(c.frames()) for c in every + list(back.values())}
        st, dm = srvP._stage, srvP.matcher
        batches0, stats0, fb0 = len(st.service_log), _route_counts(dm), dict(st.fallbacks)
        g0 = dict(eng.gauges())
        t0 = time.perf_counter()
        pub.send(bytes(buf))
        for c in every + list(back.values()):
            n = sum(exp[c.name].values()) + len(emits.get(c.name, ()))
            await c.wait_frames(off[c.name] + n, 300.0)
        wall = time.perf_counter() - t0
        await _await_idle(srvP)
        bad = 0
        for c in list(holders.values()) + list(back.values()):
            got = Counter((p["topic"], p["qos"], p["payload"]) for p in _publishes(c, off[c.name]))
            bad += got != exp[c.name]
        check(bad == 0, f"{LEGS_CELL} predicates: {bad} sockets' frames differ from the interpreter's selection")
        n_emit = 0
        for cid, c in aggs.items():
            got = [p["payload"] for p in _publishes(c, off[cid])]
            check(len(got) == len(emits[cid]), f"{cid}: {len(got)} aggregates, the windows complete {len(emits[cid])}")
            for payload, (op, values) in zip(got, emits[cid]):
                if op == OP_MEAN:
                    want = sum(values) / len(values)
                    check(abs(float(payload) - want) <= MEAN_TOL * max(1.0, abs(want)), f"{cid}: MEAN {payload!r}")
                else:
                    v32 = [float(np.float32(x)) for x in values]
                    check(payload == b"%.10g" % (max(v32) if op == OP_MAX else min(v32)), f"{cid}: {payload!r}")
                n_emit += 1
        g = eng.gauges()
        n_del = sum(sum(e.values()) for e in exp.values())
        info["p_wave"] = (n_pub, n_del, n_emit, wall, _routes(dm, st, stats0, fb0), _stage_split(srvP, batches0),
                          {k: g[k] - g0.get(k, 0) for k in ("device_decisions", "host_evals", "agg_device_reductions")
                           if k in g}, dict(eng.host_reasons))
        info["p_folds"] = fold_summary(srvP.matcher)
        info["p_breaker"] = srvP.matcher.breaker_gauges()
        info["p_planes"] = planes_summary(srvP) if planes else None
        for c in every + list(back.values()) + [pub]:
            c.send(disconnect_frame(4))
        for c in every + list(back.values()) + [pub]:
            await c.ended(60.0)
        await srvP.close()

    with timed_ticks() as p_ticks:
        asyncio.run(drive_predicates())
    t_serve, dur, rules = info["p_restore"]
    n_packets, t_sub, fold, rules_all = info["p_sub"]
    n_pub, n_del, n_emit, wall, ro, split, dg, reasons = info["p_wave"]
    READINGS["broker-legs predicates publishes/s"] = n_pub / wall
    log(f"phase broker {LEGS_CELL} predicates: restore {dur['recovery_seconds']:.3f} s ({dur['restore_batches']} "
        f"batches, {n_rest} predicated subscriptions, {rules} rules re-registered); {n_gt} $GT and {len(agg)} window "
        f"filters in {n_packets} SUBSCRIBE packets in {t_sub:.3f} s, fold {fold:.3f} s, {rules_all} rules; "
        f"{n_pub} JSON publishes, {n_del} deliveries and {n_emit} aggregates, every one the interpreter's; "
        f"{n_pub / wall:.1f} publishes/s, {(n_del + n_emit) / wall:.1f} deliveries/s (wall {wall:.3f} s); {split}; "
        f"resolved by the device {ro['device']}, by the host: " + ", ".join(f"{k} {v}" for k, v in ro.items()
                                                                        if k != "device")
        + f"; engine {dg}, host reasons {reasons}; {card}")
    log(f"  {LEGS_CELL} windows: {agg_tick_summary(p_ticks)}; matcher {info['p_folds']}; {card}")
    check(ro["device"] > n_pub // 2, f"{LEGS_CELL} predicates: the device resolved {ro['device']} of {n_pub}")

    # -- tenancy, retained and the re-key ------------------------------------
    keys = {"pub": bytes(range(16))}
    for i in range(RECRYPT_FANOUT):
        keys[f"s{i}"] = bytes([i, 255 - i]) * 8
    tenants = {"bt": {"encrypted": ["e/"], "keys": {k: v.hex() for k, v in keys.items()}}}
    users = {k: "bt" for k in keys}
    store = MemoryStore()
    now = int(time.time())
    for i in range(n_retained):
        topic = cfg11_topic(i)
        store.data[RETAINED_KEY + "_" + topic] = dumps(Message(
            t=RETAINED_KEY, id=RETAINED_KEY + "_" + topic, topic_name=topic, payload=b"r%d" % i, retain=True,
            created=now, protocol_version=4))
    # a window of 63 (see srvP): cfg10's 100 subscribers split over two
    # filter paths, e/# and e/+
    srvT = Server(Options(device_matcher=True, matcher_opts={"window": LEGS_WINDOW}, tenancy=True,
                          tenants=tenants, tenant_users=users,
                          recrypt_device_min_blocks=4, retained_matcher=True, device=str(device), **off))
    srvT.add_hook(AllowHook())
    srvT.add_hook(store)
    srvT.add_listener(TCP(Config(type="tcp", id="t", address="127.0.0.1:0")))
    plain_of = {}

    async def drive_tenant():
        host, port, t_serve = await _serve(srvT)
        reng, renc, plane = srvT._retained_engine, srvT._recrypt, srvT._tenancy
        info["t_restore"] = (t_serve, dict(srvT._durable), dict(reng.stats()))
        # retained: cfg11's 64 wildcard filters, one SUBSCRIBE each from
        # its own connection (a retained delivery is queued on the client's
        # outbound queue, maximum_client_writes_pending deep)
        rsubs = [WireClient(f"r{k}", 4) for k in range(len(cfg11_filters()))]
        await _connect_all(rsubs, host, port, [connect_frame(c.name, 4) for c in rsubs])
        want = {c.name: Counter((m.topic_name, bytes(m.payload)) for m in srvT.topics.messages(f))
                for c, f in zip(rsubs, cfg11_filters())}
        k1 = kernels.LAUNCHES["flat_probe_ranges"]
        dm0 = reng.device_matches
        t0 = time.perf_counter()
        for c, f in zip(rsubs, cfg11_filters()):
            c.send(subscribe_frame(1, [(f, 0, 0)]))
        for c in rsubs:
            await c.wait_frames(2 + sum(want[c.name].values()), 300.0)
        t_ret = time.perf_counter() - t0
        await _await_idle(srvT)
        n_ret = 0
        for c in rsubs:
            got = _publishes(c, 2)
            check(all(p["retain"] for p in got) and Counter((p["topic"], p["payload"]) for p in got) == want[c.name],
                  f"{LEGS_CELL} retained: {c.name} got {len(got)} deliveries, the walk's {sum(want[c.name].values())}")
            n_ret += len(got)
        info["retained"] = (n_ret, t_ret, reng.device_matches - dm0,
                            kernels.LAUNCHES["flat_probe_ranges"] - k1, dict(reng.fallbacks))
        # encryption: the publisher's retained sealed messages, then 100
        # keyed subscribers (re-keyed retained delivery at SUBSCRIBE)
        pub = WireClient("pub", 4)
        subs = [WireClient(f"s{i}", 4) for i in range(RECRYPT_FANOUT)]
        await _connect_all([pub], host, port, [connect_frame("pub", 4)])
        buf = bytearray()
        for i in range(RET_SEALED):
            plain = b"retained-%05d-" % i + bytes(range(200))
            plain_of[f"e/r{i}"] = plain
            buf += publish_frame(f"e/r{i}", renc.seal_with_key(keys["pub"], plain), 0, retain=True)
        pub.send(bytes(buf) + PINGREQ_FRAME)
        await pub.wait_frames(2, 120.0)
        await _await_idle(srvT)
        await _connect_all(subs, host, port, [connect_frame(c.name, 4) for c in subs])
        for k, c in enumerate(subs):
            c.send(subscribe_frame(1, [("e/#" if k % 2 == 0 else "e/+", 0, 0)]))
        for c in subs:
            await c.wait_frames(2 + RET_SEALED, 300.0)
        fold = await _await_fold(srvT.matcher, LEGS_CELL + " tenant")
        plaintext = (bytes(range(256)) * 2)[:256]
        bufs = bytearray()
        for i in range(n_recrypt):
            bufs += publish_frame("e/bench", renc.seal_with_key(keys["pub"], plaintext), 1, i % 65535 + 1)
        st, dm = srvT._stage, srvT.matcher
        batches0, stats0, fb0 = len(st.service_log), _route_counts(dm), dict(st.fallbacks)
        g0 = dict(renc.gauges())
        t0 = time.perf_counter()
        pub.send(bytes(bufs))
        for c in subs:
            await c.wait_frames(2 + RET_SEALED + n_recrypt, 300.0)
        await pub.wait_frames(2 + n_recrypt, 300.0)
        wall = time.perf_counter() - t0
        await _await_idle(srvT)
        g = renc.gauges()
        # every payload opened under its subscriber's key by the plain
        # PyTorch AES on the card
        table = plane.keys.table()
        kidx, ctrs, cts, pts = [], [], [], []
        for c in subs:
            kid = plane.keys.key_id("bt", c.name)
            for p in _publishes(c, 2):
                plain = plaintext if p["topic"] == "e/bench" else plain_of[p["topic"]]
                nb = (len(plain) + 15) // 16
                kidx.append(np.full(nb, kid, np.int32))
                ctrs.append(rops.ctr_counters(p["payload"][:12], nb))
                cts.append(np.frombuffer(p["payload"][12:], np.uint8))
                pts.append(np.frombuffer(plain, np.uint8))
        ks = rops.keystream_plain(
            torch.from_numpy(table).to(device), torch.from_numpy(np.concatenate(kidx)).to(device),
            torch.from_numpy(np.concatenate(ctrs)).to(device)).cpu().numpy().reshape(-1)
        pos, bad = 0, 0
        for ct, pt in zip(cts, pts):
            n16 = (len(pt) + 15) // 16 * 16
            bad += not np.array_equal(ct ^ ks[pos:pos + len(ct)], pt)
            pos += n16
        check(bad == 0 and len(cts) == RECRYPT_FANOUT * (RET_SEALED + n_recrypt),
              f"{LEGS_CELL} recrypt: {bad} of {len(cts)} payloads do not open to their plaintext")
        info["recrypt"] = (n_recrypt, len(cts), wall, fold, _routes(dm, st, stats0, fb0),
                           _stage_split(srvT, batches0),
                           {k: g[k] - g0.get(k, 0) for k in ("device_batches", "device_blocks", "host_blocks",
                                                             "fanouts", "no_key_drops", "oracle_mismatches")
                            if k in g}, dict(renc.host_reasons))
        # the re-key: every retained sealed payload re-sealed in one launch
        k6 = kernels.LAUNCHES["keystream"]
        new_keys = {k: bytes(b ^ 0x5A for b in v) for k, v in keys.items()}
        t0 = time.perf_counter()
        out = srvT.rekey_tenant("bt", new_keys)
        t_rekey = time.perf_counter() - t0
        check(out["resealed"] == RET_SEALED, f"{LEGS_CELL} re-key: {out['resealed']} of {RET_SEALED} re-sealed")
        opened = 0
        for topic, plain in plain_of.items():
            m = srvT.topics.retained.get("\x00bt/" + topic)
            opened += renc.open_with_key(new_keys["pub"], bytes(m.payload)) == plain
        check(opened == RET_SEALED, f"{LEGS_CELL} re-key: {opened} of {RET_SEALED} open under the new key")
        info["rekey"] = (out, t_rekey, kernels.LAUNCHES["keystream"] - k6)
        info["t_folds"] = fold_summary(srvT.matcher)
        info["t_breaker"] = srvT.matcher.breaker_gauges()
        info["t_planes"] = planes_summary(srvT) if planes else None
        for c in rsubs + [pub] + subs:
            c.send(disconnect_frame(4))
        for c in rsubs + [pub] + subs:
            await c.ended(60.0)
        await srvT.close()

    asyncio.run(drive_tenant())
    launches = dict(kernels.LAUNCHES)
    t_serve, dur, rstats = info["t_restore"]
    n_ret, t_ret, dmatch, k1, fb = info["retained"]
    log(f"phase broker {LEGS_CELL} retained: restore {dur['recovery_seconds']:.3f} s ({dur['restore_batches']} "
        f"batches, {dur['restored_retained']} retained, reseed); cfg11's 64 filters SUBSCRIBEd on 64 sockets: {n_ret} "
        f"retained deliveries, every one the walk's, in {t_ret:.3f} s; device matches {dmatch}, K1 launches {k1}, "
        f"fallbacks {fb}; {card}")
    n_rc, n_open, wall, fold, ro, split, dg, reasons = info["recrypt"]
    READINGS["broker-legs recrypt publishes/s"] = n_rc / wall
    log(f"phase broker {LEGS_CELL} recrypt: {n_rc} encrypted publishes of 256 B to {RECRYPT_FANOUT} keyed "
        f"subscribers and {RET_SEALED} retained re-keyed at SUBSCRIBE: {n_open} payloads, every one opens to its "
        f"plaintext under its subscriber's key; {n_rc / wall:.1f} publishes/s, {n_rc * RECRYPT_FANOUT / wall:.1f} "
        f"deliveries/s (wall {wall:.3f} s); {split}; resolved by the device {ro['device']}, by the host: "
        + ", ".join(f"{k} {v}" for k, v in ro.items() if k != "device") + f"; engine {dg}, host reasons {reasons}; {card}")
    check(ro["device"] > n_rc // 2, f"{LEGS_CELL} recrypt: the device resolved {ro['device']} of {n_rc}")
    out, t_rekey, k6 = info["rekey"]
    log(f"phase broker {LEGS_CELL} re-key: epoch {out['old_epoch']} -> {out['epoch']}, {out['resealed']} retained "
        f"payloads re-sealed in {t_rekey * 1e3:.3f} ms, {k6} keystream launches, every one opens under the new "
        f"key; the tenant server's matcher {info['t_folds']}; {card}")
    log(f"  {LEGS_CELL} launches in the cell: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; cell {time.perf_counter() - t_phase:.1f} s; {card}")
    breaker_summary(info["p_breaker"], LEGS_CELL + " predicates server", card)
    breaker_summary(info["t_breaker"], LEGS_CELL + " tenant server", card)
    for what, key in (("predicates server", "p_planes"), ("tenant server", "t_planes")):
        pl = info[key]
        if pl is None:
            continue
        log(f"  {LEGS_CELL} {what} planes: {pl['line']}; {card}")
        # every frame above was checked against its selection, so every
        # publish was delivered: the governor shed none
        check(pl["sheds"] == 0, f"{LEGS_CELL} {what}: the governor shed {pl['sheds']} publishes")
    return launches


def planes_summary(srv) -> dict:
    """A ``Server``'s default planes after its waves, read in its process:
    the governor (state, transitions, sheds, throttled reads, CONNECT
    refusals, peak pressures), the sampled publishes by stage, the
    profiler's sweeps and the card's memory and busy share."""
    g = srv.overload.gauges()
    tele = srv.telemetry
    legs = {s: h.count for s, h in tele.stage_hist.items() if h.count}
    card0 = srv.device_stats.snapshot()["devices"][0]
    peaks = {k[len("peak/"):]: v for k, v in g.items() if k.startswith("peak/")}
    line = (f"governor {g['state']}, transitions {g['transitions']}, sheds {g['sheds']}, throttled reads "
            f"{g['throttled']}, CONNECT refusals {g['connects_refused']}, peak pressures {peaks}; sampled publishes by "
            f"stage {legs}; profiler {srv.host_profiler.samples} sweeps; card live {card0['hbm']['live_bytes']} B, "
            f"busy share {card0['duty_cycle']}, idle gap p99 {card0['idle_gap_p99_ms']} ms over {card0['batches']} "
            f"batches")
    return {"sheds": g["sheds"], "line": line}


def phase_broker(torch, device, card: str, n_subs: int = N_SUBS, n_retained: int = RETAINED_SIZES[0],
                 n_recrypt: int = BROKER_RECRYPT, pred_wave: int = PRED_WAVE, planes: bool = True) -> dict:
    """Phase ``broker``: cell ``broker-legs``; K1-K6 must each launch inside
    it. Config 2's restart at full width is phase ``entry``."""
    launches = phase_broker_legs(torch, device, card, n_subs, n_retained, n_recrypt, pred_wave, planes)
    if device.type == "cuda":
        for name in ("flat_probe_ranges", "flat_match_compact", "scatter_rows", "rules_eval", "agg_reduce",
                     "keystream"):
            check(launches[name] > 0, f"phase broker: {name} was not launched inside the phase: {launches}")
    return launches


# -- the broker's own entry point (phase entry) ----------------------------------------

ENTRY_CELL = "entry-cfg2"
ENTRY_SEED = 12  # cfg2's generator for the entry cell's records and waves
# of the entry cell's eight publishers (``BROKER_PUBLISHERS``), the first
# four send over TCP and the last four over WebSocket
ENTRY_WS_PUBLISHERS = 4


def entry_fill(path: str, n_subs: int, n_sessions: int, wave: int) -> None:
    """Write phase ``entry``'s store: a ``LogKVStore`` in ``path`` holding
    config 2's ``n_subs`` subscription records (``cfg2_entries``, seed
    ``ENTRY_SEED``) and ``n_sessions`` persistent sessions
    (the ids the waves' topics hit most), written through the store's own
    ``_set`` with fsync off, then ``snapshot()``; and beside it
    ``<path>.json``: the sessions, the waves' topics and the walls. Runs in
    a process of its own, started at the beginning of the script."""
    from mqtt_tpu_torch.hooks.storage import CLIENT_KEY, Subscription as SSub
    from mqtt_tpu_torch.hooks.storage.base import dumps
    from mqtt_tpu_torch.hooks.storage.logkv import LogKVOptions, LogKVStore

    gc.disable()
    t0 = time.perf_counter()
    entries, topic_gen = cfg2_entries(n_subs, random.Random(ENTRY_SEED))
    waves = [[topic_gen() for _ in range(wave)] for _ in range(2)]
    sessions, _hits = _hot_sessions(entries, waves, n_sessions)
    t_gen = time.perf_counter() - t0
    store = LogKVStore()
    store.init(LogKVOptions(path=path, gc_interval=0, durability_fsync="off"))
    t0 = time.perf_counter()
    chosen = dict.fromkeys(sessions)
    for k, (cid, sub) in enumerate(entries):
        rec = _sub_record(cid, sub.filter, sub.qos)
        if k < 1000 and rec != dumps(SSub(client=cid, filter=sub.filter, qos=sub.qos)):
            raise PhaseFailed(f"{ENTRY_CELL}: the bulk record of {cid} is not dumps'")
        store._set("SUB_" + cid + ":" + sub.filter, rec)
        if cid in chosen:
            chosen[cid] = (sub.filter, sub.qos)
    for k, cid in enumerate(sessions):
        store._set(CLIENT_KEY + "_" + cid, _session_record(cid, 5 if k % 2 else 4))
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.snapshot()
    t_snap = time.perf_counter() - t0
    n_keys = len(store._map)
    store.stop()
    size = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
    meta = {"sessions": [[cid, *chosen[cid], 5 if k % 2 else 4] for k, cid in enumerate(sessions)],
            "waves": waves, "subs": n_subs, "keys": n_keys, "bytes": size, "gen_s": t_gen, "fill_s": t_fill, "snapshot_s": t_snap}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def start_entry_fill(n_subs: int, n_sessions: int, wave: int) -> dict:
    """Start ``entry_fill`` in a process of its own (the store's fill is
    host work, kept off the earlier phases' clock); phase ``entry`` waits
    for it."""
    import tempfile

    root = tempfile.mkdtemp(prefix="mqtt-torch-entry-")
    path = os.path.join(root, "store")
    log_path = os.path.join(root, "fill.log")
    code = (f"import chip_smoke; chip_smoke.entry_fill({path!r}, {n_subs}, {n_sessions}, {wave})")
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE, stdout=out, stderr=subprocess.STDOUT)
    return {"root": root, "path": path, "proc": proc, "log": log_path, "t0": time.perf_counter()}


def fill_copy(fill: dict, suffix: str) -> str:
    """Wait for the fill and copy its store beside it (``<path><suffix>``)."""
    import shutil

    try:
        fill["proc"].wait(timeout=1500)
    except subprocess.TimeoutExpired:
        raise PhaseFailed(f"{ENTRY_CELL}: the store's fill did not end") from None
    check(fill["proc"].returncode == 0, f"{ENTRY_CELL}: the store's fill failed:\n{_tail(fill['log'])}")
    dst = fill["path"] + suffix
    shutil.copytree(fill["path"], dst)
    return dst


def stop_entry_fill(fill: dict) -> None:
    """End the fill process if it still runs and remove its directory."""
    import shutil

    proc = fill["proc"]
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    shutil.rmtree(fill["root"], ignore_errors=True)


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-n:].decode("utf-8", "replace")
    except OSError:
        return ""


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class SysRows:
    """A client subscribed to ``$SYS/broker/matcher/#``,
    ``$SYS/broker/durable/#``, ``$SYS/broker/overload/#``,
    ``$SYS/broker/devices/#`` and the stage's batch service rows under
    ``$SYS/broker/telemetry/`` from outside the broker's process: the
    newest value of every row, by the row's name below ``$SYS/broker/``,
    and how many times each was received."""

    PREFIX = "$SYS/broker/"

    def __init__(self, what: str = ENTRY_CELL) -> None:
        self.c = WireClient("entry-sys", 4)
        self.what = what  # the phase and broker named in a failure

    async def open(self, host: str, port: int) -> None:
        await self.c.open(host, port)
        self.c.send(connect_frame(self.c.name, 4))
        await self.c.wait_frames(1, 60.0)
        self.c.send(subscribe_frame(1, [(self.PREFIX + t + "/#", 0, 0) for t in (
            "matcher", "durable", "overload", "devices", "telemetry/stage_batch_service_seconds")], 4))
        await self.c.wait_frames(2, 60.0)

    def rows(self) -> dict:
        out = {}
        for p in _publishes(self.c, 0):
            if p["topic"].startswith(self.PREFIX):
                out[p["topic"][len(self.PREFIX):]] = p["payload"].decode()
        return out

    def count(self, row: str) -> int:
        return sum(1 for p in _publishes(self.c, 0) if p["topic"] == self.PREFIX + row)

    async def fresh(self, limit: float = 30.0) -> dict:
        """The rows of a ``$SYS`` tick that began after this call. Sends a
        PINGREQ first: this client only reads, and a broker ends a client
        that sends nothing for 1.5 keepalives."""
        self.c.send(PINGREQ_FRAME)
        n0 = self.count("matcher/batches")
        deadline = time.monotonic() + limit
        while self.count("matcher/batches") < n0 + 2:
            check(time.monotonic() < deadline, f"{self.what}: no $SYS tick within {limit} s")
            await asyncio.sleep(0.1)
        return self.rows()

    @staticmethod
    def refolds(rows: dict) -> int:
        """The device matcher's folds and full rebuilds so far."""
        return int(rows["matcher/folds"]) + int(rows["matcher/rebuilds"])

    async def folded(self, what: str, base: int, limit: float = 900.0) -> float:
        """Seconds until the matcher's folds and rebuilds have passed
        ``base`` (read before the mutations were sent) and then read the
        same over two more ticks: the background fold of those mutations
        has run (it wakes on the overlay's size or once a second)."""
        t0 = time.perf_counter()
        last, same = -1, 0
        while same < 2:
            check(time.perf_counter() - t0 < limit, f"{what}: the overlay was not folded within {limit} s")
            n = self.refolds(await self.fresh())
            same = same + 1 if n > base and n == last else 0
            last = n
        return time.perf_counter() - t0


def phase_entry(torch, device, card: str, fill: dict, n_churn: int = BROKER_CHURN, planes: bool = True,
                before_waves=None) -> dict:
    """Phase ``entry`` (cell ``entry-cfg2``): the broker started as its
    users start it, ``python -m mqtt_tpu_torch serve --config <file>``, in a
    process of its own on the card. The config (JSON) turns on the device
    matcher on ``device`` with its breaker at the default, a TCP, a
    WebSocket, a healthcheck and an ``HTTPStats`` listener on free ports of
    127.0.0.1, the ``logkv`` store that ``entry_fill`` wrote (config 2's
    records and the persistent sessions) and an ``AuthHook`` whose ledger
    is inline. The script polls ``/healthz`` until 200 (the restore done)
    and reads ``$SYS/broker/matcher/`` over MQTT until the restored
    subscriptions are folded onto the card; ``$SYS/broker/durable/`` must
    count every stored subscription restored. Half the sessions reconnect over
    TCP and half over WebSocket (``WsClient``) with clean start off and
    must find their sessions present; 8 publishers, four on each listener,
    send a wave of cfg2 topics, ``n_churn`` UNSUBSCRIBE/SUBSCRIBE packets
    follow, then a second wave. Every socket's frames must be the multiset
    the session's stored filter (as the churn changed it) matches, by
    cfg2's rule; the device must resolve most of each wave (by the
    ``$SYS`` matcher rows); the breaker's rows must show verified batches,
    no failure, trip or fallback batch and a closed state; ``/healthz`` 200 with no
    breaker degradation and the stats route must answer. SIGTERM must end
    the process with 0, and the store, opened again, must hold every
    churned record as the churn left it. The kernels run in that process,
    so their launches are not in the kernels line: the ``$SYS`` rows are
    this phase's evidence. ``planes=False`` turns the default planes off in
    the config (``PLANES_OFF``) and skips their checks (``entry_planes``).
    ``before_waves`` (a coroutine function) is awaited after the sessions'
    fold and before the first wave: phase ``fabric``'s broker restores
    beside this one, and the waves wait until it is restored and folded."""
    from mqtt_tpu_torch.hooks.storage.logkv import LogKVOptions, LogKVStore

    t_phase = time.perf_counter()
    proc = fill["proc"]
    try:
        proc.wait(timeout=1500)
    except subprocess.TimeoutExpired:
        raise PhaseFailed(f"{ENTRY_CELL}: the store's fill did not end") from None
    check(proc.returncode == 0, f"{ENTRY_CELL}: the store's fill failed:\n{_tail(fill['log'])}")
    with open(fill["path"] + ".json") as f:
        meta = json.load(f)
    waited = time.perf_counter() - t_phase
    log(f"phase {ENTRY_CELL} fill: ok a LogKVStore of {meta['keys']} records ({len(meta['sessions'])} sessions), "
        f"{meta['bytes']} bytes on disk: cfg2 generator {meta['gen_s']:.3f} s, _set with fsync off "
        f"{meta['fill_s']:.3f} s, snapshot {meta['snapshot_s']:.3f} s, in its own process beside the earlier "
        f"phases (waited {waited:.3f} s for it here); {card}")
    sessions = meta["sessions"]
    n_sessions = len(sessions)
    nofile = _raise_nofile(4 * n_sessions + 256)
    check(nofile >= 2 * n_sessions + 64, f"{ENTRY_CELL}: open-file limit {nofile} below two sockets a session")
    on_ws = {cid: (k // 2) % 2 == 1 for k, (cid, *_r) in enumerate(sessions)}
    versions = {cid: v for cid, _f, _q, v in sessions}
    held: dict = {}
    for cid, flt, qos, _v in sessions:
        held.setdefault(flt, []).append((cid, qos))
    p_tcp, p_ws, p_hc, p_st = _free_ports(4)
    conf = {
        "listeners": [{"type": "tcp", "id": "t", "address": f"127.0.0.1:{p_tcp}"},
                      {"type": "ws", "id": "ws", "address": f"127.0.0.1:{p_ws}"},
                      {"type": "healthcheck", "id": "hc", "address": f"127.0.0.1:{p_hc}"},
                      {"type": "sysinfo", "id": "stats", "address": f"127.0.0.1:{p_st}"}],
        "hooks": {"auth": {"ledger": {"auth": [{"allow": True}]}},
                  "storage": {"logkv": {"path": fill["path"], "gc_interval": 0}}},
        "options": {"device": str(device), "device_matcher": True, "matcher_opts": {"max_levels": 4},
                    "sys_topic_resend_interval": 1, "slo_objectives": list(ENTRY_SLO),
                    # a breach's flight, trace, profile and device dumps
                    # go with the phase's directory
                    "telemetry_dump_dir": os.path.join(fill["root"], "dumps"),
                    **({} if planes else PLANES_OFF)},
        "logging": {"level": "warning"},
    }
    conf_path = os.path.join(fill["root"], "broker.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    out_path = os.path.join(fill["root"], "broker.log")
    with open(out_path, "w") as out:
        broker = subprocess.Popen([sys.executable, "-m", "mqtt_tpu_torch", "serve", "--config", conf_path,
                                   "--log-level", "warning"], cwd=HERE, stdout=out, stderr=subprocess.STDOUT)
    info: dict = {}
    rows = []

    async def wave_run(w: int, topics: list, clients: dict, pubs: list, sysr: SysRows) -> dict:
        wave = _Cfg2Wave(topics, b"e%d" % w, held, clients, pubs)
        r0 = await sysr.fresh()
        wall = await wave.send()
        r1 = await sysr.fresh()
        # no governor (planes off): no overload rows, and nothing shed
        gov = {k: int(r1.get("overload/" + k, 0)) - int(r0.get("overload/" + k, 0))
               for k in ("transitions", "sheds", "throttled", "connects_refused", "evictions")}
        shed = wave.check(f"{ENTRY_CELL} wave {w + 1}", gov["sheds"])
        n_del = {"tcp": 0, "ws": 0}
        for cid in clients:
            n_del["ws" if on_ws[cid] else "tcp"] += sum(wave.exp[cid].values())
        n_ws = len(pubs) - ENTRY_WS_PUBLISHERS
        n_in = {"tcp": sum(wave.n_pub[:n_ws]), "ws": sum(wave.n_pub[n_ws:])}
        routes = device_share(r0, r1)
        # publishes the stage answered from the walk at its admission
        # bound or deadline (they never reach the matcher's counters)
        key = "overload/stage_admission_fallbacks"
        routes["stage_admission"] = int(r1[key]) - int(r0[key]) if key in r1 else "not shown (planes off)"
        svc = "telemetry/stage_batch_service_seconds/"
        service = {k: r1.get(svc + k) for k in ("count", "p50_ms", "p99_ms")}
        return {"n_pub": len(topics), "n_in": n_in, "n_del": n_del, "wall": wall, "routes": routes,
                "service": service, "governor": gov, "shed": shed, "state": r1.get("overload/state"),
                "peaks": {k: r1[k] for k in r1 if k.startswith("overload/peak/")}}

    async def drive():
        t0 = time.perf_counter()
        health = await _healthy(broker, p_st, out_path, ENTRY_CELL)
        info["ready"] = time.perf_counter() - t0
        info["health0"] = health
        check(health.get("ok") is True and "durable" in health, f"{ENTRY_CELL}: /healthz {health}")
        sysr = SysRows()
        await sysr.open("127.0.0.1", p_tcp)
        # past the constructor's one build: the restore is folded once
        # after it (Server.read_store holds the folds meanwhile)
        info["fold"] = await sysr.folded(ENTRY_CELL, 1)
        r = sysr.rows()
        info["fold_rows"] = {k: r["matcher/" + k] for k in ("rebuilds", "rebuild_seconds", "folds")}
        restored = int(r["durable/restored_subscriptions"])
        check(restored == meta["subs"], f"{ENTRY_CELL}: {restored} of {meta['subs']} subscriptions restored")
        base = sysr.refolds(r)
        clients = {cid: (WsClient if on_ws[cid] else WireClient)(cid, versions[cid]) for cid, *_r in sessions}
        t0 = time.perf_counter()
        for c in clients.values():
            await c.open("127.0.0.1", p_ws if isinstance(c, WsClient) else p_tcp)
            # keepalive 0: a session sends nothing between its CONNECT and
            # the churn, longer than 1.5 keepalives of 60 s on a slow host
            c.send(connect_frame(c.name, c.version, clean=False, keepalive=0,
                                 props=[(P_SESSION_EXPIRY, 3600)] if c.version == 5 else ()))
        present = 0
        for c in clients.values():
            got = await c.wait_frames(1, 120.0)
            check(got and got[0][0] == 0x20 and got[0][3] == 0, f"{c.name}: CONNACK {bytes(got[0]) if got else None!r}")
            present += got[0][2] & 1
        info["connect"] = time.perf_counter() - t0
        check(present == n_sessions, f"{ENTRY_CELL}: {present} of {n_sessions} sessions present at CONNACK")
        # an inherited session subscribes its filters again: fold them too
        info["reconnect_fold"] = await sysr.folded(ENTRY_CELL + " reconnect", base)
        if before_waves is not None:
            t0 = time.perf_counter()
            await before_waves()
            info["waited"] = time.perf_counter() - t0
        pubs = [(WsClient if k >= len(BROKER_PUBLISHERS) - ENTRY_WS_PUBLISHERS else WireClient)(f"epub{k}", v)
                for k, (v, _q) in enumerate(BROKER_PUBLISHERS)]
        for c in pubs:
            await c.open("127.0.0.1", p_ws if isinstance(c, WsClient) else p_tcp)
            c.send(connect_frame(c.name, c.version, keepalive=0))
            await c.wait_frames(1, 60.0)
        try:
            rows.append(await wave_run(0, meta["waves"][0], clients, pubs, sysr))
            churned = [cid for cid, *_r in sessions[: n_churn // 2]]
            off = {cid: len(clients[cid].frames()) for cid in churned}
            base = sysr.refolds(sysr.rows())
            new_filter = {}
            for j, cid in enumerate(churned):
                a, _b, c = meta["waves"][1][j * 7 % len(meta["waves"][1])].split("/")
                old_f, old_q = next((f, q) for f, lst in held.items() for x, q in lst if x == cid)
                new_filter[cid] = (old_f, f"{a}/+/{c}")
                clients[cid].send(unsubscribe_frame(CHURN_PID, [old_f], versions[cid])
                                  + subscribe_frame(CHURN_PID + 1, [(new_filter[cid][1], 1, 0)], versions[cid]))
                held[old_f].remove((cid, old_q))
                held.setdefault(new_filter[cid][1], []).append((cid, 1))
            for cid in churned:
                got = await clients[cid].wait_frames(off[cid] + 2, 120.0)
                check([f[0] >> 4 for f in got[off[cid]:]] == [11, 9], f"{cid}: churn acks {got[off[cid]:]}")
            info["churn_fold"] = await sysr.folded(ENTRY_CELL + " churn", base)
            info["new_filter"] = new_filter
            rows.append(await wave_run(1, meta["waves"][1], clients, pubs, sysr))
            r = await sysr.fresh()
            info["breaker"] = {k[len("matcher/breaker/"):]: v for k, v in r.items()
                               if k.startswith("matcher/breaker/")}
            info["matcher_rows"] = {k: r["matcher/" + k] for k in ("batches", "topics", "compact_batches",
                                                                   "compact_overflows", "folds", "rebuilds",
                                                                   "rebuild_seconds", "d2h_bytes")}
            status, body = await http_get("127.0.0.1", p_st, "/healthz")
            info["health"] = (status, json.loads(body))
            status_st, body_st = await http_get("127.0.0.1", p_st, "/")
            info["stats"] = (status_st, sorted(json.loads(body_st)))
            info["healthcheck"] = (await http_get("127.0.0.1", p_hc, "/healthcheck"))[0]
            info["sys"] = r
            for route in ("/metrics", "/devices", "/profile", "/traces", "/cluster/slo"):
                info[route] = await http_get("127.0.0.1", p_st, route)
        finally:
            for c in list(clients.values()) + pubs + [sysr.c]:
                if c.task is not None and not c.task.done():
                    c.send(disconnect_frame(c.version))
            for c in list(clients.values()) + pubs + [sysr.c]:
                if c.task is not None:
                    await c.ended(60.0)

    try:
        asyncio.run(drive())
        t0 = time.perf_counter()
        broker.send_signal(signal.SIGTERM)
        try:
            rc = broker.wait(timeout=300)
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"{ENTRY_CELL}: the broker did not exit within 300 s of SIGTERM") from None
        t_exit = time.perf_counter() - t0
        check(rc == 0, f"{ENTRY_CELL}: the broker exited {rc} on SIGTERM:\n{_tail(out_path)}")
    finally:
        if broker.poll() is None:
            broker.kill()
            broker.wait()
    t0 = time.perf_counter()
    store = LogKVStore()
    store.init(LogKVOptions(path=fill["path"], gc_interval=0))
    try:
        t_reopen = time.perf_counter() - t0
        wrong = 0
        for cid, (old_f, new_f) in info["new_filter"].items():
            rec = store._get("SUB_" + cid + ":" + new_f)
            wrong += store._get("SUB_" + cid + ":" + old_f) is not None
            wrong += rec is None or json.loads(rec).get("qos") != 1
        n_keys = len(store._map)
    finally:
        store.stop()
    check(wrong == 0, f"{ENTRY_CELL}: {wrong} of the {n_churn} churned records do not stand as the churn left them")
    info["rows"] = rows
    health = info["health0"]
    d = health["durable"]
    log(f"phase {ENTRY_CELL}: python -m mqtt_tpu_torch serve on {device}"
        + (f" (fabric's broker restoring beside it; the waves waited {info['waited']:.3f} s for it to settle)"
           if "waited" in info else "") + f"; /healthz 200 after {info['ready']:.3f} s "
        f"(restore {d['recovery_seconds']:.3f} s, {d['replayed_keys']} keys replayed from LogKV), fold onto the card "
        f"{info['fold']:.3f} s after it ($SYS rebuilds {info['fold_rows']['rebuilds']}, folds "
        f"{info['fold_rows']['folds']}, rebuild_seconds {info['fold_rows']['rebuild_seconds']}); {n_sessions} "
        f"sessions present ({sum(on_ws.values())} over WebSocket) in {info['connect']:.3f} s, reconnect fold "
        f"{info['reconnect_fold']:.3f} s; {card}")
    READINGS["entry restore s"] = d["recovery_seconds"]
    READINGS["entry fold s"] = info["fold"]
    READINGS["entry SIGTERM to exit s"] = t_exit
    for w, r in enumerate(rows):
        ro = r["routes"]
        READINGS[f"entry wave {w + 1} publishes/s"] = r["n_pub"] / r["wall"]
        READINGS[f"entry wave {w + 1} stage admission fallbacks"] = ro["stage_admission"]
        log(f"phase {ENTRY_CELL} wave {w + 1}: ok {r['n_pub']} publishes ({r['n_in']['tcp']} over TCP, "
            f"{r['n_in']['ws']} over WebSocket), {r['n_del']['tcp'] + r['n_del']['ws']} deliveries "
            f"({r['n_del']['tcp']} to TCP sockets, {r['n_del']['ws']} to WebSocket ones), every frame the stored "
            f"filters' match; {r['n_pub'] / r['wall']:.1f} publishes/s ({r['n_in']['tcp'] / r['wall']:.1f} TCP, "
            f"{r['n_in']['ws'] / r['wall']:.1f} WebSocket), deliveries/s {r['n_del']['tcp'] / r['wall']:.1f} TCP, "
            f"{r['n_del']['ws'] / r['wall']:.1f} WebSocket (wall {r['wall']:.3f} s); resolved by the device "
            f"{ro['device']}, by the host: " + ", ".join(f"{k} {v}" for k, v in ro.items() if k != "device")
            + f"; the stage's batch service since the start {r['service']}; {card}")
    g = info["breaker"]
    breaker_summary(g, ENTRY_CELL + " (read over $SYS)", card)
    check(int(g["verified_batches"]) > 0, f"{ENTRY_CELL}: the breaker verified no batch: {g}")
    status, body = info["health"]
    check(status == 200 and not [x for x in body["degraded"] if x.startswith("matcher_breaker")],
          f"{ENTRY_CELL}: /healthz {status} {body}")
    check(info["stats"][0] == 200 and "version" in info["stats"][1], f"{ENTRY_CELL}: stats route {info['stats']}")
    check(info["healthcheck"] == 200, f"{ENTRY_CELL}: /healthcheck {info['healthcheck']}")
    log(f"  {ENTRY_CELL}: /healthz 200 {json.dumps(body, sort_keys=True)}; stats route 200 ({len(info['stats'][1])} "
        f"keys), /healthcheck 200; $SYS matcher {info['matcher_rows']}; SIGTERM -> exit 0 in {t_exit:.3f} s; the "
        f"store reopened ({n_keys} keys, {t_reopen:.3f} s) holds the {n_churn} churned records as the churn left "
        f"them; churn fold {info['churn_fold']:.3f} s; phase {time.perf_counter() - t_phase:.1f} s; {card}")
    if planes:
        entry_planes(torch, device, card, info, body, rows)
    for w, r in enumerate(rows):
        ro = r["routes"]
        check(ro["device"] > r["n_pub"] // 2, f"{ENTRY_CELL} wave {w + 1}: the device resolved {ro['device']} "
              f"of {r['n_pub']} publishes")
    return info


# the entry cell's declared objectives (its config file's slo_objectives)
ENTRY_SLO = ("p99 delivery < 50ms over 5m", "hbm ratio < 0.9 over 5m")


def entry_planes(torch, device, card: str, info: dict, health: dict, rows: list) -> None:
    """Phase ``entry``'s default planes, read from outside the broker's
    process after the waves: ``/metrics`` passes ``check_exposition`` and
    counts samples of the device legs (``h2d``, ``device_dispatch``,
    ``d2h``) in the stage-clock family; ``/devices`` and
    ``$SYS/broker/devices/#`` name the card (its kind, live memory above 0,
    the limit ``torch.cuda.mem_get_info`` reports); ``/profile`` passes
    ``check_collapsed`` and ``/traces`` ``check_trace_events``; ``/healthz``
    reports the governor's state and each declared objective. Logs the
    governor over the waves, each objective's state, the card's busy share
    and idle gap, the stage's legs and the sampled traces."""
    import re

    from mqtt_tpu_torch.profiling import check_collapsed
    from mqtt_tpu_torch.telemetry import check_exposition
    from mqtt_tpu_torch.tracing import check_trace_events

    for route in ("/metrics", "/devices", "/profile", "/traces", "/cluster/slo"):
        check(info[route][0] == 200, f"{ENTRY_CELL}: {route} answered {info[route][0]}")
    text = info["/metrics"][1].decode()
    n_samples = check_exposition(text)
    legs, quantiles = {}, {}
    for stage in ("staging_wait", "h2d", "device_dispatch", "d2h", "device_batch", "encode", "flush"):
        m = re.search(r'^mqtt_tpu_publish_stage_seconds_count\{stage="%s"\} (\d+)$' % stage, text, re.M)
        legs[stage] = int(m.group(1)) if m else 0
        quantiles[stage] = _bucket_quantiles(text, 'mqtt_tpu_publish_stage_seconds_bucket{stage="%s",' % stage)
    delivery = {q: _bucket_quantiles(text, 'mqtt_tpu_delivery_latency_seconds_bucket{path="local",qos="%d",tenant="",'
                                      % q) for q in (0, 1)}
    dev = json.loads(info["/devices"][1])
    card0 = dev["devices"][0]
    rows_sys = info["sys"]
    if device.type == "cuda":
        for stage in ("h2d", "device_dispatch", "d2h"):
            check(legs[stage] > 0, f"{ENTRY_CELL}: no sampled publish stamped {stage}: {legs}")
        kind, limit = torch.cuda.get_device_name(0), torch.cuda.mem_get_info(0)[1]
        check(card0.get("kind") == kind and card0["hbm"]["live_bytes"] and card0["hbm"]["live_bytes"] > 0
              and card0["hbm"]["limit_bytes"] == limit,
              f"{ENTRY_CELL}: /devices names {card0.get('kind')!r} with {card0['hbm']}, the card is {kind!r} of {limit}")
        check(rows_sys.get("devices/0/kind") == kind and int(rows_sys.get("devices/0/hbm_live_bytes", 0)) > 0,
              f"{ENTRY_CELL}: $SYS/broker/devices/0 rows {({k: v for k, v in rows_sys.items() if k.startswith('devices/0/')})}")
    n_stacks = check_collapsed(info["/profile"][1].decode())
    n_events = check_trace_events(info["/traces"][1])
    slo = json.loads(info["/cluster/slo"][1])["local"]
    check(sorted(st["spec"] for st in slo.values()) == sorted(ENTRY_SLO), f"{ENTRY_CELL}: objectives {sorted(slo)}")
    check("governor" in health and health.get("slo", {}).get("objectives") == len(ENTRY_SLO),
          f"{ENTRY_CELL}: /healthz without the governor's or the objectives' state: {health}")
    for w, r in enumerate(rows):
        g = r["governor"]
        log(f"  {ENTRY_CELL} wave {w + 1} governor: state {r['state']} after it, transitions {g['transitions']}, "
            f"sheds {g['sheds']} ({r['shed']['undelivered']} publishes undelivered, {r['shed']['refused_0x97']} "
            f"acked 0x97), throttled reads {g['throttled']}, CONNECT refusals {g['connects_refused']}, evictions "
            f"{g['evictions']}; peak pressures {r['peaks']}; {card}")
    for name, st in sorted(slo.items()):
        extra = f", value {st['value']}" if "value" in st else ""
        log(f"  {ENTRY_CELL} objective {st['spec']!r}: breached {st['breached']}, burn fast {st['burn_rate_fast']} "
            f"slow {st['burn_rate_slow']}, budget remaining {st['budget_remaining']}, breaches {st['breaches']}"
            f"{extra}; {card}")
    log(f"  {ENTRY_CELL} device plane: {card0.get('kind', card0['platform'])} live {card0['hbm']['live_bytes']} B, "
        f"peak {card0['hbm']['peak_bytes']} B, limit {card0['hbm']['limit_bytes']} B (ratio {card0['hbm']['ratio']}); "
        f"busy share (duty cycle) {card0['duty_cycle']}, overlap {card0['overlap_ratio']}, idle gap p99 "
        f"{card0['idle_gap_p99_ms']} ms, issue p99 {card0['issue_p99_ms']} ms, d2h p99 {card0['d2h_p99_ms']} ms over "
        f"{card0['batches']} batches; first launches noted {dev['compiles']['total']}; {card}")
    log(f"  {ENTRY_CELL} telemetry: /metrics {n_samples} samples (check_exposition), sampled publishes by stage "
        f"{legs}; /profile {n_stacks} stacks (check_collapsed); /traces {n_events} spans (check_trace_events); "
        f"governor {health['governor']}; {card}")
    log(f"  {ENTRY_CELL} stage clocks (p50, p99 ms, bucket bounds): "
        + ", ".join(f"{k} {v}" for k, v in quantiles.items())
        + f"; delivery (decode to flush) QoS 0 {delivery[0]}, QoS 1 {delivery[1]}; {card}")


# -- the event-loop shard fabric and the worker cluster ----------------------

FABRIC_CELL = "fabric-cfg2"
FABRIC_SHARDS = 4
FABRIC_MOVES = 64  # session ids reconnected, each onto another shard
CLUSTER_CELL = "cluster-cfg2"
CLUSTER_WORKERS = 4
CLUSTER_FILTERS = 262_144  # config 2's filters, cut from 1,000,000 for the call's time limit
CLUSTER_CONNS = 512
CLUSTER_SEED = 15
CLUSTER_PER_PACKET = 128  # filters per SUBSCRIBE packet
CLUSTER_MARK = "zz/mark/"  # the probes' marker topics


def device_share(r0: dict, r1: dict) -> dict:
    """``route_split`` over the ``$SYS/broker/matcher/`` rows' deltas
    between two ticks read from outside the broker."""
    rows = {k: "matcher/" + k for k in ("topics", "host_fallbacks", "overflows", "host_fast")}
    rows["breaker"] = "matcher/breaker/fallback_topics"
    return route_split({k: int(r1[row]) - int(r0[row]) for k, row in rows.items()})


def shard_rows(text: str) -> dict:
    """``{shard: live connections}`` from a ``/metrics`` exposition's
    ``mqtt_tpu_shard_connections`` family."""
    out = {}
    for line in text.splitlines():
        if line.startswith("mqtt_tpu_shard_connections{"):
            head, _, value = line.rpartition(" ")
            out[int(head.split('shard="', 1)[1].split('"', 1)[0])] = int(float(value))
    return out


async def ack_qos1(c, limit: float = 60.0) -> int:
    """PUBACK every QoS 1 publish of ``c``'s current connection, then a
    PINGREQ; returns (the count acked) once the PINGRESP is in, so the
    broker has processed every ack."""
    pids = [parse_publish(f, c.version)["pid"] for f in c.frames() if f[0] >> 4 == 3 and (f[0] >> 1) & 3 == 1]
    n0 = len(c.frames())
    c.send(b"".join(ack_frame(PUBACK, pid) for pid in pids) + PINGREQ_FRAME)
    deadline = time.monotonic() + limit
    while not any(f[0] == 0xD0 for f in c.frames()[n0:]):
        check(time.monotonic() < deadline and not c.task.done(), f"{c.name}: no PINGRESP after its acks")
        await c.wait_frames(len(c.frames()) + 1, limit)
    return len(pids)


def _serve_with_witness(conf_path: str, witness_path: str, out_path: str, extra=()) -> subprocess.Popen:
    """``python -m mqtt_tpu_torch serve --config`` in a process of its own,
    with the port's loop witness armed first (``utils.loopwitness``): at
    the broker's exit it writes the (kind, seam) crossings it saw and any
    violation to ``witness_path``."""
    code = ("import json, sys\n"
            "from mqtt_tpu_torch.utils.loopwitness import DEFAULT_LOOP_PLANE as P\n"
            "w = P.arm_witness()\n"
            "from mqtt_tpu_torch.__main__ import main\n"
            f"rc = main(['serve', '--config', {conf_path!r}, '--log-level', 'warning', *{list(extra)!r}])\n"
            f"json.dump({{'edges': sorted('/'.join(k) for k in w.edges), 'violations': w.violations[:20]}}, "
            f"open({witness_path!r}, 'w'))\n"
            "sys.exit(rc)\n")
    with open(out_path, "w") as out:
        return subprocess.Popen([sys.executable, "-c", code], cwd=HERE, stdout=out, stderr=subprocess.STDOUT)


async def _healthy(proc, port: int, out_path: str, what: str, limit: float = 900.0) -> dict:
    """``/healthz``'s body once it answers 200 (the restore done)."""
    t0 = time.perf_counter()
    while True:
        check(proc.poll() is None, f"{what}: the broker exited {proc.returncode}:\n{_tail(out_path)}")
        check(time.perf_counter() - t0 < limit, f"{what}: /healthz not 200 within {limit} s")
        try:
            status, body = await http_get("127.0.0.1", port, "/healthz", 10.0)
            if status == 200:
                return json.loads(body)
        except (OSError, asyncio.TimeoutError):
            pass
        await asyncio.sleep(0.25)


def start_fabric(device, fill: dict) -> dict:
    """Phase ``fabric``'s broker, started on entry's store as the fill
    wrote it (``fill_copy(fill, ".fabric")``) before phase ``entry`` runs,
    so its restore and fold overlap entry's (two processes, one card):
    ``python -m mqtt_tpu_torch serve`` with ``loop_shards: 4`` (handoff),
    the default planes and the port's loop witness armed. Returns what
    ``phase_fabric`` drives; ``stop_fabric`` ends it."""
    store = fill["path"] + ".fabric"
    check(os.path.isdir(store), f"{FABRIC_CELL}: the store's copy is missing")
    p_tcp, p_ws, p_st = _free_ports(3)
    conf = {
        "listeners": [{"type": "tcp", "id": "t", "address": f"127.0.0.1:{p_tcp}"},
                      {"type": "ws", "id": "ws", "address": f"127.0.0.1:{p_ws}"},
                      {"type": "sysinfo", "id": "stats", "address": f"127.0.0.1:{p_st}"}],
        "hooks": {"auth": {"ledger": {"auth": [{"allow": True}]}},
                  "storage": {"logkv": {"path": store, "gc_interval": 0}}},
        "options": {"device": str(device), "device_matcher": True, "matcher_opts": {"max_levels": 4},
                    "sys_topic_resend_interval": 1, "loop_shards": FABRIC_SHARDS,
                    "loop_shard_accept": "handoff", "slo_objectives": list(ENTRY_SLO),
                    "telemetry_dump_dir": os.path.join(fill["root"], "fabric-dumps")},
        "logging": {"level": "warning"},
    }
    conf_path = os.path.join(fill["root"], "fabric.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    out_path = os.path.join(fill["root"], "fabric.log")
    witness_path = os.path.join(fill["root"], "fabric-witness.json")
    return {"store": store, "ports": (p_tcp, p_ws, p_st), "out": out_path, "witness": witness_path,
            "proc": _serve_with_witness(conf_path, witness_path, out_path)}


async def fabric_settled(fab: dict) -> None:
    """Until ``start_fabric``'s broker answers ``/healthz`` 200 (its
    restore done) and its ``$SYS/broker/matcher/`` rows show the restore
    folded onto the card, steady over two ticks: ``phase_entry`` waits for
    it before its waves, so the two brokers share the card only while
    they restore."""
    p_tcp, _p_ws, p_st = fab["ports"]
    await _healthy(fab["proc"], p_st, fab["out"], FABRIC_CELL)
    sysr = SysRows(FABRIC_CELL)
    sysr.c.name = "fabric-settle"
    await sysr.open("127.0.0.1", p_tcp)
    try:
        await sysr.folded(FABRIC_CELL, 1)
    finally:
        sysr.c.send(disconnect_frame(4))
        await sysr.c.ended(60.0)


def stop_fabric(fab: dict) -> None:
    """End phase ``fabric``'s broker if it still runs and remove its store."""
    import shutil

    proc = fab["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(fab["store"], ignore_errors=True)


def phase_fabric(torch, device, card: str, fill: dict, fab: dict, entry: dict, n_moves: int = FABRIC_MOVES) -> dict:
    """Phase ``fabric`` (cell ``fabric-cfg2``): phase ``entry``'s store as
    the fill wrote it (a copy taken before ``entry`` ran: config 2's
    1,000,000 records and the persistent sessions) served again through
    ``python -m mqtt_tpu_torch serve`` with ``loop_shards: 4`` and
    ``loop_shard_accept: handoff``, the default planes on and the port's
    loop witness armed in that process (started by ``start_fabric``
    beside phase ``entry``). Entry's sessions (half over TCP,
    half over WebSocket) and 8 publishers connect; the last ``n_moves``
    sessions connect one at a time between two ``/metrics`` reads, so the
    shard each stands on is seen (``mqtt_tpu_shard_connections``). One wave
    of entry's first wave's topics (QoS 0/1): every socket's frames must be
    the stored filters' matches; the device must resolve what entry
    resolved of the same wave but for the publishes the stage's admission
    walked (the rest ``overflow``), most of the wave; no shed, no breaker
    failure, trip or fallback batch. Then the ``n_moves`` sessions ack their QoS 1 deliveries and reconnect (clean
    start off) while their old connection is open, each when the router's
    least-loaded shard is not its own: ``/metrics`` must show it leave its
    shard for that one, and the old connection end (the cross-shard
    takeover). One more publish reaches each of those ids once (every
    socket's frames checked again). Every shard served connections; the
    witness saw the stage resolve futures of other loops
    (``match_stage/resolve_marshal``) and no violation; SIGTERM ends the
    broker with 0."""
    t_phase = time.perf_counter()
    with open(fill["path"] + ".json") as f:
        meta = json.load(f)
    sessions = meta["sessions"]
    n_sessions = len(sessions)
    _raise_nofile(4 * n_sessions + 256)
    on_ws = {cid: (k // 2) % 2 == 1 for k, (cid, *_r) in enumerate(sessions)}
    versions = {cid: v for cid, _f, _q, v in sessions}
    filters = {cid: f for cid, f, _q, _v in sessions}
    held: dict = {}
    for cid, flt, qos, _v in sessions:
        held.setdefault(flt, []).append((cid, qos))
    p_tcp, p_ws, p_st = fab["ports"]
    broker, out_path, witness_path = fab["proc"], fab["out"], fab["witness"]
    info: dict = {}

    async def shards() -> dict:
        status, body = await http_get("127.0.0.1", p_st, "/metrics")
        check(status == 200, f"{FABRIC_CELL}: /metrics {status}")
        got = shard_rows(body.decode())
        check(sorted(got) == list(range(FABRIC_SHARDS)), f"{FABRIC_CELL}: shard rows {got}")
        return got

    async def moved_to(c0: dict, pred, what: str, limit: float = 60.0) -> dict:
        deadline = time.monotonic() + limit
        while True:
            c1 = await shards()
            if pred(c1):
                return c1
            check(time.monotonic() < deadline, f"{what}: shard connections {c0} -> {c1}")
            await asyncio.sleep(0.02)

    async def wave_run(tag: bytes, topics: list, clients: dict, pubs: list, sysr) -> dict:
        wave = _Cfg2Wave(topics, tag, held, clients, pubs)
        r0 = await sysr.fresh()
        wall = await wave.send()
        r1 = await sysr.fresh()
        sheds = int(r1.get("overload/sheds", 0)) - int(r0.get("overload/sheds", 0))
        shed = wave.check(f"{FABRIC_CELL} {tag.decode()}", sheds)
        key = "overload/stage_admission_fallbacks"
        return {"n_pub": len(topics), "wall": wall, "routes": device_share(r0, r1), "shed": shed,
                "admission": int(r1[key]) - int(r0[key]), "wave": wave,
                "n_del": sum(sum(wave.exp[cid].values()) for cid in clients)}

    async def drive():
        t0 = time.perf_counter()
        info["health0"] = await _healthy(broker, p_st, out_path, FABRIC_CELL)
        info["ready"] = time.perf_counter() - t0
        sysr = SysRows()
        await sysr.open("127.0.0.1", p_tcp)
        info["fold"] = await sysr.folded(FABRIC_CELL, 1)
        base = sysr.refolds(sysr.rows())
        clients = {cid: (WsClient if on_ws[cid] else WireClient)(cid, versions[cid]) for cid, *_r in sessions}
        movers = [cid for cid, *_r in sessions[-n_moves:]]
        where: dict = {}

        def connect_frame_of(c):
            # keepalive 0: a session sends nothing from its CONNECT to its
            # move, longer than 1.5 keepalives of 60 s on a slow host
            return connect_frame(c.name, c.version, clean=False, keepalive=0,
                                 props=[(P_SESSION_EXPIRY, 3600)] if c.version == 5 else ())

        t0 = time.perf_counter()
        for cid, c in clients.items():
            if cid in movers:
                continue
            await c.open("127.0.0.1", p_ws if isinstance(c, WsClient) else p_tcp)
            c.send(connect_frame_of(c))
        for cid, c in clients.items():
            if cid not in movers:
                await c.wait_frames(1, 120.0)
        c0 = await shards()
        for cid in movers:
            c = clients[cid]
            await c.open("127.0.0.1", p_ws if isinstance(c, WsClient) else p_tcp)
            c.send(connect_frame_of(c))
            await c.wait_frames(1, 120.0)
            c1 = await moved_to(c0, lambda c1, c0=c0: sum(c1.values()) == sum(c0.values()) + 1, f"{cid}'s connect")
            where[cid] = next(k for k in c1 if c1[k] == c0[k] + 1)
            c0 = c1
        present = 0
        for c in clients.values():
            got = await c.wait_frames(1, 120.0)
            check(got and got[0][0] == 0x20 and got[0][3] == 0, f"{c.name}: CONNACK {bytes(got[0]) if got else None!r}")
            present += got[0][2] & 1
        info["connect"] = time.perf_counter() - t0
        check(present == n_sessions, f"{FABRIC_CELL}: {present} of {n_sessions} sessions present at CONNACK")
        info["reconnect_fold"] = await sysr.folded(FABRIC_CELL + " reconnect", base)
        pubs = [(WsClient if k >= len(BROKER_PUBLISHERS) - ENTRY_WS_PUBLISHERS else WireClient)(f"fpub{k}", v)
                for k, (v, _q) in enumerate(BROKER_PUBLISHERS)]
        for c in pubs:
            await c.open("127.0.0.1", p_ws if isinstance(c, WsClient) else p_tcp)
            c.send(connect_frame(c.name, c.version, keepalive=0))
            await c.wait_frames(1, 60.0)
        info["spread"] = await shards()
        try:
            info["wave"] = await wave_run(b"f0", meta["waves"][0], clients, pubs, sysr)
            # the movers: each acks its deliveries, then reconnects while
            # its old connection is open, when the router's least-loaded
            # shard is not its own
            t0 = time.perf_counter()
            left = list(movers)
            info["moves"] = []
            while left:
                c0 = await shards()
                target = min(c0, key=lambda k: (c0[k], k))
                cid = next((x for x in left if where[x] != target), None)
                check(cid is not None, f"{FABRIC_CELL}: every session left stands on shard {target}")
                left.remove(cid)
                c = clients[cid]
                await ack_qos1(c)
                # the old connection stays open until the broker ends it:
                # its writer is held (a dropped StreamWriter closes its
                # socket, and the shard would be free before the new one
                # is dispatched)
                old, old_writer = c.task, c.writer
                await c.open("127.0.0.1", p_ws if isinstance(c, WsClient) else p_tcp)
                c.send(connect_frame_of(c))
                got = await c.wait_frames(1, 120.0)
                check(got and got[0][0] == 0x20 and got[0][2] & 1 == 1, f"{cid}: takeover CONNACK {got[:1]}")
                await asyncio.wait_for(asyncio.shield(old), 60.0)
                old_writer.close()
                src = where[cid]
                await moved_to(c0, lambda c1: c1[target] == c0[target] + 1 and c1[src] == c0[src] - 1,
                               f"{cid}'s move from shard {src} to {target} (moves so far {info['moves']}, "
                               f"where {where})")
                info["moves"].append((src, target))
                where[cid] = target
            info["move_s"] = time.perf_counter() - t0
            rng = random.Random(ENTRY_SEED)
            topics = [topic_for(filters[cid], rng) for cid in movers]
            info["last"] = await wave_run(b"f1", topics, clients, pubs, sysr)
            last = info["last"]["wave"]
            for cid, t in zip(movers, topics):
                mine = [p for p in _publishes(clients[cid], last.off[cid]) if p["topic"] == t]
                check(len(mine) >= 1, f"{FABRIC_CELL}: {cid} did not receive its publish after its move")
            info["spread_end"] = await shards()
            r = await sysr.fresh()
            info["breaker"] = {k[len("matcher/breaker/"):]: v for k, v in r.items() if k.startswith("matcher/breaker/")}
            info["matcher"] = {k: r["matcher/" + k] for k in ("batches", "topics", "folds")}
            status, body = await http_get("127.0.0.1", p_st, "/healthz")
            info["health"] = (status, json.loads(body))
        finally:
            for c in list(clients.values()) + pubs + [sysr.c]:
                if c.task is not None and not c.task.done():
                    c.send(disconnect_frame(c.version))
            for c in list(clients.values()) + pubs + [sysr.c]:
                if c.task is not None:
                    await c.ended(60.0)

    try:
        asyncio.run(drive())
        t0 = time.perf_counter()
        broker.send_signal(signal.SIGTERM)
        try:
            rc = broker.wait(timeout=300)
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"{FABRIC_CELL}: the broker did not exit within 300 s of SIGTERM") from None
        t_exit = time.perf_counter() - t0
        check(rc == 0, f"{FABRIC_CELL}: the broker exited {rc} on SIGTERM:\n{_tail(out_path)}")
    finally:
        stop_fabric(fab)
    with open(witness_path) as f:
        wit = json.load(f)
    w, last = info["wave"], info["last"]
    d = info["health0"]["durable"]
    log(f"phase {FABRIC_CELL}: python -m mqtt_tpu_torch serve, loop_shards {FABRIC_SHARDS} (handoff), on {device}, "
        f"started beside entry; /healthz 200 {info['ready']:.3f} s into the phase (restore {d['recovery_seconds']:.3f} s), fold "
        f"{info['fold']:.3f} s; {n_sessions} sessions present ({sum(on_ws.values())} over WebSocket) in "
        f"{info['connect']:.3f} s; shard connections {info['spread']} after the connects, "
        f"{info['spread_end']} at the end; {card}")
    READINGS["fabric wave publishes/s"] = w["n_pub"] / w["wall"]
    log(f"phase {FABRIC_CELL} wave: ok {w['n_pub']} publishes, {w['n_del']} deliveries, every frame the stored "
        f"filters' match; {w['n_pub'] / w['wall']:.1f} publishes/s, {w['n_del'] / w['wall']:.1f} deliveries/s "
        f"(wall {w['wall']:.3f} s); resolved by the device {w['routes']['device']} (entry's wave 1: "
        f"{entry['device']}), by the host: " + ", ".join(f"{k} {v}" for k, v in w["routes"].items() if k != "device")
        + f"; stage admission fallbacks {w['admission']}; {card}")
    log(f"phase {FABRIC_CELL} moves: ok {len(info['moves'])} sessions reconnected onto another shard in "
        f"{info['move_s']:.3f} s (from -> to: {sorted(set(info['moves']))}); then {last['n_pub']} publishes, "
        f"{last['n_del']} deliveries, every frame checked, each moved id its own; witness edges "
        f"{wit['edges']}; SIGTERM -> exit 0 in {t_exit:.3f} s; phase {time.perf_counter() - t_phase:.1f} s; {card}")
    breaker_summary(info["breaker"], FABRIC_CELL + " (read over $SYS)", card)
    check(len(info["moves"]) == n_moves and all(a != b for a, b in info["moves"]),
          f"{FABRIC_CELL}: moves {info['moves']}")
    check(all(n > 0 for n in info["spread"].values()), f"{FABRIC_CELL}: a shard served no connection: {info['spread']}")
    check("match_stage/resolve_marshal" in wit["edges"],
          f"{FABRIC_CELL}: the stage resolved no future of another loop: {wit['edges']}")
    check(not wit["violations"], f"{FABRIC_CELL}: loop witness violations {wit['violations']}")
    for r in (w, last):
        check(r["shed"]["sheds"] == 0, f"{FABRIC_CELL}: the governor shed {r['shed']}")
        check(r["routes"]["breaker"] == 0, f"{FABRIC_CELL}: the breaker answered {r['routes']['breaker']} topics")
    # every publish that reached the matcher took entry's route for its
    # topic: the device's counts differ by no more than the publishes the
    # stage's admission walked before the matcher (in either run; with none
    # they are equal), and most of the wave reaches the card, as in entry
    check(abs(w["routes"]["device"] - entry["device"]) <= max(w["admission"], entry["admission"])
          and w["routes"]["device"] > w["n_pub"] // 2,
          f"{FABRIC_CELL}: the device resolved {w['routes']['device']} of the wave ({w['admission']} walked at "
          f"the stage's admission), entry {entry['device']} ({entry['admission']})")
    g = info["breaker"]
    check(int(g["failures"]) == 0 and int(g["trips"]) == 0 and int(g["fallback_batches"]) == 0
          and g["state"] == "closed", f"{FABRIC_CELL}: breaker {g}")
    status, body = info["health"]
    check(status == 200, f"{FABRIC_CELL}: /healthz {status} {body}")
    return info


class WorkerRows(SysRows):
    """``SysRows`` on one worker of the cluster: which worker the
    kernel's SO_REUSEPORT balance gave the connection, and that worker's
    ``$SYS/broker/cluster/`` and ``matcher/`` rows."""

    async def open(self, host: str, port: int) -> None:
        await self.c.open(host, port)
        self.c.send(connect_frame(self.c.name, 4))
        await self.c.wait_frames(1, 60.0)
        self.c.send(subscribe_frame(1, [(self.PREFIX + t + "/#", 0, 0) for t in ("cluster", "matcher", "overload")]
                                    + [(CLUSTER_MARK + "+", 0, 0)], 4))
        await self.c.wait_frames(2, 60.0)

    def marks(self, tag: str) -> int:
        return sum(1 for p in _publishes(self.c, 0) if p["topic"] == CLUSTER_MARK + tag)

    async def worker(self, limit: float = 60.0) -> int:
        deadline = time.monotonic() + limit
        while "cluster/worker" not in self.rows():
            check(time.monotonic() < deadline, f"{self.c.name}: no $SYS/broker/cluster/worker")
            await asyncio.sleep(0.05)
        return int(self.rows()["cluster/worker"])


async def _which_worker(c, limit: float = 60.0) -> int:
    """The worker a connected client stands on: it subscribes to its
    worker's retained ``$SYS/broker/cluster/worker``, reads it and
    unsubscribes (the UNSUBACK read), so nothing more arrives from it."""
    n0 = len(c.frames())
    c.send(subscribe_frame(0xFFE0, [("$SYS/broker/cluster/worker", 0, 0)], c.version))
    deadline = time.monotonic() + limit
    while True:
        got = [p for p in _publishes(c, n0) if p["topic"] == "$SYS/broker/cluster/worker"]
        if got:
            break
        check(time.monotonic() < deadline, f"{c.name}: no $SYS/broker/cluster/worker")
        await c.wait_frames(len(c.frames()) + 1, limit)
    c.send(unsubscribe_frame(0xFFE1, ["$SYS/broker/cluster/worker"], c.version))
    while not any(f[0] >> 4 == 11 for f in c.frames()[n0:]):
        check(time.monotonic() < deadline, f"{c.name}: no UNSUBACK")
        await c.wait_frames(len(c.frames()) + 1, limit)
    return int(got[-1]["payload"])


def _children(pid: int) -> list:
    """The pids whose parent is ``pid`` (read from ``/proc/<n>/stat``)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(name))
    return out


def cluster_filters(n: int, n_conns: int, rng: random.Random) -> list:
    """Config 2's ``n`` filters (``cfg2_entries``) dealt over ``n_conns``
    connections at random, no connection holding two filters that one
    topic matches (a clash draws the connection again). Returns
    ``[(connection, filter, qos)]``."""
    entries, _gen = cfg2_entries(n, rng)
    # per connection: exact filters, their projections without level i, the
    # one-'+' filters by their '+' level (the other two levels), and for a
    # '+' at j the values of each other level
    E = [set() for _ in range(n_conns)]
    P = [[set(), set(), set()] for _ in range(n_conns)]
    W = [[set(), set(), set()] for _ in range(n_conns)]
    V = [[[set(), set(), set()] for _ in range(3)] for _ in range(n_conns)]
    out = []
    for _cid, sub in entries:
        s = sub.filter.split("/")
        i = s.index("+") if "+" in s else -1
        while True:
            k = rng.randrange(n_conns)
            if i < 0:
                t = tuple(s)
                clash = t in E[k] or any(t[:j] + t[j + 1:] in W[k][j] for j in range(3))
            else:
                rest = tuple(s[:i] + s[i + 1:])
                clash = rest in W[k][i] or rest in P[k][i] or any(
                    s[3 - i - j] in V[k][j][3 - i - j] for j in range(3) if j != i)
            if not clash:
                break
        if i < 0:
            E[k].add(tuple(s))
            for j in range(3):
                P[k][j].add(tuple(s[:j] + s[j + 1:]))
        else:
            W[k][i].add(tuple(s[:i] + s[i + 1:]))
            for j in range(3):
                if j != i:
                    V[k][i][j].add(s[j])
        out.append((k, sub.filter, sub.qos))
    return out


def phase_cluster(torch, device, card: str, n_filters: int = CLUSTER_FILTERS, n_conns: int = CLUSTER_CONNS,
                  wave: int = WAVE) -> dict:
    """Phase ``cluster`` (cell ``cluster-cfg2``): ``python -m mqtt_tpu_torch
    serve --workers 4`` on the one card, each worker with the device
    matcher on ``device`` and the default planes, on one SO_REUSEPORT MQTT
    port (stats on worker 0). ``n_filters`` of config 2's filters
    (``cluster_filters``: no connection holds two that one topic matches)
    are SUBSCRIBEd over ``n_conns`` connections that the kernel spreads over
    the workers; then 8 publishers, two on each worker (connections the
    kernel put elsewhere are closed), send two waves of ``wave`` config 2
    topics at QoS 0/1. Each subscriber's frames must be the host walk's
    selection over all the filters (one ``TopicsIndex`` here, by cfg2's
    rule in ``_Cfg2Wave``); every worker counts ``peers`` 3, no dropped
    forward, device batches with a closed breaker and no fallback batch.
    SIGTERM to the launcher must leave no worker process. Logs the
    SUBSCRIBE leg's wall, each wave's publishes/s and deliveries/s and the
    share of deliveries that crossed workers."""
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mqtt-torch-cluster-")
    rng = random.Random(CLUSTER_SEED)
    t0 = time.perf_counter()
    dealt = cluster_filters(n_filters, n_conns, rng)
    t_deal = time.perf_counter() - t0
    _entries, topic_gen = cfg2_entries(0, rng)
    waves = [[topic_gen() for _ in range(wave)] for _ in range(2)]
    names = [f"csub{k}" for k in range(n_conns)]
    held: dict = {}
    per_conn: dict = {name: [] for name in names}
    for k, flt, qos in dealt:
        held.setdefault(flt, []).append((names[k], qos))
        per_conn[names[k]].append((flt, qos))
    _raise_nofile(4 * n_conns + 256)
    p_mqtt, p_st = _free_ports(2)
    conf = {"options": {"device": str(device), "device_matcher": True, "matcher_opts": {"max_levels": 4},
                        "sys_topic_resend_interval": 1,
                        "telemetry_dump_dir": os.path.join(root, "dumps")},
            "logging": {"level": "warning"}}
    conf_path = os.path.join(root, "cluster.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    out_path = os.path.join(root, "cluster.log")
    with open(out_path, "w") as out:
        launcher = subprocess.Popen(
            [sys.executable, "-m", "mqtt_tpu_torch", "serve", "--workers", str(CLUSTER_WORKERS), "--config",
             conf_path, "--port", str(p_mqtt), "--stats-port", str(p_st), "--log-level", "warning"],
            cwd=HERE, stdout=out, stderr=subprocess.STDOUT)
    info: dict = {"deal_s": t_deal}

    def alive() -> None:
        check(launcher.poll() is None, f"{CLUSTER_CELL}: the launcher exited {launcher.returncode}:\n{_tail(out_path)}")

    async def wave_run(tag: bytes, topics: list, clients: dict, pubs: list, rows: dict) -> dict:
        w = _Cfg2Wave(topics, tag, held, clients, pubs)
        r0 = await fresh_all(rows)
        wall = await w.send()
        r1 = await fresh_all(rows)
        sheds = sum(int(r1[k].get("overload/sheds", 0)) - int(r0[k].get("overload/sheds", 0)) for k in rows)
        shed = w.check(f"{CLUSTER_CELL} wave {tag.decode()}", sheds)
        crossed = total = 0
        for cid, exp in w.exp.items():
            for (_t, _q, payload), n in exp.items():
                k = int(payload[2:].split(b"n", 1)[0][1:])  # the publisher's index, from "<tag>p<k>n<i>"
                total += n
                crossed += n if info["pub_worker"][k] != info["sub_worker"][cid] else 0
        return {"n_pub": len(topics), "n_del": total, "crossed": crossed, "wall": wall, "shed": shed,
                "routes": {k: device_share(r0[k], r1[k]) for k in rows}}

    async def fresh_all(rows: dict) -> dict:
        ticks = await asyncio.gather(*(r.fresh(120.0) for r in rows.values()))
        return dict(zip(rows, ticks))

    async def drained(rows: dict, limit: float = 600.0) -> None:
        """Until a fresh ``$SYS`` tick of every worker shows its governor
        NORMAL and its peer-link buffers (``overload/signal/cluster``)
        under 5% of their cap."""
        deadline = time.monotonic() + limit
        while True:
            ticks = await asyncio.gather(*(r.fresh(120.0) for r in rows.values()))
            if all(t.get("overload/state") == "normal" and float(t.get("overload/signal/cluster", 0)) < 0.05
                   for t in ticks):
                return
            alive()
            check(time.monotonic() < deadline, f"{CLUSTER_CELL}: the peer links did not drain: "
                  f"{[(t.get('overload/state'), t.get('overload/signal/cluster')) for t in ticks]}")

    async def drive():
        # every worker up: a probe client on each, its peers counted
        t0 = time.perf_counter()
        rows: dict = {}
        k = 0
        while len(rows) < CLUSTER_WORKERS:
            alive()
            check(time.perf_counter() - t0 < 600 and k < 4000, f"{CLUSTER_CELL}: workers seen {sorted(rows)}")
            r = WorkerRows(CLUSTER_CELL)
            r.c.name = f"cprobe{k}"
            k += 1
            try:
                await r.open("127.0.0.1", p_mqtt)
            except (OSError, PhaseFailed):
                await asyncio.sleep(0.25)
                continue
            w = await r.worker()
            r.what = f"{CLUSTER_CELL} worker {w}"
            if w in rows:
                r.c.send(disconnect_frame(4))
                await r.c.ended(60.0)
            else:
                rows[w] = r
        for w, r in rows.items():
            deadline = time.monotonic() + 300
            while r.rows().get("cluster/peers") != str(CLUSTER_WORKERS - 1):
                alive()
                check(time.monotonic() < deadline, f"{CLUSTER_CELL}: worker {w} peers {r.rows().get('cluster/peers')}")
                await asyncio.sleep(0.1)
        info["up"] = time.perf_counter() - t0
        log(f"  {CLUSTER_CELL}: {CLUSTER_WORKERS} workers with peers {CLUSTER_WORKERS - 1} after {info['up']:.3f} s")
        clients = {name: WireClient(name, 4 + k % 2) for k, name in enumerate(names)}
        for c in clients.values():
            await c.open("127.0.0.1", p_mqtt)
            # keepalive 0: a subscriber sends nothing between its last
            # SUBSCRIBE and the end of the second wave
            c.send(connect_frame(c.name, c.version, keepalive=0))
        for c in clients.values():
            got = await c.wait_frames(1, 120.0)
            check(got and got[0][0] == 0x20, f"{c.name}: CONNACK {got[:1]}")
        info["sub_worker"] = {name: await _which_worker(c) for name, c in clients.items()}
        # the SUBSCRIBE leg, one burst: every connection sends all its
        # packets of CLUSTER_PER_PACKET filters back to back, all at once
        t0 = time.perf_counter()
        sent = {}
        for name, c in clients.items():
            sent[name] = len(c.frames())
            for j in range(0, len(per_conn[name]), CLUSTER_PER_PACKET):
                c.send(subscribe_frame(1 + j // CLUSTER_PER_PACKET,
                                       [(f, q, 0) for f, q in per_conn[name][j:j + CLUSTER_PER_PACKET]], c.version))
        for name, n0 in sent.items():
            n = -(-len(per_conn[name]) // CLUSTER_PER_PACKET)
            got = await clients[name].wait_frames(n0 + n, 600.0)
            check(all(f[0] >> 4 == 9 for f in got[n0:n0 + n]),
                  f"{name}: SUBSCRIBE answered {[bytes(f[:1]) for f in got[n0:n0 + n]]}")
        info["subscribe_acked_s"] = time.perf_counter() - t0
        log(f"  {CLUSTER_CELL}: every SUBACK after {info['subscribe_acked_s']:.3f} s")
        # the burst's presence frames fill the peer links and the
        # governors leave NORMAL; the markers below are QoS 0 forwards,
        # so they wait until every link has drained (timed on its own)
        t1 = time.perf_counter()
        await drained(rows)
        info["drain_s"] = time.perf_counter() - t1
        log(f"  {CLUSTER_CELL}: every governor NORMAL and every link drained {info['drain_s']:.3f} s later")
        # every worker's presence frames are on its links before its
        # probe's marker (the presence loop runs before the marker's
        # packet is read), and the links are FIFO: once every probe holds
        # every marker, every worker knows the others' interest
        t1 = time.perf_counter()
        for idx, w in enumerate(sorted(rows)):
            rows[w].c.send(publish_frame(CLUSTER_MARK + "s", b"w%d" % w))
            deadline = time.monotonic() + 600
            for w2, r2 in rows.items():
                while r2.marks("s") < idx + 1:
                    alive()
                    check(time.monotonic() < deadline, f"{CLUSTER_CELL}: worker {w}'s marker at worker {w2}")
                    await asyncio.sleep(0.02)
        info["presence_s"] = time.perf_counter() - t1
        log(f"  {CLUSTER_CELL}: every marker at every worker {info['presence_s']:.3f} s later")
        t1 = time.perf_counter()
        await asyncio.gather(*(r.folded(f"{CLUSTER_CELL} worker {w}", 1) for w, r in rows.items()))
        info["fold_s"] = time.perf_counter() - t1
        # the leg's wall, the drain wait left out
        info["subscribe_s"] = time.perf_counter() - t0 - info["drain_s"]
        # the publishers: a v4 and a v5 one on each worker (connections
        # the kernel put on a worker that has its two are closed)
        slots: dict = {(w, v): None for w in rows for v in (4, 5)}
        k = 0
        while any(c is None for c in slots.values()):
            check(k < 400, f"{CLUSTER_CELL}: publisher slots {sorted(x for x, c in slots.items() if c)}")
            v = 4 + k % 2
            c = WireClient(f"cpub{k}", v)
            k += 1
            await c.open("127.0.0.1", p_mqtt)
            c.send(connect_frame(c.name, v))
            await c.wait_frames(1, 60.0)
            w = await _which_worker(c)
            if slots[(w, v)] is None:
                slots[(w, v)] = c
            else:
                c.send(disconnect_frame(v))
                await c.ended(60.0)
        # _Cfg2Wave sends round robin with BROKER_PUBLISHERS' (version,
        # QoS) by position
        byv = {v: [slots[(w, v)] for w in sorted(rows)] for v in (4, 5)}
        pubs, info["pub_worker"] = [], {}
        for k, (v, _q) in enumerate(BROKER_PUBLISHERS):
            c = byv[v].pop(0)
            pubs.append(c)
            info["pub_worker"][k] = next(w for (w, _v), x in slots.items() if x is c)
        info["waves"] = []
        try:
            for w_i, topics in enumerate(waves):
                info["waves"].append(await wave_run(b"c%d" % w_i, topics, clients, pubs, rows))
                log(f"  {CLUSTER_CELL}: wave {w_i + 1} wall {info['waves'][-1]['wall']:.3f} s")
            info["rows"] = await fresh_all(rows)
            status, body = await http_get("127.0.0.1", p_st, "/healthz")
            info["health"] = (status, json.loads(body))
        finally:
            for c in list(clients.values()) + pubs + [r.c for r in rows.values()]:
                if c.task is not None and not c.task.done():
                    c.send(disconnect_frame(c.version))
            for c in list(clients.values()) + pubs + [r.c for r in rows.values()]:
                if c.task is not None:
                    await c.ended(60.0)

    workers: list = []
    try:
        asyncio.run(drive())
        # the launcher's children, then SIGTERM to the launcher alone
        workers = _children(launcher.pid)
        check(len(workers) == CLUSTER_WORKERS, f"{CLUSTER_CELL}: the launcher's children {workers}")
        t0 = time.perf_counter()
        launcher.send_signal(signal.SIGTERM)
        try:
            rc = launcher.wait(timeout=120)
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"{CLUSTER_CELL}: the launcher did not exit within 120 s of SIGTERM") from None
        t_exit = time.perf_counter() - t0
        left = [pid for pid in workers if os.path.exists(f"/proc/{pid}")]
        check(not left, f"{CLUSTER_CELL}: worker processes {left} outlived the launcher")
        check(rc == 0, f"{CLUSTER_CELL}: the launcher exited {rc}:\n{_tail(out_path)}")
    finally:
        # a failed phase still ends every process it started: the
        # launcher's SIGTERM ends its workers, SIGKILL whatever is left
        if launcher.poll() is None:
            workers = workers or _children(launcher.pid)
            launcher.send_signal(signal.SIGTERM)
            try:
                launcher.wait(timeout=30)
            except subprocess.TimeoutExpired:
                launcher.kill()
                launcher.wait()
        for pid in workers:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
    spread = {w: sum(1 for x in info["sub_worker"].values() if x == w) for w in range(CLUSTER_WORKERS)}
    log(f"phase {CLUSTER_CELL}: python -m mqtt_tpu_torch serve --workers {CLUSTER_WORKERS} on {device}, every "
        f"worker counting peers {CLUSTER_WORKERS - 1} after {info['up']:.3f} s; {n_filters} config 2 filters over "
        f"{n_conns} connections (subscribers by worker {spread}; dealt in {info['deal_s']:.3f} s, no connection "
        f"with two filters one topic matches): SUBSCRIBE leg {info['subscribe_s']:.3f} s in one burst (all "
        f"SUBACKs {info['subscribe_acked_s']:.3f} s, every worker's interest at the others {info['presence_s']:.3f} s "
        f"more, every worker's fold {info['fold_s']:.3f} s more; not counted: the drain wait after the SUBACKs "
        f"{info['drain_s']:.3f} s); publishers by worker "
        f"{sorted(info['pub_worker'].values())}; {card}")
    READINGS["cluster subscribe s"] = info["subscribe_s"]
    for i, r in enumerate(info["waves"]):
        READINGS[f"cluster wave {i + 1} publishes/s"] = r["n_pub"] / r["wall"]
        dev = {w: x["device"] for w, x in r["routes"].items()}
        log(f"phase {CLUSTER_CELL} wave {i + 1}: ok {r['n_pub']} publishes, {r['n_del']} deliveries, every frame the "
            f"host walk's; {r['n_pub'] / r['wall']:.1f} publishes/s, {r['n_del'] / r['wall']:.1f} deliveries/s "
            f"(wall {r['wall']:.3f} s); {r['crossed']} deliveries ({r['crossed'] / max(1, r['n_del']):.4f}) crossed "
            f"workers; resolved on each worker's card {dev}; sheds {r['shed']['sheds']}; {card}")
    for w, r in sorted(info["rows"].items()):
        g = {k[len("matcher/breaker/"):]: v for k, v in r.items() if k.startswith("matcher/breaker/")}
        c = {k[len("cluster/"):]: v for k, v in r.items() if k.startswith("cluster/") and "/" not in k[8:]}
        log(f"  {CLUSTER_CELL} worker {w}: $SYS cluster {c}; matcher batches {r['matcher/batches']}; breaker "
            f"state {g.get('state')}, failures {g.get('failures')}, fallback_batches {g.get('fallback_batches')}; {card}")
        check(c.get("peers") == str(CLUSTER_WORKERS - 1), f"{CLUSTER_CELL} worker {w}: peers {c.get('peers')}")
        check(c.get("dropped_forwards") == "0" and c.get("dropped_qos_forwards") == "0",
              f"{CLUSTER_CELL} worker {w}: dropped forwards {c}")
        check(int(r["matcher/batches"]) > 0, f"{CLUSTER_CELL} worker {w}: no device batch")
        check(g.get("state") == "closed" and g.get("fallback_batches") == "0" and g.get("failures") == "0",
              f"{CLUSTER_CELL} worker {w}: breaker {g}")
    for i, r in enumerate(info["waves"]):
        check(r["shed"]["sheds"] == 0, f"{CLUSTER_CELL} wave {i + 1}: sheds {r['shed']}")
        for w, x in r["routes"].items():
            check(x["device"] > 0 and x["breaker"] == 0, f"{CLUSTER_CELL} wave {i + 1} worker {w}: routes {x}")
    status, body = info["health"]
    check(status == 200 and body.get("cluster", {}).get("peers") == CLUSTER_WORKERS - 1,
          f"{CLUSTER_CELL}: worker 0's /healthz {status} {body.get('cluster')}")
    log(f"  {CLUSTER_CELL}: SIGTERM to the launcher -> exit 0 in {t_exit:.3f} s, none of its {len(workers)} workers "
        f"left; phase {time.perf_counter() - t_phase:.1f} s; {card}")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return info


SCENARIO_CELL = "scenarios"
CHAOS_CELL = "chaos"
CHAOS_SEED = 19
CHAOS_CLIENTS = 32  # subscriber connections, each on its own filters
CHAOS_OWN = 500  # ch/<client>/<j>/+ filters a client: one client's, one topic each
CHAOS_FAN = 50  # fan/+/<client % 8>/<j> filters a client: eight clients' a topic
CHAOS_PUBLISHERS = 4  # QoS 1, v4 and v5
CHAOS_ROUNDS = 24  # rounds under the hook: each publisher's share of a round, its PUBACKs, a churn and a fold
CHAOS_AFTER = 6  # rounds after the hook is gone
CHAOS_PER_ROUND = 32  # publishes a publisher sends a round
# the fault at each injector dispatch (a stage batch): every kind once, a
# success between any two, then three errors in a row that trip the breaker
CHAOS_AT = {2: "error", 4: "issue_error", 6: "corrupt", 8: "slow", 10: "hang", 13: "error", 14: "error", 15: "error"}
STRESS_CELL = "stress"
# mqtt-stresser's rows (bench.py:1633-1640): clients x QoS 0 messages of 64 B, a topic a client
STRESS_ROWS = ((2, 10_000), (10, 10_000), (100, 1_000))  # the 100-client row cut from 10,000 for the time limit


def phase_scenarios(torch, device, card: str) -> dict:
    """Phase ``scenarios``: the scenario lab's whole catalog
    (``mqtt_tpu_torch.scenarios``, the JAX package's six rows with their
    seeds, objectives and params) through ``run_matrix`` on ``device``, one
    row a call so each row's launches are its own; every broker a driver
    builds runs its device planes there. Every row must pass (its oracle's
    ``require``s and its SLO gate; a crashed driver is a failed row), and
    ``tenant_rekey`` must launch K6 (its publishes' decrypt leg, its
    re-encryptions and the re-key's re-seal). Logs each row's oracle
    tallies, metrics and wall. Returns the phase's launches by kernel."""
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.scenarios import run_matrix, scenario_names

    t_phase = time.perf_counter()
    kernels.reset_launches()
    by_row: dict = {}
    for name in scenario_names():
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        (row,) = run_matrix([name], device=str(device))
        wall = time.perf_counter() - t0
        by_row[name] = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v - before[k]}
        READINGS[f"scenario {name} wall s"] = wall
        log(f"phase {SCENARIO_CELL} {name}: passed {row['passed']}, SLO gate {row['slo']['passed']}, oracle "
            f"{row['oracle']}, metrics {row['metrics']}, failures {row['failures'] or 'none'}; driver wall "
            f"{row['wall_s']} s, row {wall:.1f} s; launches {by_row[name] or 'none'}; {card}")
        check(not any(f.startswith("driver crashed") for f in row["failures"]),
              f"{SCENARIO_CELL} {name}: {row['failures']}")
        check(row["passed"] and row["slo"]["passed"], f"{SCENARIO_CELL} {name} failed: {row['failures']}, "
              f"SLO {[o for o in row['slo']['objectives'] if o.get('breached')]}")
    counted = device.type == "cuda"
    check(by_row["tenant_rekey"].get("keystream", 0) > 0 or not counted,
          f"{SCENARIO_CELL}: tenant_rekey never launched keystream")
    launches = dict(kernels.LAUNCHES)
    log(f"phase {SCENARIO_CELL}: {len(by_row)} rows passed on {device}; launches {by_row['tenant_rekey']} in "
        f"tenant_rekey, {({k: v for k, v in launches.items() if v})} in all; phase {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")
    return launches


def chaos_filters(c: int) -> list:
    """Client ``c``'s filters: ``CHAOS_OWN`` of its own and ``CHAOS_FAN``
    it shares with the clients of its residue mod 8; no topic matches two
    filters of one client (the device and the walk merge a client's
    filters in different orders, ROADMAP Queue C item 4)."""
    return ([f"ch/{c}/{j}/+" for j in range(CHAOS_OWN)]
            + [f"fan/+/{c % 8}/{j}" for j in range(CHAOS_FAN)])


def phase_chaos(torch, device, card: str, n_rounds: int = CHAOS_ROUNDS, n_after: int = CHAOS_AFTER) -> dict:
    """Phase ``chaos``: a port ``Server`` on ``device`` with the device
    matcher under its breaker (``ResilientMatcher``; the verify sample
    reads every topic of a batch, the watchdog at 1 s, the half-open
    probe on the wall clock past the run) and ``ChaosHook`` armed from a
    fixed seed with each fault kind pinned to a dispatch (``CHAOS_AT``),
    over TCP. ``CHAOS_CLIENTS`` subscribers SUBSCRIBE ``chaos_filters``
    (two filter shapes: the compact route, K2, with a pinned capacity);
    ``CHAOS_PUBLISHERS`` QoS 1 publishers send a wave of ``n_rounds``
    rounds, each round's PUBACKs awaited, then one client's
    UNSUBSCRIBE/SUBSCRIBE and a fold (K3). The hook is uninstalled, two
    forced probes must close the breaker the last three faults tripped,
    and ``n_after`` more rounds run on the device with no fallback.
    Checks: every subscriber's (topic, payload) deliveries are the walk's
    for the round they were sent in; the breaker's failures by kind are
    the injector's counts (an issue failure reads as an error); the last
    rounds resolve on the device with 0 fallback batches; no table
    buffer is still pinned. Logs ``fold_copies`` before and after the
    chaos. Returns the phase's launches by kernel."""
    from collections import Counter

    from mqtt_tpu_torch.hooks.auth import AllowHook
    from mqtt_tpu_torch.hooks.chaos import ChaosHook, ChaosOptions
    from mqtt_tpu_torch.listeners import TCP, Config
    from mqtt_tpu_torch.ops import kernels
    from mqtt_tpu_torch.server import Options, Server

    t_phase = time.perf_counter()
    kernels.reset_launches()
    rng = random.Random(CHAOS_SEED)
    srv = Server(Options(device=str(device), device_matcher=True, gc_tuning=False,
                         matcher_opts={"max_levels": 4, "background": False, "compact_capacity": 4096},
                         breaker_watchdog_ms=1000.0, breaker_verify_sample=1 << 16,
                         breaker_probe_backoff_ms=3_600_000.0, breaker_probe_backoff_max_ms=3_600_000.0))
    srv.add_hook(AllowHook())
    hook = ChaosHook()
    srv.add_hook(hook, ChaosOptions(server=srv, seed=CHAOS_SEED, at=dict(CHAOS_AT), hang_s=60.0, slow_s=0.05))
    srv.add_listener(TCP(Config(type="tcp", id="chaos", address="127.0.0.1:0")))
    info: dict = {}

    def topic() -> str:
        c = rng.randrange(CHAOS_CLIENTS)
        if rng.random() < 0.5:
            return f"ch/{c}/{rng.randrange(CHAOS_OWN)}/x{rng.randrange(4)}"
        return f"fan/y{rng.randrange(4)}/{c % 8}/{rng.randrange(CHAOS_FAN)}"

    async def main() -> None:
        await srv.serve()
        host, port = srv.listeners.get("chaos").address().rsplit(":", 1)
        rm = srv.matcher
        dm = rm.inner.inner
        check(rm.inner is hook.faulty, f"{CHAOS_CELL}: the hook did not install beneath the breaker")
        subs = {f"k{c}": WireClient(f"k{c}", 4 + c % 2) for c in range(CHAOS_CLIENTS)}
        pubs = [WireClient(f"kp{i}", 4 + i % 2) for i in range(CHAOS_PUBLISHERS)]
        for cl in list(subs.values()) + pubs:
            await cl.open(host, int(port))
            cl.send(connect_frame(cl.name, cl.version, keepalive=0))
            await cl.wait_frames(1, 60.0)
        t0 = time.perf_counter()
        for c, (name, cl) in enumerate(subs.items()):
            flts = chaos_filters(c)
            for k in range(0, len(flts), 100):
                cl.send(subscribe_frame(1 + k // 100, [(f, 0, 0) for f in flts[k:k + 100]], cl.version))
            await cl.wait_frames(1 + (len(flts) + 99) // 100, 120.0)
        dm.flush()
        info["subscribe_s"] = time.perf_counter() - t0
        expected = {name: Counter() for name in subs}
        acked = [0] * len(pubs)
        info["fold_copies_before"] = dm.snapshot.stats.fold_copies

        async def round_(r: int) -> None:
            for i, p in enumerate(pubs):
                frames = []
                for _ in range(CHAOS_PER_ROUND):
                    t = topic()
                    body = f"r{r}p{i}n{acked[i] + len(frames)}".encode()
                    for cid in srv.topics.subscribers(t).subscriptions:
                        expected[cid][(t, body)] += 1
                    frames.append(publish_frame(t, body, 1, 1 + (acked[i] + len(frames)) % 0xFFFF, version=p.version))
                p.send(b"".join(frames))
            for i, p in enumerate(pubs):
                acked[i] += CHAOS_PER_ROUND
                await p.wait_frames(1 + acked[i], 120.0)
            # every delivery of the round first: a batch resolves (and its
            # sample is verified) before the churn mutates the trie, where
            # a mismatch would read as indeterminate and go uncounted
            for name, cl in subs.items():
                n = sum(expected[name].values())
                await _until(lambda cl=cl, n=n: sum(1 for f in cl.frames() if f[0] >> 4 == 3) >= n, 120.0,
                             f"{CHAOS_CELL}: {name}'s deliveries of round {r}")
            # a churn between batches, folded onto the device table (K3)
            c = r % CHAOS_CLIENTS
            cl = subs[f"k{c}"]
            j = r % CHAOS_OWN
            n0 = len(cl.frames())
            cl.send(unsubscribe_frame(0xF000 + r, [f"ch/{c}/{j}/+"], cl.version)
                    + subscribe_frame(0xF100 + r, [(f"ch/{c}/{j}/+", 0, 0)], cl.version))
            await _until(lambda: sum(1 for f in cl.frames()[n0:] if f[0] >> 4 in (9, 11)) >= 2, 60.0,
                         f"{CHAOS_CELL}: k{c}'s churn acks")
            dm.flush()

        def routes() -> dict:
            g = rm.breaker_gauges()
            return {"batches": dm.stats.as_dict()["batches"], "fallback_batches": g["fallback_batches"],
                    "compact_batches": dm.snapshot.stats.compact_batches}

        t0 = time.perf_counter()
        for r in range(n_rounds):
            await round_(r)
        info["chaos_s"] = time.perf_counter() - t0
        info["tripped"] = rm.breaker.state
        info["injected"] = hook.injected
        t0 = time.perf_counter()
        hook.uninstall()
        info["uninstall_s"] = time.perf_counter() - t0
        await _until(lambda: rm.pool.wedged == 0, 60.0, f"{CHAOS_CELL}: the released hang's guard thread")
        info["pins_after_uninstall"] = [b.pins for b in dm.snapshot._tables]
        info["probes"] = [rm.probe_now(), rm.probe_now()]
        info["state_after_probes"] = rm.breaker.state
        r0 = routes()
        t0 = time.perf_counter()
        for r in range(n_rounds, n_rounds + n_after):
            await round_(r)
        info["after_s"] = time.perf_counter() - t0
        r1 = routes()
        info["after"] = {k: r1[k] - r0[k] for k in r0}
        info["gauges"] = rm.breaker_gauges()
        info["fold_copies_after"] = dm.snapshot.stats.fold_copies
        info["folds"] = dm.snapshot.stats.folds
        n_want = {name: sum(e.values()) for name, e in expected.items()}
        await asyncio.sleep(0.2)  # a delivery past the walk's would arrive now
        bad = []
        for name, cl in subs.items():
            got = Counter((p["topic"], p["payload"]) for p in _publishes(cl, 0))
            if got != expected[name]:
                bad.append((name, sum((got - expected[name]).values()), sum((expected[name] - got).values())))
        check(not bad, f"{CHAOS_CELL}: deliveries differ from the walk's (client, extra, missing): {bad[:8]}")
        info["deliveries"] = sum(n_want.values())
        info["publishes"] = sum(acked)
        for cl in list(subs.values()) + pubs:
            cl.writer.close()
        await srv.close()
        info["pins_end"] = [b.pins for b in dm.snapshot._tables]

    asyncio.run(main())
    g, inj = info["gauges"], info["injected"]
    kinds = {k[len("failures_"):]: int(v) for k, v in g.items() if k.startswith("failures_") and int(v)}
    want = {"error": inj.get("error", 0) + inj.get("issue_error", 0), "corrupt": inj.get("corrupt", 0),
            "hang": inj.get("hang", 0)}
    launches = dict(kernels.LAUNCHES)
    log(f"phase {CHAOS_CELL}: ok {info['publishes']} QoS 1 publishes from {CHAOS_PUBLISHERS} publishers, "
        f"{info['deliveries']} deliveries to {CHAOS_CLIENTS} subscribers ({CHAOS_CLIENTS * (CHAOS_OWN + CHAOS_FAN)} "
        f"filters, SUBSCRIBE leg {info['subscribe_s']:.3f} s), every one the walk's; injected {inj} (seed "
        f"{CHAOS_SEED}, at {CHAOS_AT}); breaker after the chaos {info['tripped']}, failures by kind {kinds}, "
        f"trips {g['trips']}, probes {g['probes']} (forced {info['probes']}), fallback_batches "
        f"{g['fallback_batches']}, verified_batches {g['verified_batches']}; chaos rounds {info['chaos_s']:.3f} s, "
        f"uninstall {info['uninstall_s']:.3f} s; {card}")
    log(f"  {CHAOS_CELL} after the hook: {n_after} rounds {info['after']} in {info['after_s']:.3f} s, breaker "
        f"{g['state']}; fold_copies before the chaos {info['fold_copies_before']}, after {info['fold_copies_after']} "
        f"({info['folds']} folds); pins after uninstall {info['pins_after_uninstall']}, at the end "
        f"{info['pins_end']}; launches {({k: v for k, v in launches.items() if v})}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    check(info["tripped"] == "open", f"{CHAOS_CELL}: the last three faults did not trip the breaker")
    check(all(inj.get(k, 0) >= 1 for k in ("error", "issue_error", "corrupt", "slow", "hang")),
          f"{CHAOS_CELL}: a fault kind was never injected: {inj}")
    check(kinds == want, f"{CHAOS_CELL}: the breaker's failures by kind {kinds} are not the injector's {want}")
    check(info["probes"] == [True, True] and g["state"] == "closed", f"{CHAOS_CELL}: the breaker did not close: "
          f"probes {info['probes']}, state {g['state']}")
    check(info["after"]["fallback_batches"] == 0 and info["after"]["batches"] > 0,
          f"{CHAOS_CELL}: after the hook the device did not resolve the rounds alone: {info['after']}")
    check(not any(info["pins_after_uninstall"]) and not any(info["pins_end"]),
          f"{CHAOS_CELL}: a table buffer is still pinned: {info['pins_after_uninstall']} {info['pins_end']}")
    counted = device.type == "cuda"
    check(info["after"]["compact_batches"] > 0 or not counted, f"{CHAOS_CELL}: no batch took the compact route")
    check((launches["flat_match_compact"] > 0 and launches["scatter_rows"] > 0) or not counted,
          f"{CHAOS_CELL}: launches {launches}")
    return launches


async def _until(cond, limit: float, what: str) -> None:
    deadline = time.monotonic() + limit
    while not cond():
        check(time.monotonic() < deadline, f"{what}: not within {limit} s")
        await asyncio.sleep(0.005)


class StressRows(SysRows):
    """``SysRows`` plus the broker's ``messages`` rows."""

    async def open(self, host: str, port: int) -> None:
        await super().open(host, port)
        self.c.send(subscribe_frame(2, [(self.PREFIX + "messages/#", 0, 0)], 4))
        await self.c.wait_frames(3, 60.0)


@contextlib.contextmanager
def stress_broker(device, root: str, tag: str, **env_extra):
    """``python -m mqtt_tpu_torch.stress --serve --device-matcher --device
    <device>`` in a process of its own (its ``$SYS`` ticks each second,
    ``env_extra`` in its environment): yields ``(port, info)`` once it
    printed READY; on leaving, SIGTERM must end it with exit 0
    (``info["exit_s"]``)."""
    (port,) = _free_ports(1)
    out_path = os.path.join(root, f"{tag}.log")
    env = dict(os.environ, MQTT_TPU_SYS_RESEND_S="1", **env_extra)
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "mqtt_tpu_torch.stress", "--serve", "--device-matcher",
                                 "--device", str(device), "--broker", f"127.0.0.1:{port}"],
                                cwd=HERE, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=out, env=env)
    info: dict = {"log": out_path}
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline().strip()
        check(line == b"READY", f"{STRESS_CELL} {tag}: the broker did not start ({line!r}):\n{_tail(out_path)}")
        info["ready_s"] = time.perf_counter() - t0
        yield port, info
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            rc = None
        info["exit_s"] = time.perf_counter() - t0
        check(rc == 0, f"{STRESS_CELL} {tag}: SIGTERM ended the broker with {rc}:\n{_tail(out_path)}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_stress(torch, device, card: str, rows: tuple = STRESS_ROWS) -> dict:
    """Phase ``stress``: the stress driver's broker, ``python -m
    mqtt_tpu_torch.stress --serve --device-matcher --device <device>``,
    in processes of its own (``stress_broker``). First the mqtt-stresser
    rows ``rows`` (clients x QoS 0 messages of 64 B, each client on its
    own topic, ``run_stress``): every message must be received. That
    broker runs with ``MQTT_TPU_OVERLOAD_CONTROL=0`` (the driver's own
    switch): at the default governor the stresser's unpaced blast fills
    the stage, and the governor sheds QoS 0 publishes and evicts the
    slowest readers, by design. Those topics hold no wildcard, so the
    matcher answers them from its exact map on the host, as the JAX
    package does: no kernel. Then, on a broker at the default governor,
    one ``run_storm`` at its defaults (16 publishers x 2,000, half QoS 1,
    seed 7) against a subscriber on ``storm/#``, a wildcard the broker
    matches on the card. Checks: the publishers' acks account for every
    offered QoS 1 publish (admitted + shed), no publisher was
    disconnected, every publish the broker admitted (offered less the
    governor's ``overload/sheds``) was delivered; the broker's ``$SYS``
    matcher batches are above 0 and its breaker is closed with no failure
    and no fallback batch; SIGTERM ends each broker with exit 0. The
    kernels run in the brokers' processes: they are not in the kernels
    line."""
    import shutil
    import tempfile

    from mqtt_tpu_torch import stress

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mqtt-torch-stress-")
    _raise_nofile(4 * max(c for c, _ in rows) + 256)
    info: dict = {"rows": []}
    with stress_broker(device, root, "stresser", MQTT_TPU_OVERLOAD_CONTROL="0") as (port, b1):

        async def stresser() -> None:
            for n_clients, n_msgs in rows:
                try:
                    r = await stress.run_stress("127.0.0.1", port, n_clients, n_msgs, payload_size=64,
                                                timeout=600.0)
                except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError) as e:
                    raise PhaseFailed(f"{STRESS_CELL}: the mqtt-stresser row of {n_clients} clients x {n_msgs} "
                                      f"did not receive every message ({e!r}); the broker's log:\n"
                                      f"{_tail(b1['log'])}") from e
                log(f"  {STRESS_CELL} row {n_clients} x {n_msgs}: wall {r['wall_s']} s; {card}")
                info["rows"].append(r)

        asyncio.run(stresser())
    with stress_broker(device, root, "storm") as (port, b2):

        async def storm() -> None:
            sysr = StressRows(STRESS_CELL)
            await sysr.open("127.0.0.1", port)
            r0 = await sysr.fresh()
            info["storm"] = await stress.run_storm("127.0.0.1", port)
            info["r0"], info["r1"] = r0, await sysr.fresh()
            sysr.c.writer.close()

        asyncio.run(storm())
    for r in info["rows"]:
        READINGS[f"stress {r['clients']} clients aggregate msgs/s"] = r["aggregate_msgs_per_sec"]
        log(f"phase {STRESS_CELL} mqtt-stresser {r['clients']} clients x {r['msgs_per_client']} QoS 0 messages of "
            f"64 B: every message received; publish median {r['publish_median_per_sec']}/s (min "
            f"{r['publish_min_per_sec']}, max {r['publish_max_per_sec']}), receive median "
            f"{r['receive_median_per_sec']}/s (min {r['receive_min_per_sec']}, max {r['receive_max_per_sec']}), "
            f"aggregate {r['aggregate_msgs_per_sec']} msgs/s, wall {r['wall_s']} s (wildcard-free topics: the "
            f"matcher's exact map on the host, no kernel, in either package); {card}")
    s, r0, r1 = info["storm"], info["r0"], info["r1"]
    sheds = int(r1["overload/sheds"]) - int(r0["overload/sheds"])
    dropped = int(r1["messages/dropped"]) - int(r0["messages/dropped"])
    batches = int(r1["matcher/batches"])
    g = {k[len("matcher/breaker/"):]: v for k, v in r1.items() if k.startswith("matcher/breaker/")}
    admitted = s["offered"]["total"] - sheds
    READINGS["stress storm offered/s"] = s["offered_rate_per_sec"]
    log(f"phase {STRESS_CELL} storm: offered {s['offered']} at {s['offered_rate_per_sec']}/s over "
        f"{s['storm_wall_s']} s; QoS 1 acked admitted {s['acked_admitted_qos1']}, shed 0x97 {s['shed_qos1_0x97']}; "
        f"the governor's sheds {sheds}, messages dropped {dropped}; admitted {admitted}, delivered "
        f"{s['delivered']} (delivery p99 {s['delivery_p99_ms']} ms); publishers disconnected "
        f"{s['publishers_disconnected']}; $SYS matcher batches {batches}, topics {r1.get('matcher/topics')}, "
        f"host_fast {r1.get('matcher/host_fast')}; brokers READY in {b1['ready_s']:.1f} and {b2['ready_s']:.1f} s, "
        f"SIGTERM -> exit 0 in {b1['exit_s']:.3f} and {b2['exit_s']:.3f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    breaker_summary(g, STRESS_CELL + " storm broker (read over $SYS)", card)
    check(s["acked_admitted_qos1"] + s["shed_qos1_0x97"] == s["offered"]["qos1"],
          f"{STRESS_CELL}: QoS 1 acks {s['acked_admitted_qos1']} + {s['shed_qos1_0x97']} != {s['offered']['qos1']}")
    check(s["publishers_disconnected"] == 0, f"{STRESS_CELL}: {s['publishers_disconnected']} publishers disconnected")
    check(s["delivered"] == admitted, f"{STRESS_CELL}: delivered {s['delivered']} of {admitted} admitted publishes")
    check(batches > 0, f"{STRESS_CELL}: the broker's matcher counted no device batch")
    shutil.rmtree(root, ignore_errors=True)
    return info


CFG5_CELL = "cfg5-churn"
CFG5_SUBS = 200_000  # bench.py's config 5 at full size (bench.py:2452)
CFG5_RETAINED = 5_000
CFG5_BATCHES = 256  # batches of MAIN_BATCH issued one ahead under the churn
CFG5_CHURN_RATE = 2_000  # bench.py's churn: ~2k mutations/s
CFG1_CELL = "cfg1-exact"
CFG1_BATCHES = 30  # bench.py's iterations for config 1 (time_matcher)
BENCH_SEED = 7  # bench.py's generator seed (bench.py:2329)


def canon(s):
    """Order-free digest of a Subscribers set (bench.py:57)."""
    return (
        {c: (sub.qos, tuple(sorted(sub.identifiers.items()))) for c, sub in s.subscriptions.items()},
        {f: set(m) for f, m in s.shared.items()},
        set(s.inline_subscriptions),
    )


def _canon_equal(index, topics: list, results: list, what: str) -> None:
    """Every result (a view materialized) must digest to the walk's."""
    from mqtt_tpu_torch import native

    view_t = native.accel().SubscribersView
    check(len(results) == len(topics), f"{what}: {len(results)} results for {len(topics)} topics")
    for topic, got in zip(topics, results):
        if isinstance(got, view_t):
            got = got.materialize()
        check(canon(got) == canon(index.subscribers(topic)), f"{what}: mismatch on {topic!r}")


def build_cfg5(n_subs: int, n_retained: int, rng: random.Random):
    """bench.py's config 5 (bench.py:752-781): the trie, its retained
    corpus, the topic generator and the three vocabularies."""
    from mqtt_tpu_torch.packets import PUBLISH, FixedHeader, Packet, Subscription
    from mqtt_tpu_torch.topics import TopicsIndex

    v0 = [f"region{i}" for i in range(60)]
    v1 = [f"device{i}" for i in range(60)]
    v2 = [f"metric{i}" for i in range(60)]
    index = TopicsIndex()
    for i in range(n_subs):
        parts = [rng.choice(v0), rng.choice(v1), rng.choice(v2)]
        if rng.random() < 0.10:
            parts[rng.randrange(3)] = "+"
        index.subscribe(f"cl{i}", Subscription(filter="/".join(parts), qos=i % 3, identifier=i % 200 + 1))
    for _ in range(n_retained):
        topic = f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"
        index.retain_message(Packet(fixed_header=FixedHeader(type=PUBLISH, retain=True), topic_name=topic,
                                    payload=b"r"))

    def topic_gen():
        return f"{rng.choice(v0)}/{rng.choice(v1)}/{rng.choice(v2)}"

    return index, topic_gen, (v0, v1, v2)


def phase_cfg5(torch, device, rec: Optional[dict] = None, n_subs: int = CFG5_SUBS,
               n_retained: int = CFG5_RETAINED, n_batches: int = CFG5_BATCHES) -> dict:
    """bench.py's config 5 on the card under live churn (module docstring,
    phase 21): the launch counts are set to 0 just before the churned run
    and read just after it. ``rec`` (phase 4's record) takes the worst
    error of the kernels held at this table. Returns the launches."""
    import threading

    from mqtt_tpu_torch import DeltaMatcher, Subscription
    from mqtt_tpu_torch.ops import kernels

    rng = random.Random(BENCH_SEED)
    gc.disable()
    try:
        t0 = time.perf_counter()
        index, gen, (v0, v1, v2) = build_cfg5(n_subs, n_retained, rng)
        t1 = time.perf_counter()
        dm = DeltaMatcher(index, max_levels=4, out_slots=64, rebuild_after=256, rebuild_interval=0.2,
                          background=True, device=device)
        t2 = time.perf_counter()
    finally:
        _settle_gc()
    fl = dm.snapshot.index
    log(f"phase setup {CFG5_CELL}: ok {n_subs} subscriptions and {n_retained} retained, trie {t1 - t0:.1f} s, "
        f"index {t2 - t1:.1f} s, entries {fl.n_entries}, P {fl.num_patterns}, S {fl.table.shape[0]}")
    stop = threading.Event()
    mutations = [0]
    churn_s = [0.0]

    def churn() -> None:
        """bench.py's mutations (bench.py:791-803) on a schedule of
        ``CFG5_CHURN_RATE`` a second: bench.py sleeps 0.5 ms after each, but
        a thread that sleeps waits up to the interpreter's switch interval
        (5 ms) for the GIL while the matching thread runs, so it catches
        up on the mutations due instead."""
        r = random.Random(9)
        i = n_subs
        t0 = time.perf_counter()
        while not stop.is_set():
            due = int((time.perf_counter() - t0) * CFG5_CHURN_RATE)
            while mutations[0] < due and not stop.is_set():
                parts = [r.choice(v0), r.choice(v1), r.choice(v2)]
                if r.random() < 0.5:
                    index.subscribe(f"m{i}", Subscription(filter="/".join(parts), qos=1))
                    i += 1
                else:
                    index.unsubscribe("/".join(parts), f"m{r.randint(n_subs, max(n_subs + 1, i))}")
                mutations[0] += 1
            time.sleep(0.0005)
        churn_s[0] = time.perf_counter() - t0

    batches = [[gen() for _ in range(MAIN_BATCH)] for _ in range(4)]
    st = dm.stats
    closed = False
    try:
        th = threading.Thread(target=churn, name="cfg5-churn", daemon=True)
        kernels.reset_launches()
        th.start()
        try:
            dm.match_topics(batches[0])  # warm-up
            fb0, topics0 = st.host_fallbacks, st.topics
            folds0, rebuilds0, copies0 = st.folds, st.rebuilds, st.fold_copies
            lat: list = []
            scans = scanned = 0
            t0 = time.perf_counter()
            pending = dm.match_topics_async(batches[0])
            for i in range(1, n_batches + 1):
                t1 = time.perf_counter()
                nxt = dm.match_topics_async(batches[i % len(batches)]) if i < n_batches else None
                pending()
                # the retained wildcard scan rides along (processSubscribe's path)
                scanned += len(index.messages(f"{rng.choice(v0)}/+/{rng.choice(v2)}"))
                scans += 1
                lat.append(time.perf_counter() - t1)
                pending = nxt
            dt = time.perf_counter() - t0
        finally:
            stop.set()
            th.join(timeout=5)
        launches = dict(kernels.LAUNCHES)
        n_topics = st.topics - topics0
        fallbacks = st.host_fallbacks - fb0
        pending_end = dm.pending_deltas
        check(not th.is_alive(), f"{CFG5_CELL}: the churn thread did not stop")
        topics = [gen() for _ in range(MAIN_BATCH)]
        _canon_equal(index, topics, dm.match_topics(topics), f"{CFG5_CELL} after the churn")
        dm.flush()
        _canon_equal(index, topics, dm.match_topics(topics), f"{CFG5_CELL} after the churn, folded")
        on_cuda = device.type == "cuda"
        check(launches["flat_probe_ranges"] + launches["flat_match_compact"] > 0 or not on_cuda,
              f"{CFG5_CELL}: the churned run launched neither K1 nor K2")
        check(st.folds - folds0 > 0, f"{CFG5_CELL}: the churn was never folded")
        check(launches["scatter_rows"] > 0 or not on_cuda, f"{CFG5_CELL}: the folds launched no scatter_rows")
        log(f"phase {CFG5_CELL}: ok {n_batches} batches of {MAIN_BATCH} under {mutations[0]} mutations "
            f"({mutations[0] / churn_s[0]:.1f}/s over the churn's {churn_s[0]:.3f} s), "
            f"{n_batches * MAIN_BATCH / dt:.1f} matches/s, batch p50 "
            f"{_pct(lat, 0.5) * 1e3:.3f} ms p99 {_pct(lat, 0.99) * 1e3:.3f} ms max {max(lat) * 1e3:.3f} ms, "
            f"folds {st.folds - folds0}, rebuilds {st.rebuilds - rebuilds0}, fold_copies {st.fold_copies - copies0}, "
            f"host_fallback_ratio {fallbacks / max(1, n_topics):.5f} ({fallbacks} of {n_topics}), pending deltas "
            f"at the end {pending_end}, {scans} retained scans ({scanned} messages); a batch of {MAIN_BATCH} "
            f"after the churn equal to the walk (canon) before and after a flush")
        log(f"  {CFG5_CELL} the matcher over the phase: {fold_summary(dm)}")
        log(f"  {CFG5_CELL} launches on its path: {launches}")
        if rec is not None:
            for name, r in phase_kernels(torch, [{"dm": dm, "topic_gen": gen, "name": CFG5_CELL}], device).items():
                rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], r["max_abs_err"])
        dm.close()
        closed = True
        pins = [b.pins for b in dm.snapshot._tables or ()]
        check(not any(pins), f"{CFG5_CELL}: a table buffer is still pinned after close: {pins}")
        log(f"  {CFG5_CELL} pins after close {pins}")
    finally:
        if not closed:
            dm.close()
    return launches


def build_cfg1(rng: random.Random):
    """bench.py's config 1 (bench.py:152-169): 10,000 exact filters over
    3-level topics of 40 segments, and a generator over them."""
    from mqtt_tpu_torch.packets import Subscription
    from mqtt_tpu_torch.topics import TopicsIndex

    v = [f"seg{i}" for i in range(40)]
    index = TopicsIndex()
    filters: set = set()
    while len(filters) < 10_000:
        filters.add("/".join(rng.choice(v) for _ in range(3)))
    for i, f in enumerate(sorted(filters)):
        index.subscribe(f"cl{i}", Subscription(filter=f, qos=0))
    pool = sorted(filters)

    def topic_gen():
        return rng.choice(pool)

    return index, topic_gen


def phase_cfg1(torch, device, rec: Optional[dict] = None, n_batches: int = CFG1_BATCHES) -> dict:
    """bench.py's config 1 through ``TorchMatcher`` (module docstring,
    phase 22): the launch counts are set to 0 just before the parity
    check and the timed batches, and read just after. Returns them."""
    import types

    from mqtt_tpu_torch.ops import TorchMatcher, kernels

    rng = random.Random(BENCH_SEED)
    index, gen = build_cfg1(rng)
    host_topics = [gen() for _ in range(20_000)]
    t0 = time.perf_counter()
    for t in host_topics:
        index.subscribers(t)
    host_rate = len(host_topics) / (time.perf_counter() - t0)
    m = TorchMatcher(index, max_levels=4, device=device)
    m.rebuild()
    kernels.reset_launches()
    parity = [gen() for _ in range(32)]  # bench.py's parity_check
    _canon_equal(index, parity, m.match_topics(parity), f"{CFG1_CELL} parity_check")
    batches = [[gen() for _ in range(MAIN_BATCH)] for _ in range(4)]
    m.match_topics(batches[0])  # warm-up
    fast0, fb0 = m.stats.host_fast, m.stats.host_fallbacks
    t0 = time.perf_counter()
    pending = m.match_topics_async(batches[0])
    results = []
    for i in range(1, n_batches + 1):
        nxt = m.match_topics_async(batches[i % len(batches)]) if i < n_batches else None
        results.append(pending())
        pending = nxt
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for i, res in enumerate(results[:4]):
        _canon_equal(index, batches[i % len(batches)], res, f"{CFG1_CELL} timed batch {i}")
    rate = n_batches * MAIN_BATCH / dt
    fast, fallbacks = m.stats.host_fast - fast0, m.stats.host_fallbacks - fb0
    check(m.index.wildcard_free and fast == n_batches * MAIN_BATCH and not fallbacks,
          f"{CFG1_CELL}: {fast} topics from the exact map, {fallbacks} walked, of {n_batches * MAIN_BATCH}")
    log(f"phase {CFG1_CELL}: ok parity_check on 32 topics, {n_batches} batches of {MAIN_BATCH} issued one ahead, "
        f"{rate:.1f} matches/s against the host walk's {host_rate:.1f}/s ({rate / host_rate:.2f}x), "
        f"{fast} from the exact map (wildcard-free: no kernel on this path, as in the JAX matcher), "
        f"launches {launches}")
    if rec is not None:
        cfg = {"dm": types.SimpleNamespace(snapshot=m), "topic_gen": gen, "name": CFG1_CELL}
        for name, r in phase_kernels(torch, [cfg], device).items():
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], r["max_abs_err"])
    return launches


def _bucket_quantiles(text: str, prefix: str) -> tuple:
    """The p50 and p99 (ms, the bucket's upper bound, as
    ``Histogram.percentile`` answers) of one histogram child in a
    Prometheus text, its ``_bucket`` lines named up to the ``le`` label by
    ``prefix``; ``()`` when it has no sample."""
    rows = []
    for line in text.splitlines():
        if line.startswith(prefix):
            le, count = line[len(prefix):].split("} ", 1)
            rows.append((le.split('"')[1], int(float(count.split(" ", 1)[0]))))
    total = rows[-1][1] if rows else 0
    out = []
    for q in (0.5, 0.99):
        rank = max(1, math.ceil(q * total))
        le = next((le for le, acc in rows if acc >= rank), None) if total else None
        if le is not None:
            out.append(round(float(le) * 1e3, 3) if le != "+Inf" else float("inf"))
    return tuple(out)


def _materialize_single(torch, cfg: dict, device) -> None:
    topics = [cfg["topic_gen"]() for _ in range(MAIN_BATCH)]
    phase_materialize(cfg["index"], topics, _fetch_single(torch, cfg, topics, device),
                      f"{cfg['name']} single-device")


def run(device, n_subs: int = N_SUBS, wave: int = WAVE, n_recrypt: int = N_RECRYPT,
        retained_sizes: tuple = RETAINED_SIZES, n_reseal: int = N_RESEAL, card: str = "",
        n_groups: int = N_GROUPS) -> list:
    import torch

    # phase entry's store is written by a process of its own from the start
    fill = start_entry_fill(n_subs, min(BROKER_SESSIONS, n_subs // 2), wave)
    try:
        return _run(torch, device, n_subs, wave, n_recrypt, retained_sizes, n_reseal, card, n_groups, fill)
    finally:
        stop_entry_fill(fill)


def _run(torch, device, n_subs, wave, n_recrypt, retained_sizes, n_reseal, card, n_groups, fill) -> list:
    # off the card (a rehearsal) the wrappers are never called: no counts
    counted = device.type == "cuda"
    mark = [time.perf_counter()]

    def wall(what: str) -> None:
        """Log the wall of the phases since the last mark."""
        now = time.perf_counter()
        log(f"wall {what}: {now - mark[0]:.1f} s; {card}")
        mark[0] = now

    phase_native()
    cfgs = [
        phase_setup("cfg2", build_cfg2, n_subs, 2, device),
        phase_setup("cfg3", build_cfg3, n_subs, 3, device),
    ]
    sharded = []
    try:
        wall("native, setup cfg2 and cfg3")
        rec = phase_kernels(torch, cfgs, device)
        wall("kernels")
        main2 = phase_main(cfgs[0], wave)
        check(main2["flat_probe_ranges"] > 0 or not counted, "cfg2's main path never launched flat_probe_ranges")
        phase_kernel_small_batch(torch, rec, cfgs[0], device, "flat_probe_ranges")
        _materialize_single(torch, cfgs[0], device)
        main3 = phase_main(cfgs[1], wave)
        check(main3["flat_match_compact"] > 0 or not counted, "cfg3's main path never launched flat_match_compact")
        phase_kernel_small_batch(torch, rec, cfgs[1], device, "flat_match_compact")
        _materialize_single(torch, cfgs[1], device)
        wall("main cfg2 and cfg3")
        # the same tries, now served by the sharded matcher alone
        for cfg in cfgs:
            cfg["dm"].close()
        main_sh = []
        for cfg in cfgs:
            if cfg is cfgs[1] and n_subs > SHARDED_CFG3_SUBS:
                cfg = phase_setup_trie("cfg3", build_cfg3, SHARDED_CFG3_SUBS, 3)
            sh = phase_setup_sharded(cfg, device)
            sharded.append(sh)
            main_sh.append(phase_sharded(sh, wave))
            phase_kernels_sharded(torch, rec, sh, device, main=cfg is cfgs[0])
            topics = [cfg["topic_gen"]() for _ in range(MAIN_BATCH)]
            phase_materialize(cfg["index"], topics, _fetch_sharded(torch, sh, topics), f"{cfg['name']} sharded")
            if cfg is cfgs[0]:
                obs = phase_observe(torch, cfg, sh, wave, device, card)
            sh["dm"].close()
            wall(f"sharded {cfg['name']}" + (" and observe" if cfg is cfgs[0] else ""))
    finally:
        for cfg in cfgs:
            cfg["dm"].close()
        for sh in sharded:
            sh["dm"].close()
    del cfgs, sharded
    mainN = phase_namespace(torch, device)
    wall("namespace")
    cfg4 = phase_setup_fanout(n_groups, device, card)
    try:
        main4 = phase_fanout(cfg4, wave, card)
        # K1, K2, K3 (and K7) at the shapes the fan-out's second wave gave
        # them: cfg4's table with the audit wildcard folded in
        rec4 = phase_kernels(torch, [dict(cfg4, name=AUDIT_CELL)], device)
        for name, r in rec4.items():
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], r["max_abs_err"])
    finally:
        cfg4["dm"].close()
    del cfg4
    wall("fanout")
    # the observe phase's registry goes on to the later phases' engines
    cfgP = phase_setup_predicates(n_subs, 9, device, obs["registry"])
    cfgR = phase_setup_recrypt(10, device, obs["registry"])
    try:
        phase_kernels_pr(torch, rec, cfgP, cfgR, device, n_recrypt)
        mainP = phase_predicates(cfgP, wave)
        mainR = phase_recrypt(torch, cfgR, n_recrypt)
        wall("predicates and recrypt")
        cfgP["dm"].close()
        del cfgP
        main_ret = []
        for n in retained_sizes:
            st = phase_setup_retained(n, device)
            main_ret.append(phase_retained(torch, rec, st, device))
            del st
        main_rs = phase_reseal(torch, rec, cfgR, device, n_reseal)
        wall("retained and reseal")
    finally:
        if "cfgP" in locals():
            cfgP["dm"].close()
        cfgR["dm"].close()
    del cfgR
    gc.collect()
    # the broker itself, on the earlier phases' engines' kernels
    main_br = phase_broker(torch, device, card, n_subs, retained_sizes[0], n_recrypt)
    wall("broker")
    gc.collect()
    # the broker's own entry point, in a process of its own on the card,
    # then the same store served by the shard fabric
    phase_entry_fabric(torch, device, card, fill, wall)
    phase_cluster(torch, device, card, n_filters=min(CLUSTER_FILTERS, n_subs), wave=wave)
    wall("cluster")
    # the last modules: the scenario lab, the chaos hook, the stress driver
    main_scn = phase_scenarios(torch, device, card)
    wall("scenarios")
    main_chaos = phase_chaos(torch, device, card)
    wall("chaos")
    phase_stress(torch, device, card)
    wall("stress")
    main_c5 = phase_cfg5(torch, device, rec)
    wall(CFG5_CELL)
    main_c1 = phase_cfg1(torch, device, rec)
    wall(CFG1_CELL)
    phase_observe_render(obs)
    kernels_line = []
    for name in REPLACES:
        launches = (main2[name] + main3[name] + mainN[name] + main4[name] + mainP[name] + mainR[name]
                    + sum(m[name] for m in main_sh) + sum(m[name] for m in main_ret) + main_rs[name]
                    + obs["launches"][name] + main_br[name] + main_scn[name] + main_chaos[name]
                    + main_c5[name] + main_c1[name])
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


def phase_entry_fabric(torch, device, card: str, fill: dict, wall=lambda what: None) -> None:
    """Phases ``entry`` and ``fabric`` on ``fill``'s store. The store is
    copied for ``fabric`` before ``entry`` churns it; the fabric's broker
    restores its copy while ``entry``'s broker restores the store, and
    ``entry``'s waves wait until the fabric's broker has settled.
    ``wall(what)`` is called after each phase."""
    fill_copy(fill, ".fabric")
    fab = start_fabric(device, fill)
    try:
        routes = phase_entry(torch, device, card, fill,
                             before_waves=lambda: fabric_settled(fab))["rows"][0]["routes"]
        wall("entry")
        phase_fabric(torch, device, card, fill, fab, {"device": routes["device"],
                                                      "admission": routes["stage_admission"]})
    finally:
        stop_fabric(fab)
    wall("fabric")


def planes_cost(torch, device, card: str, n_subs: int = N_SUBS, wave: int = WAVE, n_groups: int = N_GROUPS,
                n_recrypt: int = BROKER_RECRYPT) -> dict:
    """The default planes' cost on each ``Server`` path, on one card: cfg4's
    fan-out (``phase_fanout``, its own cfg4 each run), cell ``broker-legs``
    and cell ``entry-cfg2`` (each run from a copy of the same store), each
    run four times with the planes on, off, off, on (``PLANES_OFF``). Every
    run makes its phase's checks. Logs each path's ``READINGS`` with the
    planes on and off, run by run."""
    import shutil

    order = (True, False, False, True)
    runs: dict = {}

    def note(path: str, planes: bool) -> None:
        runs.setdefault(path, []).append((planes, dict(READINGS)))
        log(f"planes cost {path} planes {'on' if planes else 'off'}: {READINGS}; {card}")

    fill = start_entry_fill(n_subs, min(BROKER_SESSIONS, n_subs // 2), wave)
    try:
        for planes in order:
            READINGS.clear()
            cfg4 = phase_setup_fanout(n_groups, device, card)
            try:
                phase_fanout(cfg4, wave, card, planes=planes)
            finally:
                cfg4["dm"].close()
            note("fanout", planes)
        for planes in order:
            READINGS.clear()
            phase_broker(torch, device, card, n_subs, RETAINED_SIZES[0], n_recrypt, planes=planes)
            note(LEGS_CELL, planes)
        pristine = fill_copy(fill, ".pristine")
        for planes in order:
            shutil.rmtree(fill["path"])
            shutil.copytree(pristine, fill["path"])
            READINGS.clear()
            phase_entry(torch, device, card, fill, planes=planes)
            note(ENTRY_CELL, planes)
    finally:
        stop_entry_fill(fill)
    for path, rs in runs.items():
        for key in rs[0][1]:
            on = [r[key] for p, r in rs if p]
            off = [r[key] for p, r in rs if not p]
            log(f"planes cost {path} {key}: on {on}, off {off}; {card}")
    return runs


ONLY_PHASES = ("fabric", "cluster", "scenarios", "chaos", "stress", CFG5_CELL, CFG1_CELL)


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
    ap.add_argument("--groups", type=int, default=N_GROUPS, help="cfg4's $SHARE groups (16 members each)")
    ap.add_argument("--planes-cost", action="store_true",
                    help="only the default planes' cost: each Server path with them on and off in turns")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="only these phases, comma-separated, of " + ", ".join(ONLY_PHASES)
                    + " (fabric: with entry and its store's fill before it)")
    args = ap.parse_args()
    if args.only and not set(args.only) <= set(ONLY_PHASES):
        ap.error(f"--only takes {', '.join(ONLY_PHASES)}, not {args.only}")
    t0 = time.perf_counter()
    try:
        card = phase_card(torch)["card"]
        phase_build()
        time_folds()
        if args.planes_cost:
            phase_native()
            planes_cost(torch, torch.device("cuda"), card, args.subs, args.wave, args.groups)
            log(f"total {time.perf_counter() - t0:.1f} s")
            return 0
        if args.only:
            phase_native()
            device = torch.device("cuda")
            if "fabric" in args.only:
                fill = start_entry_fill(args.subs, min(BROKER_SESSIONS, args.subs // 2), args.wave)
                try:
                    phase_entry_fabric(torch, device, card, fill)
                finally:
                    stop_entry_fill(fill)
            if "cluster" in args.only:
                phase_cluster(torch, device, card, wave=args.wave)
            if "scenarios" in args.only:
                phase_scenarios(torch, device, card)
            if "chaos" in args.only:
                phase_chaos(torch, device, card)
            if "stress" in args.only:
                phase_stress(torch, device, card)
            rec = {k: {"max_abs_err": 0} for k in REPLACES}
            if CFG5_CELL in args.only:
                phase_cfg5(torch, device, rec)
            if CFG1_CELL in args.only:
                phase_cfg1(torch, device, rec)
            log(f"total {time.perf_counter() - t0:.1f} s")
            return 0
        kernels_line = run(torch.device("cuda"), args.subs, args.wave, args.recrypt,
                           tuple(int(x) for x in args.retained.split(",")), args.reseal, card, args.groups)
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
