"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

K1-K3 (the publish matcher), K4-K6 (predicates, re-encryption) and K7-K9
(the subscription-sharded matcher over a mesh whose positions all lie on
the one card: ``make_mesh(["cuda:0"] * 8)``, and ``dryrun_multichip(8)``).
Then the retained-delivery slice's shapes: K1 with one filter over a
retained corpus of up to 2^20 topics, ``RetainedMatchEngine`` on the card
against the walk, and K6's re-seal launch against the CPU engine.

Every test here needs an NVIDIA card with ``sm_90a`` and ``nvcc``; where
there is none it skips with that reason. The tolerance is 0 everywhere but
K5's MEAN, which sums in another order than the plain version and is held
to ``1e-5 * max(1, |want|)``. This module imports neither JAX nor the JAX
package: run it on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_topics.py tests/test_torch_cuda.py``.
"""

import asyncio
import contextlib

import numpy as np

import pytest
import torch

from mqtt_tpu_torch import (
    DeltaMatcher,
    KeyRegistry,
    MatchStage,
    PredicateEngine,
    RecryptEngine,
    RetainedMatchEngine,
    Subscription,
    Tenant,
    TopicsIndex,
    TorchMatcher,
    subscribers_equal,
)
from mqtt_tpu_torch.ops import flat, kernels
from mqtt_tpu_torch.ops import predicates as pops
from mqtt_tpu_torch.ops import recrypt as rops

from test_torch_topics import (
    MAX_LEVELS,
    apply_port_ops,
    corpus_ops,
    corpus_topics,
    ns_corpus_ops,
    ns_topics,
    retain_packet,
    retained_filters,
    retained_ops,
    saturating_ops,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    for source in kernels.SOURCES:
        kernels.library(source)  # builds every csrc/*.cu with nvcc on first use
    return torch.device("cuda")


@pytest.fixture(scope="module")
def index_pair(dev):
    index = apply_port_ops(corpus_ops(7), TopicsIndex())
    fl = flat.build_flat_index(index, max_levels=MAX_LEVELS)
    arrays = flat.device_index_from_numpy(fl.table, fl.pat_kind, fl.pat_depth, fl.pat_mask, dev)
    return fl, arrays


def packed(topics, fl, dev, b_min=16):
    b = len(topics)
    padded = topics + [""] * (flat._bucket(max(1, b), minimum=b_min) - b)
    tok1, tok2, lengths, is_dollar, _ = flat.tokenize_topics(padded, fl.max_levels, fl.salt)
    return torch.from_numpy(flat.pack_tokens(tok1, tok2, lengths, is_dollar)).to(dev)


@pytest.mark.parametrize("b_min", [16, 4096])
def test_probe_ranges_kernel_matches_plain(dev, index_pair, b_min):
    fl, arrays = index_pair
    tokens = packed(corpus_topics(5), fl, dev, b_min)
    before = kernels.LAUNCHES["flat_probe_ranges"]
    got = flat.flat_match_packed(*arrays, tokens, max_levels=fl.max_levels)
    want = flat.flat_match_packed_plain(*arrays, tokens, fl.max_levels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flat_probe_ranges"] == before + 1
    assert torch.equal(got, want)
    assert bool(want[:, -1].any()) and int(want[:, -2].sum()) > 0


@pytest.mark.parametrize("B", [1, 7, 333, 4097])
@pytest.mark.parametrize("P", [0, 1, 2, 3, 4, 8, 16, 32, 64])
def test_probe_ranges_lane_mapping_matches_plain(dev, index_pair, P, B):
    # K1 with the corpus's patterns (50 shapes, padded to 64) cut to the
    # first P, at batches that are no multiple of the 32 / P topics a warp
    # takes, with $-rooted topics; and K2, which maps lanes the same way,
    # on the same inputs
    fl, arrays = index_pair
    L = fl.max_levels
    table, pats = arrays[0], [a[:P].contiguous() for a in arrays[1:]]
    topics = [f"$SYS/{t}" if i % 5 == 2 else t for i, t in enumerate(corpus_topics(40 + B, n=B)[:B])]
    tokens = packed(topics, fl, dev, 1)[:B].contiguous()
    got = flat.flat_match_packed(table, *pats, tokens, max_levels=L)
    want = flat.flat_match_packed_plain(table, *pats, tokens, L)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if B > 2:
        assert bool(tokens[:, -1].any())  # $-rooted topics in the batch
    if P and not P & (P - 1):
        n_hits = int(want[:, 2 * P].sum())
        for capacity in (max(1, n_hits // 2), n_hits + 1):
            got = flat.flat_match_compact(table, *pats, tokens, max_levels=L, capacity=capacity)
            assert torch.equal(got, flat.flat_match_compact_plain(table, *pats, tokens, L, capacity)), capacity


def test_ranges_views_match_plain(dev, index_pair):
    fl, arrays = index_pair
    tokens = packed(corpus_topics(6), fl, dev)
    L = fl.max_levels
    got = flat.flat_match_ranges(
        *arrays, tokens[:, :L], tokens[:, L : 2 * L], tokens[:, 2 * L], tokens[:, 2 * L + 1] != 0, max_levels=L
    )
    start, cnt, ovf = flat.probe_plain(*arrays, tokens, L)
    assert torch.equal(got[0], start) and torch.equal(got[1], cnt)
    assert torch.equal(got[2], cnt.sum(1, dtype=torch.int32)) and torch.equal(got[3], ovf)


@pytest.mark.parametrize("fit", ["exact", "slack", "overflow", "one"])
def test_compact_kernel_matches_plain(dev, index_pair, fit):
    fl, arrays = index_pair
    tokens = packed(corpus_topics(5), fl, dev)
    n_hits = int(flat.flat_match_packed_plain(*arrays, tokens, fl.max_levels)[:, -2].sum())
    capacity = {"exact": n_hits, "slack": n_hits + 37, "overflow": n_hits // 3, "one": 1}[fit]
    before = kernels.LAUNCHES["flat_match_compact"]
    got = flat.flat_match_compact(*arrays, tokens, max_levels=fl.max_levels, capacity=capacity)
    want = flat.flat_match_compact_plain(*arrays, tokens, fl.max_levels, capacity)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flat_match_compact"] == before + 1
    assert torch.equal(got, want)
    assert int(got[0]) == n_hits


def test_compact_without_patterns_is_constant(dev):
    fl = flat.build_flat_index(TopicsIndex(), max_levels=4)
    arrays = flat.device_index_from_numpy(fl.table, fl.pat_kind, fl.pat_depth, fl.pat_mask, dev)
    tokens = packed(["a", "b/c"], fl, dev)
    before = dict(kernels.LAUNCHES)
    got = flat.flat_match_compact(*arrays, tokens, max_levels=4, capacity=8)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, flat.flat_match_compact_plain(*arrays, tokens, 4, 8))


def _compact_pair(arrays, tokens, L, capacity):
    got = flat.flat_match_compact(*arrays, tokens, max_levels=L, capacity=capacity)
    return got, flat.flat_match_compact_plain(*arrays, tokens, L, capacity)


@pytest.mark.parametrize("n", [24, 333])
@pytest.mark.parametrize("where", ["first", "last"])
def test_compact_clip_slot_from_the_first_or_the_last_tile(dev, where, n):
    # one topic of the batch has hits (40, over four patterns), the rest
    # none: the last non-empty segment lies in the first or in the last
    # CUDA block's tile (n = 333), or in one block (n = 24), and at a
    # capacity below 40 the clip rule writes the last slot from it
    ops = [("sub", f"c{f}{i}", f, 0, 0, False) for f in ("t/x", "t/+", "t/#", "+/x") for i in range(10)]
    fl = flat.build_flat_index(apply_port_ops(ops, TopicsIndex()), max_levels=4)
    arrays = flat.device_index_from_numpy(fl.table, fl.pat_kind, fl.pat_depth, fl.pat_mask, dev)
    batch = ["n/y"] * n
    batch[0 if where == "first" else -1] = "t/x"
    tokens = packed(batch, fl, dev, 1)[: len(batch)]
    for capacity in (1, 17, 39, 40, 41, 4096):
        got, want = _compact_pair(arrays, tokens, 4, capacity)
        torch.cuda.synchronize()
        assert torch.equal(got, want), capacity
        assert int(got[0]) == 40


@pytest.mark.parametrize("B", [1, 13, 1000])
def test_compact_ragged_batches_and_one_pattern(dev, index_pair, B):
    # B not a multiple of the 8 topics a CUDA block takes, and P = 1
    fl, arrays = index_pair
    topics = corpus_topics(7, n=B)[:B]
    tokens = packed(topics, fl, dev, 1)[:B].contiguous()
    L = fl.max_levels
    n_hits = int(flat.flat_match_packed_plain(*arrays, tokens, L)[:, -2].sum())
    for capacity in (max(1, n_hits // 2), n_hits + 1):
        got, want = _compact_pair(arrays, tokens, L, capacity)
        assert torch.equal(got, want), capacity
    one = (arrays[0], *(a[:1].contiguous() for a in arrays[1:]))
    for capacity in (1, 64):
        got, want = _compact_pair(one, tokens, L, capacity)
        assert torch.equal(got, want), capacity
    torch.cuda.synchronize()


def test_compact_back_to_back_launches_on_one_stream(dev, index_pair):
    # 50 launches queued on one stream, batches and capacities changing,
    # with no synchronisation between them: a status word, ticket or done
    # counter left stale by a launch would corrupt a later one
    fl, arrays = index_pair
    L = fl.max_levels
    rng = np.random.default_rng(3)
    runs = []
    for i in range(50):
        B = int(rng.choice([1, 16, 77, 256, 4096]))
        tokens = packed(corpus_topics(100 + i, n=B)[:B], fl, dev, 1)[:B].contiguous()
        capacity = int(rng.integers(1, 40 * B + 2))
        runs.append((tokens, capacity, flat.flat_match_compact(*arrays, tokens, max_levels=L, capacity=capacity)))
    torch.cuda.synchronize()
    for tokens, capacity, got in runs:
        assert torch.equal(got, flat.flat_match_compact_plain(*arrays, tokens, L, capacity)), capacity


@pytest.mark.parametrize("k", [1, 8, 300, 512])
def test_scatter_rows_kernel_matches_plain(dev, index_pair, k):
    # in place, on clones of the shared index's table: the kernel, its
    # plain version and Tensor.index_copy_ write the same rows
    fl, arrays = index_pair
    g = torch.Generator(device="cpu").manual_seed(k)
    S = arrays[0].shape[0]
    idx = torch.randperm(S, generator=g)[:k].to(torch.int32).to(dev)
    rows = torch.randint(-(2**31), 2**31, (k, 16), generator=g, dtype=torch.int64).to(torch.int32).to(dev)
    got, plain, lib = (arrays[0].clone() for _ in range(3))
    before = kernels.LAUNCHES["scatter_rows"]
    assert flat.scatter_rows(got, idx, rows) is got
    assert kernels.LAUNCHES["scatter_rows"] == before + 1
    flat.scatter_rows_plain(plain, idx, rows)
    lib.index_copy_(0, idx.to(torch.int64), rows)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(got, lib)
    untouched = torch.ones(S, dtype=torch.bool, device=dev)
    untouched[idx.to(torch.int64)] = False
    assert torch.equal(got[untouched], arrays[0][untouched])


def test_scatter_rows_drops_out_of_range_and_takes_duplicates(dev, index_pair):
    fl, arrays = index_pair
    S = arrays[0].shape[0]
    g = torch.Generator(device="cpu").manual_seed(9)
    base = torch.randperm(S, generator=g)[:40].to(torch.int32)
    rows_b = torch.randint(-(2**31), 2**31, (40, 16), generator=g, dtype=torch.int64).to(torch.int32)
    # out-of-range indices, and duplicates carrying identical rows
    idx = torch.cat([base, torch.tensor([-1, S, S + 7, -(2**31)], dtype=torch.int32), base[:10]]).to(dev)
    rows = torch.cat([rows_b, rows_b[:4], rows_b[:10]]).to(dev)
    got, plain = arrays[0].clone(), arrays[0].clone()
    flat.scatter_rows(got, idx, rows)
    flat.scatter_rows_plain(plain, idx, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert torch.equal(got[base.to(dev).to(torch.int64)], rows_b.to(dev))
    # k = 0 launches nothing
    before = kernels.LAUNCHES["scatter_rows"]
    flat.scatter_rows(got, idx[:0], rows[:0])
    assert kernels.LAUNCHES["scatter_rows"] == before


def test_saturated_index_on_the_card(dev):
    index = apply_port_ops(saturating_ops(), TopicsIndex())
    m = TorchMatcher(index, max_levels=4, device=dev)
    topics = [f"sat{i}" for i in range(64)] + ["plain/topic", "wild/x"]
    for got, t in zip(m.match_topics(topics), topics):
        assert subscribers_equal(got, index.subscribers(t)), t
    assert m.index.n_sat >= 1


def test_matcher_fold_between_issue_and_resolve(dev):
    # no saturated bucket, spilled entry or over-deep topic: the device
    # serves every topic, so an in-flight batch must resolve to the
    # subscriber sets of its issue time (host fallbacks read the live trie)
    ops = [("sub", f"c{i}", f"room/{i % 48}/t/{i % 7}", i % 3, 0, False) for i in range(2000)]
    ops.append(("sub", "w", "room/+/t/+", 2, 0, False))
    index = apply_port_ops(ops, TopicsIndex())
    m = TorchMatcher(index, max_levels=4, device=dev)
    m.rebuild()
    assert m.index.n_sat == 0 and m.index.n_spill == 0
    topics = [f"room/{r}/t/{k}" for r in range(48) for k in range(7)]
    before = [index.subscribers(t) for t in topics]
    resolver = m.match_topics_async(topics)
    churn = [("sub", f"late{i}", t, 1, 0, False) for i, t in enumerate(topics[:40])]
    churn += [("unsub", o[1], o[2], 0, 0, False) for o in ops[:30]]
    apply_port_ops(churn, index)
    launches = kernels.LAUNCHES["scatter_rows"]
    assert m.fold({o[2] for o in churn})
    assert kernels.LAUNCHES["scatter_rows"] == launches + 1
    for got, want, t in zip(resolver(), before, topics):
        assert subscribers_equal(got, want), t
    for got, t in zip(m.match_topics(topics), topics):
        assert subscribers_equal(got, index.subscribers(t)), t
    assert m.stats.host_fallbacks == 0


@pytest.mark.parametrize("compact", [False, True], ids=["ranges", "compact"])
def test_two_folds_between_issue_and_resolve_on_the_card(dev, compact):
    # the batch holds its buffer while the second fold writes the standby
    # (ranges: the pin ends at the launch, so the fold writes the batch's
    # own buffer behind it in stream order; compact: the pin lasts to the
    # resolve, so the fold writes a fresh copy, counted)
    ops = [("sub", f"c{i}", f"room/{i % 48}/t/{i % 7}", i % 3, 0, False) for i in range(2000)]
    ops.append(("sub", "w", "room/+/t/+", 2, 0, False))
    index = apply_port_ops(ops, TopicsIndex())
    m = TorchMatcher(index, max_levels=4, device=dev, compact=compact, compact_capacity=4096 if compact else 0)
    m.rebuild()
    topics = [f"room/{r}/t/{k}" for r in range(48) for k in range(7)]
    before = [index.subscribers(t) for t in topics]
    resolver = m.match_topics_async(topics)
    launches = kernels.LAUNCHES["scatter_rows"]
    for r in range(2):
        churn = [("sub", f"late{r}_{i}", t, 1, 0, False) for i, t in enumerate(topics[r * 40 : r * 40 + 40])]
        churn += [("unsub", o[1], o[2], 0, 0, False) for o in ops[r * 30 : r * 30 + 30]]
        apply_port_ops(churn, index)
        assert m.fold({o[2] for o in churn})
    assert kernels.LAUNCHES["scatter_rows"] == launches + 2
    assert m.stats.fold_copies == int(compact)
    for got, want, t in zip(resolver(), before, topics):
        assert subscribers_equal(got, want), t
    torch.cuda.synchronize()
    assert np.array_equal(m.device_arrays[0].cpu().numpy().view(np.uint32), m.index.table)
    for got, t in zip(m.match_topics(topics), topics):
        assert subscribers_equal(got, index.subscribers(t)), t
    assert m.stats.host_fallbacks == 0


def test_match_stage_on_the_card(dev):
    ops = corpus_ops(12, n_subs=2000)
    index = apply_port_ops(ops, TopicsIndex())
    dm = DeltaMatcher(index, max_levels=MAX_LEVELS, background=False, device=dev)
    topics = corpus_topics(13, n=1500)

    async def drive():
        stage = MatchStage(dm, index.subscribers, max_batch=256, latency_budget_s=None, max_pending=8192)
        stage.start()
        try:
            first = await asyncio.gather(*(stage.submit(t) for t in topics))
            check = [index.subscribers(t) for t in topics]
            apply_port_ops([("unsub", o[1], o[2], 0, 0, False) for o in ops[:100]], index)
            second = await asyncio.gather(*(stage.submit(t) for t in topics))
            dm.flush()
            third = await asyncio.gather(*(stage.submit(t) for t in topics))
            return first, check, second, third
        finally:
            await stage.stop()

    try:
        first, check, second, third = asyncio.run(drive())
    finally:
        dm.close()
    for a, b, t in zip(first, check, topics):
        assert subscribers_equal(a, b), t
    for res in (second, third):
        for a, t in zip(res, topics):
            assert subscribers_equal(a, index.subscribers(t)), t


def _rules(seed, B, R, S, W, dev):
    """Seeded rule table and feature batch on ``dev``: every op code and
    codes past the vocabulary, slots and cbits past both clip edges, NaN,
    infinite and signed-zero values, and features equal to a threshold or
    one float step beside it."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 0.5, -1.0, 7.25, np.nan, np.inf, -np.inf], dtype=np.float32)
    op = rng.integers(-1, 15, R).astype(np.int32)
    slot = rng.integers(-2, S + 2, R).astype(np.int32)
    thresh = np.where(rng.random(R) < 0.5, rng.choice(pool, R), rng.normal(size=R)).astype(np.float32)
    cbit = rng.integers(-8, 32 * W + 40, R).astype(np.int32)
    feats = np.where(rng.random((B, S)) < 0.5, rng.choice(pool, (B, S)), rng.normal(size=(B, S))).astype(np.float32)
    near = thresh[rng.integers(0, R, (B, S))]
    step = rng.integers(-1, 2, (B, S))
    near = np.where(step == 0, near, np.nextafter(near, np.where(step > 0, np.inf, -np.inf).astype(np.float32)))
    feats = np.where(rng.random((B, S)) < 0.3, near, feats).astype(np.float32)
    cmask = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (op, slot, thresh, cbit, feats, cmask)]


# the earlier shapes, then every R past a tile of 32 words (1056 = 33
# words: a tile straddles the table's end) with B of one publish, past a
# run of 32 publishes and at the main path's batch
_RULES_SHAPES = [(1, 32, 1, 1), (17, 96, 3, 2), (64, 4096, 2, 64), (4096, 8192, 1, 63)] + [
    (B, R, S, W) for R in (32, 96, 1056, 131072) for B in (1, 17, 4096) for S in (1, 3) for W in (1, 63, 64)
    if (B, R, S, W) != (1, 32, 1, 1)
]


@pytest.mark.parametrize("B,R,S,W", _RULES_SHAPES)
def test_rules_eval_kernel_matches_plain(dev, B, R, S, W):
    args = _rules(B + R, B, R, S, W, dev)
    before = kernels.LAUNCHES["rules_eval"]
    got = pops.rules_eval(*args)
    want = pops.rules_eval_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rules_eval"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 3])
def test_rules_eval_cmask_words_past_64(dev, S):
    # cmask rows of 100 words: bit-op rules reading words past the 64 a
    # warp could stage, and past W (all ones)
    args = _rules(5 + S, 64, 2048, S, 100, dev)
    got = pops.rules_eval(*args)
    want = pops.rules_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("in_order", [False, True])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("B", [16, 64, 128, 4096])
def test_rules_eval_crowded_bit_ops(dev, B, S, in_order):
    # cfgP's shape with its bit-op rules crowded into the first 94 words,
    # their cmask bits at random (a tile reads every word) or in order (a
    # tile reads 32 words, as cfgP's do with its bit-op rules first); on an
    # H100 these B give warps runs of 8, 8, 16 and 32 publishes
    rng = np.random.default_rng(B + S)
    R, W, n_bit = 131072, 63, 3000
    op = np.full(R, pops.OP_GT, np.int32)
    op[:n_bit] = np.where(np.arange(n_bit) % 2 == 0, pops.OP_CONTAINS, pops.OP_EQS)
    thresh = rng.integers(0, 100, R).astype(np.float32)
    slot = rng.integers(0, S, R).astype(np.int32)
    cbit = np.zeros(R, np.int32)
    cbit[:n_bit] = np.arange(n_bit) if in_order else rng.integers(0, 32 * W, n_bit)
    feats = rng.integers(0, 100, (B, S)).astype(np.float32)
    feats[rng.random((B, S)) < 0.05] = np.nan
    cmask = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (op, slot, thresh, cbit, feats, cmask)]
    got = pops.rules_eval(*args)
    want = pops.rules_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 3])
def test_rules_eval_every_op_on_edge_values(dev, S):
    # one warp of words (1024 rules) cycling through every op code with
    # NaN, +-inf and +-0 thresholds among others, ending in OP_NONE pad rows
    # as the engine pads; features at every threshold, one step either
    # side of it, and NaN, +-inf and +-0
    R = 1024
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -2.5, 1e-40, 3.4e38], dtype=np.float32)
    codes = np.arange(-1, 15, dtype=np.int32)
    op = np.resize(codes, R)
    thresh = np.resize(vals, R - 7).astype(np.float32)
    op[-96:] = pops.OP_NONE
    thresh = np.concatenate([thresh, np.zeros(7, np.float32)])
    thresh[-96:] = 0.0
    rng = np.random.default_rng(S)
    slot = rng.integers(0, S, R).astype(np.int32)
    cbit = rng.integers(0, 96, R).astype(np.int32)
    finite = np.unique(vals[~np.isnan(vals)])
    cand = np.concatenate([vals, np.nextafter(finite, np.float32(np.inf)), np.nextafter(finite, np.float32(-np.inf))])
    B = 4096
    feats = rng.choice(cand.astype(np.float32), (B, S)).astype(np.float32)
    cmask = rng.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (op, slot, thresh, cbit, feats, cmask)]
    got = pops.rules_eval(*args)
    want = pops.rules_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("W,N", [(1, 1), (1, 8), (5, 33), (37, 70), (64, 64), (300, 1000)])
def test_agg_reduce_kernel_matches_plain(dev, W, N):
    # ragged windows of 1..N samples (the first all NaN), counts that
    # differ from the sample counts (the mean divides by counts)
    rng = np.random.default_rng(W * N)
    windows = []
    for w in range(W):
        v = rng.normal(scale=50.0, size=int(rng.integers(1, N + 1))).astype(np.float32)
        v[rng.random(v.shape[0]) < 0.3] = np.nan
        if w == 0:
            v[:] = np.nan
        windows.append(v)
    ops = rng.integers(pops.OP_MEAN, pops.OP_MIN + 1, W).astype(np.int32)
    counts = rng.integers(0, N + 4, W).astype(np.int32)
    buf = torch.from_numpy(pops.pack_windows(windows, ops, counts)).to(dev)
    before = kernels.LAUNCHES["agg_reduce"]
    got = pops.agg_reduce(buf, W).cpu().numpy()
    want = pops.agg_reduce_plain(buf, W).cpu().numpy()
    assert kernels.LAUNCHES["agg_reduce"] == before + 1
    exact = ops != pops.OP_MEAN
    assert np.array_equal(got[exact].view(np.uint32), want[exact].view(np.uint32))
    assert (np.abs(got[~exact] - want[~exact]) <= 1e-5 * np.maximum(1.0, np.abs(want[~exact]))).all()


def test_agg_reduce_batch_one_launch_through_pinned_staging(dev):
    rng = np.random.default_rng(12)
    ticks = [[(int(rng.integers(pops.OP_MEAN, pops.OP_MIN + 1)), list(rng.normal(size=int(rng.integers(1, n)))))
              for _ in range(W)] for W, n in ((64, 65), (5, 33), (200, 300), (64, 65))]
    seen = []
    for pending in ticks:
        before = kernels.LAUNCHES["agg_reduce"]
        got = pops.agg_reduce_batch(pending, dev)
        assert kernels.LAUNCHES["agg_reduce"] == before + 1
        want = pops.agg_reduce_batch(pending, "cpu")
        ops = np.array([op for op, _ in pending])
        exact = ops != pops.OP_MEAN
        assert np.array_equal(got[exact].view(np.uint32), want[exact].view(np.uint32))
        assert (np.abs(got[~exact] - want[~exact]) <= 1e-5 * np.maximum(1.0, np.abs(want[~exact]))).all()
        st = pops._staging_for(dev)
        assert st.host_in.is_pinned() and st.host_out.is_pinned()
        seen.append(st.host_in.data_ptr())
    # grown (by doubling or to fit) only for the larger tick, then reused
    assert seen[0] == seen[1] and seen[2] == seen[3]


KEYSTREAM_SHAPES = [(3, 255), (512, 1 << 16)] + [(T, N) for T in (1, 512) for N in (1, 16, 2048, 32768, 1 << 20)]


@pytest.mark.parametrize("T,N", KEYSTREAM_SHAPES)
def test_keystream_kernel_matches_plain(dev, T, N):
    rng = np.random.default_rng(T + N)
    table = torch.from_numpy(rng.integers(0, 256, (T, 11, 16), dtype=np.uint8)).to(dev)
    kidx = torch.from_numpy(rng.integers(-T - 2, T + 2, N).astype(np.int32)).to(dev)
    counters = torch.from_numpy(rng.integers(0, 256, (N, 16), dtype=np.uint8)).to(dev)
    before = kernels.LAUNCHES["keystream"]
    got = rops.keystream(table, kidx, counters)
    want = rops.keystream_plain(table, kidx, counters)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["keystream"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("N", [2048, (1 << 14) - 1, 1 << 14])
def test_keystream_both_lane_splits_match_plain(dev, lanes, N):
    # the wrapper picks four lanes per AES block below 2^14 blocks and one
    # from there: hold both splits at both sides of the pick
    import ctypes

    T = 64
    rng = np.random.default_rng(N + lanes)
    table = torch.from_numpy(rng.integers(0, 256, (T, 11, 16), dtype=np.uint8)).to(dev)
    kidx = torch.from_numpy(rng.integers(-T - 2, T + 2, N).astype(np.int32)).to(dev)
    counters = torch.from_numpy(rng.integers(0, 256, (N, 16), dtype=np.uint8)).to(dev)
    got = torch.empty((N, 16), dtype=torch.uint8, device=dev)
    err = kernels.library("recrypt.cu").rc_keystream(
        table.data_ptr(), T, kidx.data_ptr(), counters.data_ptr(), N, got.data_ptr(), lanes,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    assert err == 0
    assert torch.equal(got, rops.keystream_plain(table, kidx, counters))


def test_keystream_kernel_fips_197_c1(dev):
    rk = torch.from_numpy(rops.expand_key(bytes(range(16)))[None]).to(dev)
    pt = torch.from_numpy(np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"), np.uint8).copy())
    got = rops.keystream(rk, torch.zeros(1, dtype=torch.int32, device=dev), pt.reshape(1, 16).to(dev))
    assert got.cpu().numpy().tobytes().hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_stage_legs_on_the_card_match_the_cpu(dev):
    # the same publishes through a stage on the card and one on the CPU:
    # the same rows, keystreams, filtered sets and emissions
    results = []
    for device in (dev, torch.device("cpu")):
        index = TopicsIndex()
        keys = KeyRegistry()
        for k in range(8):
            keys.set_key("t", f"s{k}", bytes([k]) * 16)
            index.subscribe(f"t:s{k}", Subscription(filter="\x00t/e/+"))
        for i in range(200):
            preds = (f"$GT{{v:{i / 200}}}",) if i % 3 else ("$MEAN{v:32}",)
            index.subscribe(f"c{i}", Subscription(filter=f"p/{i % 4}/+", predicates=preds))
        pred = PredicateEngine(oracle_sample=1, device=device)
        for i in range(200):
            pred.register(f"$GT{{v:{i / 200}}}" if i % 3 else "$MEAN{v:32}")
        rec = RecryptEngine(keys, oracle_sample=1, device_min_blocks=1, device=device)
        rec.reseed_nonce(b"card")
        tenant = Tenant("t", encrypted=("e/",))
        rng = np.random.default_rng(3)
        items = []
        for i in range(300):
            if i % 4 == 0:
                wire = rec.seal_with_key(bytes([1]) * 16, bytes(rng.integers(0, 256, 70, dtype=np.uint8)))
                keys.set_key("t", "pub", bytes([1]) * 16)
                items.append((f"\x00t/e/{i}", wire, None, rec.decrypt_job(tenant, ("pub",), wire)))
            else:
                payload = b'{"v": %r}' % float(rng.random())
                items.append((f"p/{i % 4}/x", payload, pred.features_for(payload), None))
        dm = DeltaMatcher(index, max_levels=4, background=False, device=device)

        async def drive():
            stage = MatchStage(dm, index.subscribers, max_batch=64, latency_budget_s=None,
                               predicates=pred, recrypt=rec)
            stage.start()
            try:
                return await asyncio.gather(*(stage.submit(t, feats=f, rjob=r) for t, _p, f, r in items))
            finally:
                await stage.stop()

        try:
            subs = asyncio.run(drive())
        finally:
            dm.close()
        out = []
        for (topic, payload, feats, job), s in zip(items, subs):
            if job is not None:
                plain = rec.open_publish(tenant, ("pub",), payload, job)
                sealed = rec.seal_fanout(tenant, plain, [(c, (c.split(":")[1],)) for c in s.subscriptions])
                out.append((bytes(job.keystream.tobytes()), sorted(sealed.items())))
            else:
                s, emits = pred.apply(s, payload, feats)
                out.append((feats.device_row.tobytes(), sorted(s.subscriptions), [e[3] for e in emits]))
        assert pred.oracle_mismatches == 0 and rec.oracle_mismatches == 0
        results.append(out)
    card, cpu = results
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        if len(a) == 3 and a[2]:
            # MEAN emissions: the card sums in another order
            assert a[:2] == b[:2]
            for x, y in zip(a[2], b[2]):
                assert abs(float(x) - float(y)) <= 1e-5 * max(1.0, abs(float(y)))
        else:
            assert a == b


# -- the sharded matcher: K7 flat_match_core, K8 the step, K9 tile_compact -------


@pytest.mark.parametrize("b_min", [64, 4096])
@pytest.mark.parametrize("out_slots,overflow_slots", [(64, 0), (8, 0), (8, 20)])
def test_flat_match_core_kernel_matches_plain(dev, index_pair, b_min, out_slots, overflow_slots):
    fl, arrays = index_pair
    tokens = packed(corpus_topics(5), fl, dev, b_min)
    before = kernels.LAUNCHES["flat_match_slots"]
    got = flat.flat_match_core(*arrays, tokens, max_levels=fl.max_levels, out_slots=out_slots,
                               overflow_slots=overflow_slots)
    want = flat.flat_match_core_plain(*arrays, tokens, fl.max_levels, out_slots, overflow_slots)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flat_match_slots"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[2].any()) and int((want[0] >= 0).sum()) > 0
    if out_slots == 8:
        assert bool((want[1] > 8).any())


@contextlib.contextmanager
def _sharded_index(dev, n_positions, index):
    from mqtt_tpu_torch.parallel import ShardedTorchMatcher, make_mesh

    m = ShardedTorchMatcher(index, mesh=make_mesh([dev] * n_positions), max_levels=MAX_LEVELS)
    try:
        m.rebuild()
        (arrays,) = m._compiled[0].values()
        yield m, arrays
    finally:
        m.close()


@contextlib.contextmanager
def _sharded(dev, n_positions, ops):
    with _sharded_index(dev, n_positions, apply_port_ops(ops, TopicsIndex())) as pair:
        yield pair


@pytest.mark.parametrize("n_positions", [2, 8])  # S = 1 and S = 4 shards
@pytest.mark.parametrize("b", [64, 4096])
def test_sharded_step_kernel_matches_plain(dev, n_positions, b):
    from mqtt_tpu_torch.parallel import sharded

    with _sharded(dev, n_positions, corpus_ops(9, n_subs=300)) as (m, arrays):
        S, K = m.n_shards, m.out_slots
        tokens = packed(corpus_topics(6, n=b), m._flats[0], dev, b)[:b]
        got = [torch.empty((S, b, K), dtype=torch.int32, device=dev),
               torch.empty((S, b), dtype=torch.int32, device=dev), torch.empty((S, b), dtype=torch.bool, device=dev)]
        want = [torch.empty_like(a) for a in got]
        before = dict(kernels.LAUNCHES)
        sharded.sharded_step(*arrays, tokens, max_levels=m.max_levels, out=got[0], totals=got[1], overflow=got[2])
        sharded.sharded_step_plain(*arrays, tokens, max_levels=m.max_levels, out=want[0], totals=want[1],
                                   overflow=want[2])
        torch.cuda.synchronize()
    # one launch of K7's kernel with a shard dimension, counted under K8 only
    assert kernels.LAUNCHES["sharded_step"] == before["sharded_step"] + 1
    assert kernels.LAUNCHES["flat_match_slots"] == before["flat_match_slots"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((want[0] >= 0).sum()) > 0


@pytest.fixture(scope="module")
def stacks(dev):
    """corpus_ops(7) and 15 clients on each of six filters of ``qq/zz``
    (90 hits: more than 64 slots at S = 1), stacked on 2 and 8 positions of
    the card (S = 1 and 4 shards), by S: (tables, kinds, depths, masks) and
    a shard's flat index (for the tokenizer's salt)."""
    hot = [("sub", f"hot{f}{i}", f, 0, 0, False)
           for f in ("qq/zz", "qq/+", "+/zz", "qq/#", "qq/zz/#", "+/zz/#") for i in range(15)]
    index = apply_port_ops(corpus_ops(7) + hot, TopicsIndex())
    built = {}
    for n in (2, 8):
        with _sharded_index(dev, n, index) as (m, arrays):
            built[m.n_shards] = (arrays, m._flats[0])
    return built


def _pats_to(pats, P):
    """Pattern rows [S, P0] cut to their first P, or padded with inert
    patterns (depth -1) to P."""
    if P <= pats[0].shape[1]:
        return [a[:, :P].contiguous() for a in pats]
    pad = P - pats[0].shape[1]
    return [torch.nn.functional.pad(a, (0, pad), value=v) for a, v in zip(pats, (0, -1, 0))]


@pytest.mark.parametrize("K", [6, 8, 64])
@pytest.mark.parametrize("P", [1, 3, 4, 8, 33, 64])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_sharded_step_tiles_lanes_and_slots_match_plain(dev, stacks, T, S, P, K):
    # K8 as the step launches it: T tiles of 333 topics (no multiple of the
    # 32 / Pw topics a warp takes, $-rooted topics among them) in one launch
    # into [T, S, bl, K]; P across probe_lanes' cases (1, a partial group,
    # 4 and 8 topics a warp, and strides of 32 patterns), K with and without
    # 16-byte stores (K = 6), rows whose totals pass K (qq/zz at S = 1, P = 64)
    from mqtt_tpu_torch.parallel import sharded

    arrays, fl = stacks[S]
    table, pats = arrays[0], _pats_to(arrays[1:], P)
    bl = 333
    topics = [f"$SYS/{t}" if i % 7 == 3 else "qq/zz" if i % 50 == 5 else t
              for i, t in enumerate(corpus_topics(60 + T, n=T * bl)[: T * bl])]
    tokens = packed(topics, fl, dev, 1)[: T * bl].contiguous()
    shapes = ((T, S, bl, K), (T, S, bl), (T, S, bl))
    got = [torch.full(sh, 7, dtype=dt, device=dev) for sh, dt in zip(shapes, (torch.int32, torch.int32, torch.bool))]
    want = [torch.empty_like(a) for a in got]
    before = dict(kernels.LAUNCHES)
    sharded.sharded_step(table, *pats, tokens, max_levels=MAX_LEVELS, out=got[0], totals=got[1], overflow=got[2])
    sharded.sharded_step_plain(table, *pats, tokens, max_levels=MAX_LEVELS, out=want[0], totals=want[1],
                               overflow=want[2])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sharded_step"] == before["sharded_step"] + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if P >= 8 and (K < 64 or (S, P) == (1, 64)):
        assert bool((want[1] > K).any()) and int((want[0] >= 0).sum()) > 0


@pytest.mark.parametrize("S,bl,K", [(1, 64, 64), (4, 2048, 64), (4, 16, 8), (2, 256, 64), (3, 1000, 16),
                                    (4, 32768, 64)])
@pytest.mark.parametrize("fit", ["slack", "below", "negative"])
def test_tile_compact_kernel_matches_plain(dev, S, bl, K, fit):
    from mqtt_tpu_torch.parallel import sharded

    rng = np.random.default_rng(S + bl + K)
    T = 2
    totals = np.where(rng.random((T, S, bl)) < 0.5, 0, rng.integers(0, 2 * K, (T, S, bl))).astype(np.int32)
    out = rng.integers(0, 10_000, (T, S, bl, K)).astype(np.int32)
    out[np.arange(K)[None, None, None, :] >= np.minimum(totals, K)[..., None]] = -1
    overflow = rng.random((T, S, bl)) < 0.1
    t_flat = np.minimum(totals[0].T.reshape(-1), K)
    n_hits = int(t_flat.sum())
    last = np.nonzero(t_flat)[0][-1]
    cap = {"slack": n_hits + 29, "below": n_hits // 2, "negative": max(1, int(t_flat[:last].sum()) - K - 3)}[fit]
    args = [torch.from_numpy(a).to(dev) for a in (out, totals, overflow)]
    before = kernels.LAUNCHES["tile_compact"]
    got = sharded.tile_compact(*args, cap)
    want = sharded.tile_compact_plain(*args, cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tile_compact"] == before + 1
    assert torch.equal(got, want)
    assert int(want[0, 0]) == n_hits


def _gathered(dev, rng, T, S, bl, K, topics=None):
    """Seeded gathered tiles: per (tile, shard, topic) a total (some past
    K; zero outside ``topics``, a slice of the tile's topics), the first
    min(total, K) slots holding sids, -1 after; flags at random."""
    totals = np.where(rng.random((T, S, bl)) < 0.5, 0, rng.integers(0, 2 * K, (T, S, bl))).astype(np.int32)
    if topics is not None:
        keep = np.zeros(bl, bool)
        keep[topics] = True
        totals[:, :, ~keep] = 0
    out = rng.integers(0, 10_000, (T, S, bl, K)).astype(np.int32)
    out[np.arange(K)[None, None, None, :] >= np.minimum(totals, K)[..., None]] = -1
    overflow = rng.random((T, S, bl)) < 0.1
    return [torch.from_numpy(a).to(dev) for a in (out, totals, overflow)]


@pytest.mark.parametrize("fit", ["slack", "below", "negative"])
@pytest.mark.parametrize("where", ["first", "last"])
def test_tile_compact_clip_from_the_first_or_the_last_block(dev, where, fit):
    # every hit of both tiles lies in the topics of the first or of the last
    # of the tile's blocks (2048 topics x 4 shards take 16 of them), so the
    # last non-empty segment, whose record the tile's last block reads for
    # the clip slot, is the first block's or the last block's
    from mqtt_tpu_torch.parallel import sharded

    S, bl, K = 4, 2048, 64
    topics = slice(3, 40) if where == "first" else slice(bl - 40, bl - 2)
    args = _gathered(dev, np.random.default_rng(11), 2, S, bl, K, topics)
    t_flat = args[1][0].clamp(max=K).t().reshape(-1).cpu().numpy()
    n_hits = int(t_flat.sum())
    last = np.nonzero(t_flat)[0][-1]
    cap = {"slack": n_hits + 29, "below": n_hits // 2, "negative": max(1, int(t_flat[:last].sum()) - K - 3)}[fit]
    got = sharded.tile_compact(*args, cap)
    want = sharded.tile_compact_plain(*args, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(want[0, 0]) == n_hits


def test_tile_compact_back_to_back_launches_on_one_stream(dev):
    # 50 launches queued on one stream, tiles, shards, widths and
    # capacities changing, with no synchronisation between them: a status
    # word, ticket, done counter or tail cursor left stale by a launch would
    # corrupt a later one
    from mqtt_tpu_torch.parallel import sharded

    rng = np.random.default_rng(12)
    runs = []
    for _ in range(50):
        T, S = int(rng.choice([1, 2, 3])), int(rng.choice([1, 2, 4]))
        bl, K = int(rng.choice([16, 300, 2048, 4096])), int(rng.choice([8, 64]))
        args = _gathered(dev, rng, T, S, bl, K)
        cap = int(rng.integers(1, bl * S * K // 2 + 2))
        runs.append((args, cap, sharded.tile_compact(*args, cap)))
    torch.cuda.synchronize()
    for args, cap, got in runs:
        assert torch.equal(got, sharded.tile_compact_plain(*args, cap)), cap


def test_sharded_matcher_on_the_card_matches_the_cpu_mesh_and_the_trie(dev):
    from mqtt_tpu_torch.parallel import ShardedTorchMatcher, make_mesh

    # clients with several filters: the card's results equal the CPU
    # mesh's (a client whose filters lie in different shards merges in
    # shard order, as the JAX package's sharded matcher does)
    topics = corpus_topics(11, n=900)
    with _sharded(dev, 8, corpus_ops(10, n_subs=300)) as (m, _):
        cpu = ShardedTorchMatcher(m.topics, mesh=make_mesh(["cpu"] * 8), max_levels=MAX_LEVELS)
        try:
            for compact in (True, False):
                m.compact = cpu.compact = compact
                for got, want, t in zip(m.match_topics(topics), cpu.match_topics(topics), topics):
                    assert subscribers_equal(got, want), t
                    assert got.subscriptions.keys() == m.topics.subscribers(t).subscriptions.keys(), t
        finally:
            cpu.close()
    # one filter per client: every result equals the trie's
    ops = [("sub", f"c{i}", o[2], o[3], o[4], o[5]) for i, o in enumerate(corpus_ops(12, n_subs=300)) if o[0] == "sub"]
    with _sharded(dev, 8, ops) as (m, _):
        for compact in (True, False):
            m.compact = compact
            for got, t in zip(m.match_topics(topics), topics):
                assert subscribers_equal(got, m.topics.subscribers(t)), t


@pytest.mark.parametrize("route", ["matcher-packed", "matcher-compact", "mesh"])
def test_namespace_guards_on_the_card(dev, route):
    # the namespace corpus through the kernels: every scoped topic's result
    # is the trie's (the materializer drops the guarded entries)
    from mqtt_tpu_torch.parallel import ShardedTorchMatcher, make_mesh

    index = apply_port_ops(ns_corpus_ops(31), TopicsIndex())
    topics = ns_topics(32)
    if route == "mesh":
        m = ShardedTorchMatcher(index, mesh=make_mesh([dev] * 8), max_levels=MAX_LEVELS)
    else:
        compact = route == "matcher-compact"
        m = TorchMatcher(index, max_levels=MAX_LEVELS, compact=compact,
                         compact_capacity=16384 if compact else 0, device=dev)
    try:
        for got, t in zip(m.match_topics(topics), topics):
            assert subscribers_equal(got, index.subscribers(t)), repr(t)
        assert m.stats.host_fallbacks == 0
    finally:
        if route == "mesh":
            m.close()


def test_dryrun_multichip_on_one_card(dev):
    from mqtt_tpu_torch.parallel import dryrun_multichip

    before = dict(kernels.LAUNCHES)
    dryrun_multichip(8)
    assert kernels.LAUNCHES["sharded_step"] > before["sharded_step"]
    assert kernels.LAUNCHES["tile_compact"] > before["tile_compact"]


@pytest.mark.parametrize("layout", ["4x1-per-row", "2x2"])
def test_mesh_across_cards(dev, layout):
    # the branch a one-card machine never takes: a tile's shards on other
    # cards write there and are copied into the owner's gathered layout
    from mqtt_tpu_torch.parallel import ShardedTorchMatcher, make_mesh

    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs 4 cards, found {n}")
    cards = [f"cuda:{i}" for i in range(4)]
    mesh = make_mesh(cards * 2 if layout == "4x1-per-row" else cards)
    ops = [("sub", f"c{i}", o[2], o[3], o[4], o[5]) for i, o in enumerate(corpus_ops(12, n_subs=300)) if o[0] == "sub"]
    index = apply_port_ops(ops, TopicsIndex())
    m = ShardedTorchMatcher(index, mesh=mesh, max_levels=MAX_LEVELS)
    try:
        topics = corpus_topics(11, n=900)
        for compact in (True, False):
            m.compact = compact
            for got, t in zip(m.match_topics(topics), topics):
                assert subscribers_equal(got, index.subscribers(t)), t
        assert m.stats.compact_batches + m.stats.compact_overflows >= 1
    finally:
        m.close()


# -- the retained-delivery slice ----------------------------------------------


def retained_corpus(B: int) -> list[str]:
    """The retained-scan corpus of bench.py's config 11 (unique at any
    size), with a few ``$SYS`` and ``$other`` roots."""
    names = [f"region{i % 40}/device{(i // 40) % 50}/metric{i // 2000}" for i in range(B - 128)]
    return names + [f"$SYS/broker/n{i}" for i in range(64)] + [f"$other/n{i}" for i in range(64)]


@pytest.mark.parametrize("B", [1 << 16, 1 << 20])
def test_probe_ranges_one_pattern_over_a_retained_corpus(dev, B):
    names = retained_corpus(B)
    tok1, tok2, lengths, _dollar, _over = flat.tokenize_topics(names, 8, 0)
    is_sys = np.array([n.startswith("$SYS/") for n in names])
    tokens = torch.from_numpy(flat.pack_tokens(tok1, tok2, lengths, is_sys)).to(dev)
    for flt in ("region7/device7/+", "region7/+/metric7", "region7/#", "+/device7/metric7", "#", "+/+/+"):
        index = TopicsIndex()
        index.subscribe("\x00probe", Subscription(filter=flt))
        fl = flat.build_flat_index(index, max_levels=8, salt=0, min_buckets=64)
        arrays = flat.device_index_from_numpy(fl.table, fl.pat_kind, fl.pat_depth, fl.pat_mask, dev)
        before = kernels.LAUNCHES["flat_probe_ranges"]
        got = flat.flat_match_packed(*arrays, tokens, max_levels=8)
        want = flat.flat_match_packed_plain(*arrays, tokens, 8)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["flat_probe_ranges"] == before + 1
        # one pattern, padded to the build's minimum of two (the pad has
        # depth -1 and never probes): [B, 2P+2] with P = 2
        assert fl.num_patterns == 2 and got.shape == (B, 6) and torch.equal(got, want), flt
        assert int(want[:, 2].sum()) > 0


def test_retained_engine_on_the_card_matches_the_walk_and_the_cpu(dev):
    engines = {}
    for device in (dev, torch.device("cpu")):
        index = TopicsIndex()
        for topic, payload in retained_ops(21):
            index.retain_message(retain_packet(topic, payload))
        engines[device.type] = (index, RetainedMatchEngine(index, oracle_sample=0, min_capacity=16,
                                                           device=device))
    for _index, eng in engines.values():
        eng.reseed()
    filters = retained_filters(21)

    def check(rounds):
        for flt in filters:
            got = [eng.match(flt) for _i, eng in engines.values()]
            assert got[0] == got[1], flt
            if got[0] is not None:
                assert sorted(got[0]) == sorted(p.topic_name for p in engines["cuda"][0].messages(flt)), flt
        rounds.append(kernels.LAUNCHES["flat_probe_ranges"])

    rounds = [kernels.LAUNCHES["flat_probe_ranges"]]
    check(rounds)
    first = engines["cuda"][1]._corpora[""].packed
    # growth past the first capacity, then clears past rebuild_ratio
    for topic, payload in retained_ops(22, n=600):
        for index, eng in engines.values():
            eng.note_retained(topic, index.retain_message(retain_packet(topic, payload)) == 1)
    check(rounds)
    assert engines["cuda"][1]._corpora[""].packed is not first
    held = [t for t in engines["cuda"][0].retained.get_all() if t[:1] != "\x00"]
    for topic in held[::2]:
        for index, eng in engines.values():
            assert index.retain_message(retain_packet(topic, b"")) == -1
            eng.note_retained(topic, False)
    assert engines["cuda"][1]._corpora[""].tombstones < len(held) // 2  # compacted
    check(rounds)
    assert rounds[1] > rounds[0] and rounds[2] > rounds[1] and rounds[3] > rounds[2]
    assert engines["cuda"][1].device_matches == engines["cpu"][1].device_matches > 0
    for (_i, a), (_j, b) in zip([engines["cuda"]], [engines["cpu"]]):
        for ns, c in b._corpora.items():
            n = c.n_tok
            assert torch.equal(a._corpora[ns].packed[:n].cpu(), c.packed[:n])


@pytest.mark.parametrize("size", [256, 4096])
def test_reseal_batch_on_the_card_matches_the_cpu(dev, size):
    outs = []
    for device in (dev, torch.device("cpu")):
        keys = KeyRegistry()
        for k in range(8):
            keys.set_key("t", f"c{k}", bytes([k]) * 16)
        eng = RecryptEngine(keys, oracle_sample=0, device=device)
        eng.reseed_nonce(b"reseal", 3)
        epoch = keys.stage_epoch("t", {f"c{k}": bytes([k, 1]) * 8 for k in range(8)})
        rng = np.random.default_rng(size)
        items = []
        for i in range(512):
            wire = eng.seal_with_key(bytes([i % 8]) * 16, rng.integers(0, 256, size, dtype=np.uint8).tobytes())
            items.append((wire, keys.key_id("t", f"c{i % 8}"), keys.kid_for_epoch("t", f"c{i % 8}", epoch)))
        before = kernels.LAUNCHES["keystream"]
        outs.append(eng.reseal_batch(Tenant("t"), items, epoch))
        if device.type == "cuda":
            assert kernels.LAUNCHES["keystream"] == before + 1
            assert eng.device_blocks == 2 * 512 * (size // 16)
    assert outs[0] == outs[1]


# -- the device plane's instruments on the card -----------------------------------


def test_memory_gauges_and_first_launch_notes_on_the_card(dev):
    """``DeviceStatsPlane()`` on the card: live <= peak <= limit, the limit
    the card's total, a 64 MiB tensor seen by the live gauge; the ledger
    notes K1's first launch at a new batch bucket once and a repeat not at
    all; the profiler keeps one window on this card, closed after each
    resolver's wait."""
    from mqtt_tpu_torch.ops import devicestats
    from mqtt_tpu_torch.telemetry import MetricsRegistry, check_exposition
    from mqtt_tpu_torch.tracing import DeviceProfiler

    reg = MetricsRegistry()
    prof = DeviceProfiler(reg)
    plane = devicestats.DeviceStatsPlane(reg)  # device="cuda": every card
    plane.attach_profiler(prof)
    assert [d.id for d in plane._devices] == list(range(torch.cuda.device_count()))
    index = apply_port_ops(corpus_ops(31, n_subs=2000), TopicsIndex())
    # a token width (2L+2) no other test launches K1 at: a new signature
    m = TorchMatcher(index, max_levels=MAX_LEVELS + 3, device=dev, compact=False)
    m.rebuild()
    m.profiler = prof
    torch.cuda.synchronize()
    live0 = plane.snapshot()["devices"][dev.index or 0]["hbm"]["live_bytes"]
    hold = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    topics = corpus_topics(32, n=1500)
    before = devicestats.LEDGER.counts()
    for t, got in zip(topics, m.match_topics(topics)):
        assert subscribers_equal(got, index.subscribers(t)), t
    after = devicestats.LEDGER.counts()
    assert after.get("flat_probe_ranges", 0) == before.get("flat_probe_ranges", 0) + 1
    last = devicestats.LEDGER.events()[-1]
    assert last["kernel"] == "flat_probe_ranges" and f"x{2 * (MAX_LEVELS + 3) + 2}" in last["shape_bucket"]
    m.match_topics(topics)  # the same signature: nothing new
    assert devicestats.LEDGER.counts() == after
    snap = plane.snapshot()
    h = snap["devices"][dev.index or 0]["hbm"]
    assert h["live_bytes"] >= live0 + (64 << 20)
    assert 0 < h["live_bytes"] <= h["peak_bytes"] <= h["limit_bytes"] == torch.cuda.mem_get_info(dev)[1]
    assert snap["devices"][dev.index or 0]["platform"] == "gpu"
    assert prof.batches == 2 and sorted(prof.device_snapshot()) == [dev.index or 0]
    assert 0.0 < prof.duty_cycle() <= 1.0
    text = reg.exposition()
    assert check_exposition(text) > 0
    assert f'mqtt_tpu_device_hbm_limit_bytes{{device="{dev.index or 0}"}} {h["limit_bytes"]}' in text
    del hold


def _cfg4_ops(seed: int, n_groups: int = 400, members: int = 4) -> list:
    """bench.py config 4's shape, small: ``$SHARE/grp<g>/<a>/<b>/<c>``
    groups of QoS 1 members over a vocabulary of 6 values a level."""
    rng = np.random.default_rng(seed)
    ops = []
    for g in range(n_groups):
        flt = "/".join(f"v{int(x)}" for x in rng.integers(0, 6, 3))
        ops += [("sub", f"g{g}m{m}", f"$SHARE/grp{g}/{flt}", 1, 0, False) for m in range(members)]
    return ops


def _selected(subs):
    subs.select_shared()
    picks = {c: (s.filter, s.qos) for c, s in subs.shared_selected.items()}
    subs.merge_shared_selected()
    return picks, {c: (s.qos, s.no_local) for c, s in subs.subscriptions.items()}


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "ranges"])
@pytest.mark.parametrize("lazy", [True, False], ids=["views", "eager"])
def test_shared_selection_on_the_card_equals_the_cpu(dev, compact, lazy):
    """A small config-4 corpus, with one group on a wildcard filter (a
    wildcard-free set takes the exact-map route and no kernel), through
    ``TorchMatcher`` on the card, then ``select_shared`` and
    ``merge_shared_selected``: every pick and every merged target equals
    the same corpus on ``device="cpu"`` and the trie's own, before and
    after group members churn and fold (K3)."""
    ops = _cfg4_ops(5) + [("sub", f"w{m}", "$SHARE/grpw/v0/+/+", 1, 0, False) for m in range(4)]
    index = apply_port_ops(ops, TopicsIndex())
    rng = np.random.default_rng(6)
    topics = ["/".join(f"v{int(x)}" for x in rng.integers(0, 6, 3)) for _ in range(3000)]
    card = TorchMatcher(index, max_levels=4, device=dev, compact=compact, lazy=lazy)
    cpu = TorchMatcher(index, max_levels=4, device="cpu", compact=compact, lazy=lazy)
    for m in (card, cpu):
        m.rebuild()
    assert card.index.exact_map is None
    probes = kernels.LAUNCHES["flat_probe_ranges"] + kernels.LAUNCHES["flat_match_compact"]
    n_picks = 0
    for rnd in range(2):
        if rnd:
            # every group's first member leaves and comes back last
            churn = [o for o in ops if o[1].endswith("m0")][:150]
            apply_port_ops([("unsub",) + o[1:] for o in churn] + churn, index)
            launches = kernels.LAUNCHES["scatter_rows"]
            for m in (card, cpu):
                assert m.fold({o[2] for o in churn})
            assert kernels.LAUNCHES["scatter_rows"] == launches + 1
        for t, a, b in zip(topics, card.match_topics(topics), cpu.match_topics(topics)):
            want, got_card, got_cpu = _selected(index.subscribers(t)), _selected(a), _selected(b)
            assert got_card == got_cpu == want, t
            n_picks += len(want[0])
    # spilled entries (more members on one path than the id window) take
    # the host walk on both devices alike
    assert n_picks > 3000 and card.stats.host_fallbacks == cpu.stats.host_fallbacks < len(topics) // 4
    assert kernels.LAUNCHES["flat_probe_ranges"] + kernels.LAUNCHES["flat_match_compact"] > probes


def test_broker_on_the_card_over_loopback(dev):
    """The port's ``Server`` on the card behind a TCP listener: a
    cfg2-shaped corpus (20,000 subscriptions, all but 32 restored from a
    ``MemoryStore`` with no session), 32 clients that SUBSCRIBE their own
    cfg2 filters over TCP, one predicated subscriber
    (``+/+/+$GT{v:0.5}``), a few retained messages, and a wave of 2,048
    JSON publishes from a v4 QoS 0 and a v5 QoS 1 publisher. Every frame
    each client receives is the trie's selection (the predicated one
    filtered by the host interpreter), every retained delivery the trie's
    retained walk, and K1 (retained delivery at SUBSCRIBE), K2 (the staged
    batches) and K4 (the predicate leg) launched."""
    import random
    from collections import Counter

    import chip_smoke as cs
    from mqtt_tpu_torch.hooks.auth import AllowHook
    from mqtt_tpu_torch.hooks.storage.memory import MemoryStore
    from mqtt_tpu_torch.listeners import TCP, Config
    from mqtt_tpu_torch.predicates import compile_suffix, eval_rule_host
    from mqtt_tpu_torch.server import Options, Server

    rng = random.Random(21)
    entries, topic_gen = cs.cfg2_entries(20_000, rng)
    topics = [topic_gen() for _ in range(2048)]
    online = entries[:32]
    pred = "$GT{v:0.5}"
    spec = compile_suffix(pred)

    async def main():
        srv = Server(Options(device_matcher=True, matcher_opts={"max_levels": 4}, retained_matcher=True,
                             device="cuda"))
        srv.add_hook(AllowHook())
        store = MemoryStore()
        for cid, sub in entries[32:]:
            store.data["SUB_" + cid + ":" + sub.filter] = cs._sub_record(cid, sub.filter, sub.qos)
        srv.add_hook(store)
        srv.add_listener(TCP(Config(type="tcp", id="t", address="127.0.0.1:0")))
        await srv.serve()
        host, port = srv.listeners.get("t").address().rsplit(":", 1)
        port = int(port)
        retained = {f"region{i}/device{i}/metric{i}": b"ret%d" % i for i in range(40)}
        rpub = cs.WireClient("rpub", 4)
        await cs._connect_all([rpub], host, port, [cs.connect_frame("rpub", 4)])
        rpub.send(b"".join(cs.publish_frame(t, p, 0, retain=True) for t, p in retained.items()) + cs.PINGREQ_FRAME)
        await rpub.wait_frames(2, 60.0)
        clients = {cid: cs.WireClient(cid, 4 + k % 2) for k, (cid, _s) in enumerate(online)}
        clients["pred"] = cs.WireClient("pred", 5)
        pubs = [cs.WireClient("p4", 4), cs.WireClient("p5", 5)]
        every = list(clients.values()) + pubs
        await cs._connect_all(every, host, port, [cs.connect_frame(c.name, c.version) for c in every])
        k1 = kernels.LAUNCHES["flat_probe_ranges"]
        want_ret = {}
        for cid, sub in online:
            clients[cid].send(cs.subscribe_frame(1, [(sub.filter, sub.qos, 0)], clients[cid].version))
            want_ret[cid] = Counter((m.topic_name, bytes(m.payload)) for m in srv.topics.messages(sub.filter))
        clients["pred"].send(cs.subscribe_frame(1, [("+/+/+" + pred, 1, 0)], 5))
        # a payload without the field passes (the interpreter's skip-to-pass)
        want_ret["pred"] = Counter((m.topic_name, bytes(m.payload)) for m in srv.topics.messages("+/+/+")
                                   if eval_rule_host(spec, bytes(m.payload)))
        for cid, c in clients.items():
            await c.wait_frames(2 + sum(want_ret[cid].values()), 60.0)
        k1 = kernels.LAUNCHES["flat_probe_ranges"] - k1
        for cid, c in clients.items():
            got = Counter((p["topic"], p["payload"]) for p in cs._publishes(c, 2))
            assert got == want_ret[cid], cid
        await cs._await_fold(srv.matcher, "card test", 120.0)
        exp = {cid: Counter() for cid in clients}
        bufs = [bytearray(), bytearray()]
        for i, t in enumerate(topics):
            q = i % 2
            payload = json_payload = ('{"v": %.6f}' % rng.random()).encode()
            bufs[q] += cs.publish_frame(t, payload, q, i // 2 % 65535 + 1 if q else 0, version=4 + q)
            for cid, sub in srv.topics.subscribers(t).subscriptions.items():
                if cid in exp and (not sub.predicates or eval_rule_host(spec, json_payload)):
                    exp[cid][(t, min(q, sub.qos), payload)] += 1
        off = {cid: len(c.frames()) for cid, c in clients.items()}
        before = dict(kernels.LAUNCHES)
        for c, buf in zip(pubs, bufs):
            c.send(bytes(buf))
        for cid, c in clients.items():
            await c.wait_frames(off[cid] + sum(exp[cid].values()), 120.0)
        await pubs[1].wait_frames(1 + len(topics) // 2, 120.0)
        await cs._await_idle(srv)
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        for cid, c in clients.items():
            got = Counter((p["topic"], p["qos"], p["payload"]) for p in cs._publishes(c, off[cid]))
            assert got == exp[cid], cid
        for c in every + [rpub]:
            c.send(cs.disconnect_frame(c.version))
        for c in every + [rpub]:
            await c.ended(60.0)
        stats = srv.matcher.stats.as_dict()
        await srv.close()
        return k1, launched, exp, stats

    k1, launched, exp, stats = asyncio.run(main())
    assert sum(sum(e.values()) for e in exp.values()) > 300 and sum(exp["pred"].values()) > 500
    assert k1 > 0, "no retained delivery at SUBSCRIBE launched K1"
    assert launched["flat_match_compact"] > 0 and launched["rules_eval"] > 0, launched
    assert stats["topics"] - stats["host_fallbacks"] - stats["host_fast"] > len(topics) // 2
