"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``sm_90a`` and ``nvcc``; where
there is none it skips with that reason. All outputs are integers, so the
tolerance is 0. This module imports neither JAX nor the JAX package: run it
on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``.
"""

import asyncio

import pytest
import torch

from mqtt_tpu_torch import DeltaMatcher, MatchStage, TopicsIndex, TorchMatcher, subscribers_equal
from mqtt_tpu_torch.ops import flat, kernels

from test_torch_topics import (
    MAX_LEVELS,
    apply_port_ops,
    corpus_ops,
    corpus_topics,
    saturating_ops,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    kernels.library()  # builds csrc/flat_match.cu with nvcc on first use
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


@pytest.mark.parametrize("k", [1, 8, 300])
def test_scatter_rows_kernel_matches_plain(dev, index_pair, k):
    fl, arrays = index_pair
    g = torch.Generator(device="cpu").manual_seed(k)
    S = arrays[0].shape[0]
    uniq = torch.randperm(S, generator=g)[:k].to(torch.int32)
    rows_u = torch.randint(-(2**31), 2**31, (k, 16), generator=g, dtype=torch.int64).to(torch.int32)
    n = flat._bucket(k, minimum=8)
    idx = torch.cat([uniq, uniq[-1:].repeat(n - k)]).to(dev)
    rows = torch.cat([rows_u, rows_u[-1:].repeat(n - k, 1)]).to(dev)
    old = arrays[0].clone()
    got = flat.scatter_rows(arrays[0], idx, rows)
    assert torch.equal(got, flat.scatter_rows_plain(arrays[0], idx, rows))
    assert torch.equal(arrays[0], old)  # functional: the input is untouched


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
