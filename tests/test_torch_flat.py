"""The port's flat-hash index and plain kernels against the JAX package.

The same seeded subscription mix goes into a JAX-package trie and a port
trie; the port's ``build_flat_index`` must produce arrays equal to the JAX
one's, and the port's plain PyTorch versions of the three kernels (probe
ranges, compaction, row scatter) must equal ``flat_match_packed`` /
``flat_match_ranges`` / ``flat_match_compact`` / ``scatter_rows`` run by
JAX on the CPU, bit for bit (tolerance 0: every output is an integer), on
the same arrays carried over with ``device_index_from_numpy``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mqtt_tpu.ops import flat as jflat
from mqtt_tpu.ops.hashing import tokenize_topics as jax_tokenize
from mqtt_tpu.packets import Subscription as JSubscription
from mqtt_tpu.topics import InlineSubscription as JInline
from mqtt_tpu.topics import TopicsIndex as JTopicsIndex

from mqtt_tpu_torch.ops import flat as tflat
from mqtt_tpu_torch.ops.hashing import tokenize_topics as torch_tokenize
from mqtt_tpu_torch.packets import Subscription as TSubscription
from mqtt_tpu_torch.topics import InlineSubscription as TInline
from mqtt_tpu_torch.topics import TopicsIndex as TTopicsIndex

from test_torch_topics import (
    MAX_LEVELS,
    _noop,
    corpus_ops,
    corpus_topics,
    saturating_ops,
)


# -- twin tries ---------------------------------------------------------------


def apply_ops(ops, jidx, tidx) -> None:
    """Apply one mutation list to a JAX-package trie and a port trie."""
    for op, client, flt, qos, ident, no_local in ops:
        if op == "sub":
            jidx.subscribe(client, JSubscription(filter=flt, qos=qos, identifier=ident, no_local=no_local))
            tidx.subscribe(client, TSubscription(filter=flt, qos=qos, identifier=ident, no_local=no_local))
        elif op == "unsub":
            jidx.unsubscribe(flt, client)
            tidx.unsubscribe(flt, client)
        else:
            jidx.inline_subscribe(JInline(filter=flt, identifier=ident, handler=_noop))
            tidx.inline_subscribe(TInline(filter=flt, identifier=ident, handler=_noop))


def twin_tries(ops):
    jidx, tidx = JTopicsIndex(), TTopicsIndex()
    apply_ops(ops, jidx, tidx)
    return jidx, tidx


CORPORA = {
    "mixed": lambda: corpus_ops(7),
    "mixed_alt": lambda: corpus_ops(8, n_subs=1200),
    "saturated": saturating_ops,
    "exact_only": lambda: [("sub", f"c{i}", f"a/{i % 50}/b", i % 3, 0, False) for i in range(300)],
    "empty": lambda: [],
}


def build_twins(ops, max_levels=MAX_LEVELS, window=16):
    jidx, tidx = twin_tries(ops)
    jf = jflat.build_flat_index(jidx, max_levels=max_levels, window=window)
    tf = tflat.build_flat_index(tidx, max_levels=max_levels, window=window)
    return jidx, tidx, jf, tf


def packed_batch(topics, flat):
    """The packed [B, 2L+2] token matrix of ``topics`` padded to a power of
    two with empty topics, as the matcher issues it."""
    b = len(topics)
    padded = topics + [""] * (tflat._bucket(max(1, b), minimum=16) - b)
    tok1, tok2, lengths, is_dollar, _ = jax_tokenize(padded, flat.max_levels, flat.salt)
    return jflat.pack_tokens(tok1, tok2, lengths, is_dollar)


def jax_arrays(flat):
    return tuple(jnp.asarray(a) for a in (flat.table, flat.pat_kind, flat.pat_depth, flat.pat_mask))


def torch_arrays(flat):
    return tflat.device_index_from_numpy(
        flat.table, flat.pat_kind, flat.pat_depth, flat.pat_mask, device="cpu"
    )


# -- (a) the host build -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_build_flat_index_matches_jax(name):
    _, _, jf, tf = build_twins(CORPORA[name]())
    for field in ("table", "pat_kind", "pat_depth", "pat_mask"):
        a, b = getattr(jf, field), getattr(tf, field)
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    for field in ("salt", "window", "max_levels", "n_entries", "n_subs", "n_sat", "n_spill"):
        assert getattr(jf, field) == getattr(tf, field), field
    assert (jf.exact_map is None) == (tf.exact_map is None)
    if name == "saturated":
        assert tf.n_sat >= 1
    if name.startswith("mixed"):
        assert tf.n_spill >= 1
        assert tf.num_patterns > 0


def test_build_with_window_and_levels_matches_jax():
    _, _, jf, tf = build_twins(corpus_ops(11, n_subs=800), max_levels=4, window=8)
    assert np.array_equal(jf.table, tf.table)
    assert np.array_equal(jf.pat_mask, tf.pat_mask)
    assert tf.n_spill == jf.n_spill


def test_tokenizer_matches_jax():
    topics = corpus_topics(3) + ["ünïcode/topic", "/", "a//b", "$share/x"]
    for salt in (0, 5):
        ja = jax_tokenize(topics, MAX_LEVELS, salt)
        ta = torch_tokenize(topics, MAX_LEVELS, salt)
        for a, b in zip(ja, ta):
            assert a.dtype == b.dtype
            assert np.array_equal(a, b)
    empty = torch_tokenize([], MAX_LEVELS)
    assert empty[0].shape == (0, MAX_LEVELS)


# -- (b) the plain kernels ----------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    jidx, tidx, jf, tf = build_twins(corpus_ops(7))
    packed = packed_batch(corpus_topics(5), jf)
    return jf, packed


@pytest.mark.parametrize("name", ["mixed", "saturated", "empty"])
def test_packed_matches_jax(name):
    _, _, jf, _ = build_twins(CORPORA[name]())
    topics = corpus_topics(5) + ["plain/topic", "sat1", "wild/q"]
    packed = packed_batch(topics, jf)
    want = np.asarray(jflat.flat_match_packed(*jax_arrays(jf), jnp.asarray(packed), max_levels=jf.max_levels))
    got = tflat.flat_match_packed(*torch_arrays(jf), torch.from_numpy(packed), max_levels=jf.max_levels)
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    if name == "mixed":
        assert want[:, -1].any(), "the batch must exercise the overflow column"
        assert want[:, -2].sum() > 0


def test_ranges_matches_jax(mixed):
    jf, packed = mixed
    L = jf.max_levels
    tok1 = packed[:, :L].view(np.uint32)
    tok2 = packed[:, L : 2 * L].view(np.uint32)
    lengths = packed[:, 2 * L]
    is_dollar = packed[:, 2 * L + 1].astype(bool)
    want = jflat.flat_match_ranges(
        *jax_arrays(jf), jnp.asarray(tok1), jnp.asarray(tok2), jnp.asarray(lengths),
        jnp.asarray(is_dollar), max_levels=L,
    )
    got = tflat.flat_match_ranges(
        *torch_arrays(jf), torch.from_numpy(packed[:, :L].copy()), torch.from_numpy(packed[:, L : 2 * L].copy()),
        torch.from_numpy(lengths.copy()), torch.from_numpy(is_dollar), max_levels=L,
    )
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), w)
    assert got[3].dtype == torch.bool


def _hits(jf, packed) -> int:
    out = np.asarray(jflat.flat_match_packed(*jax_arrays(jf), jnp.asarray(packed), max_levels=jf.max_levels))
    return int(out[:, -2].sum())


@pytest.mark.parametrize("fit", ["exact", "slack", "overflow", "one"])
def test_compact_matches_jax(mixed, fit):
    jf, packed = mixed
    n_hits = _hits(jf, packed)
    assert n_hits > 8
    capacity = {"exact": n_hits, "slack": n_hits + 37, "overflow": n_hits // 3, "one": 1}[fit]
    want = np.asarray(
        jflat.flat_match_compact(*jax_arrays(jf), jnp.asarray(packed), max_levels=jf.max_levels, capacity=capacity)
    )
    got = tflat.flat_match_compact(
        *torch_arrays(jf), torch.from_numpy(packed), max_levels=jf.max_levels, capacity=capacity
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(want[0]) == n_hits
    assert bool(want[1]) == (n_hits > capacity)


def test_compact_and_packed_with_no_patterns_match_jax():
    _, _, jf, _ = build_twins([])
    assert jf.num_patterns == 0
    packed = packed_batch(["a/b", "c", ""], jf)
    for capacity in (8, 256):
        want = np.asarray(
            jflat.flat_match_compact(*jax_arrays(jf), jnp.asarray(packed), max_levels=jf.max_levels, capacity=capacity)
        )
        got = tflat.flat_match_compact(
            *torch_arrays(jf), torch.from_numpy(packed), max_levels=jf.max_levels, capacity=capacity
        )
        assert np.array_equal(got.numpy(), want)
    L = jf.max_levels
    want = jflat.flat_match_ranges(
        *jax_arrays(jf), jnp.asarray(packed[:, :L].view(np.uint32)), jnp.asarray(packed[:, L : 2 * L].view(np.uint32)),
        jnp.asarray(packed[:, 2 * L]), jnp.asarray(packed[:, 2 * L + 1].astype(bool)), max_levels=L,
    )
    got = tflat.flat_match_ranges(
        *torch_arrays(jf), torch.from_numpy(packed[:, :L].copy()), torch.from_numpy(packed[:, L : 2 * L].copy()),
        torch.from_numpy(packed[:, 2 * L].copy()), torch.from_numpy(packed[:, 2 * L + 1].copy()), max_levels=L,
    )
    for w, g in zip(want, got):
        assert tuple(g.shape) == np.asarray(w).shape
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 5, 8, 37])
def test_scatter_rows_matches_jax(mixed, k):
    jf, _ = mixed
    rng = np.random.default_rng(k)
    S = jf.table.shape[0]
    n = tflat._bucket(k, minimum=8)
    uniq = rng.choice(S, size=k, replace=False).astype(np.int32)
    rows_u = rng.integers(0, 1 << 32, size=(k, 16), dtype=np.uint64).astype(np.uint32)
    # pad to a power of two by repeating the last pair, as the fold does
    idx = np.concatenate([uniq, np.full(n - k, uniq[-1], np.int32)])
    rows = np.concatenate([rows_u, np.tile(rows_u[-1], (n - k, 1))])
    want = np.asarray(jflat.scatter_rows(jnp.asarray(jf.table), jnp.asarray(idx), jnp.asarray(rows)))
    table_t = tflat.device_i32(jf.table, "cpu")
    got = tflat.scatter_rows(table_t, torch.from_numpy(idx), tflat.device_i32(rows, "cpu"))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # functional: the input table is untouched
    assert np.array_equal(table_t.numpy().view(np.uint32), jf.table)


def test_device_index_copies_the_numpy_arrays(mixed):
    jf, _ = mixed
    arrays = torch_arrays(jf)
    assert all(a.dtype == torch.int32 for a in arrays)
    assert arrays[0].shape == jf.table.shape
    assert not np.shares_memory(arrays[0].numpy(), jf.table)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflat.device_index_from_numpy(
            np.zeros((1024, 16), np.uint32), np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, np.uint32)
        )


def test_probe_slots_counts_active_probes(mixed):
    jf, packed = mixed
    slots = tflat.probe_slots(*torch_arrays(jf), torch.from_numpy(packed), max_levels=jf.max_levels)
    lengths = packed[:, 2 * jf.max_levels]
    hash_pat = jf.pat_kind == np.uint32(tflat.KIND_HASH)
    active = np.where(
        hash_pat[None, :], jf.pat_depth[None, :] <= lengths[:, None], jf.pat_depth[None, :] == lengths[:, None]
    )
    assert slots.shape[0] == int(active.sum())
    assert int(slots.max()) < jf.table.shape[0]
