"""The device plane on PyTorch + CUDA: the batched wildcard topic matcher,
the payload-predicate rule table and the re-encryption keystream.

- ``flat``     — compiles the host trie into a device-resident flat hash
                 table keyed by whole-path hashes; the match and fold entry
                 points, each beside its plain PyTorch version
- ``kernels``  — builds and launches the hand-written CUDA kernels
                 (``csrc/flat_match.cu``, ``predicates.cu``, ``recrypt.cu``,
                 ``sharded.cu``)
- ``predicates`` — the predicate rule table (``rules_eval``) and the
                 window reduction (``agg_reduce``)
- ``recrypt``  — AES-128-CTR keystream (``keystream``) and its numpy oracle
- ``hashing``  — host-side topic-level tokenization and dual u32 hashing
                 (the C tokenizer of ``native/``, beside its plain version)
- ``matcher``  — the broker-facing ``TorchMatcher`` (drop-in for
                 ``TopicsIndex.subscribers``); results come from the C
                 materializer of ``native/``, its plain versions beside it
- ``retained`` — ``RetainedMatchEngine``: wildcard SUBSCRIBE against the
                 retained store, K1 run in reverse over a device-resident
                 corpus of retained topic names
- ``devicestats`` — the first-launch ledger (a ``KernelWatch`` around
                 every CUDA wrapper), the build notes and the per-card
                 memory and tile-skew gauges (``DeviceStatsPlane``)
- ``delta``    — ``DeltaMatcher``: snapshot + host delta overlay +
                 background fold/rebuild, for live brokers under churn; with
                 a mesh its snapshot is ``parallel.ShardedTorchMatcher``
"""

from .delta import DeltaMatcher
from .flat import (
    KIND_CLIENT,
    KIND_INLINE,
    KIND_SHARED,
    FlatIndex,
    SubEntry,
    build_flat_index,
    device_index_from_numpy,
    flat_match_compact,
    flat_match_core,
    flat_match_packed,
    flat_match_ranges,
    pack_tokens,
    scatter_rows,
)
from .hashing import hash_token, hash_token_py, tokenize_topics, tokenize_topics_py
from .kernels import KernelError
from .matcher import (
    MatcherStats,
    TorchMatcher,
    expand_sids,
    expand_snap_py,
    resolve_compact_py,
    resolve_ranges_py,
    subscribers_equal,
)
from .retained import RetainedMatchEngine

__all__ = [
    "DeltaMatcher",
    "FlatIndex",
    "KIND_CLIENT",
    "KIND_INLINE",
    "KIND_SHARED",
    "KernelError",
    "MatcherStats",
    "RetainedMatchEngine",
    "SubEntry",
    "TorchMatcher",
    "build_flat_index",
    "device_index_from_numpy",
    "expand_sids",
    "expand_snap_py",
    "flat_match_compact",
    "flat_match_core",
    "flat_match_packed",
    "flat_match_ranges",
    "hash_token",
    "hash_token_py",
    "pack_tokens",
    "resolve_compact_py",
    "resolve_ranges_py",
    "scatter_rows",
    "subscribers_equal",
    "tokenize_topics",
    "tokenize_topics_py",
]
