"""The device plane: the batched wildcard topic matcher on PyTorch + CUDA.

- ``flat``     — compiles the host trie into a device-resident flat hash
                 table keyed by whole-path hashes; the match and fold entry
                 points, each beside its plain PyTorch version
- ``kernels``  — builds and launches the hand-written CUDA kernels
                 (``csrc/flat_match.cu``)
- ``hashing``  — host-side topic-level tokenization and dual u32 hashing
- ``matcher``  — the broker-facing ``TorchMatcher`` (drop-in for
                 ``TopicsIndex.subscribers``)
- ``delta``    — ``DeltaMatcher``: snapshot + host delta overlay +
                 background fold/rebuild, for live brokers under churn
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
    flat_match_packed,
    flat_match_ranges,
    pack_tokens,
    scatter_rows,
)
from .hashing import hash_token, tokenize_topics
from .kernels import KernelError
from .matcher import MatcherStats, TorchMatcher, expand_sids, subscribers_equal

__all__ = [
    "DeltaMatcher",
    "FlatIndex",
    "KIND_CLIENT",
    "KIND_INLINE",
    "KIND_SHARED",
    "KernelError",
    "MatcherStats",
    "SubEntry",
    "TorchMatcher",
    "build_flat_index",
    "device_index_from_numpy",
    "expand_sids",
    "flat_match_compact",
    "flat_match_packed",
    "flat_match_ranges",
    "hash_token",
    "pack_tokens",
    "scatter_rows",
    "subscribers_equal",
    "tokenize_topics",
]
