"""Host-side topic tokenization and hashing for the device matcher.

Strings never reach the card: topic levels are tokenized and hashed on the
host. Each token gets two independent 32-bit hashes (salted blake2b), so a
false device match needs a simultaneous 64-bit collision (~2^-64 per
lookup). The hashes are those of the JAX package's tokenizer, pair for
pair, so both packages build the same flat index from the same trie.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=1 << 20)
def hash_token(token: str, salt: int = 0) -> tuple[int, int]:
    """Two independent u32 hashes of one topic level token."""
    d = hashlib.blake2b(
        token.encode("utf-8"), digest_size=8, salt=salt.to_bytes(8, "little")
    ).digest()
    return int.from_bytes(d[:4], "little"), int.from_bytes(d[4:], "little")


def tokenize_topics(
    topics: list[str], max_levels: int, salt: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize and hash a batch of PUBLISH topics.

    Returns ``(tok1[B,L], tok2[B,L], lengths[B], is_dollar[B], overflow[B])``
    — hashes padded with zeros past each topic's level count; ``overflow``
    marks topics with more than ``max_levels`` levels (routed to the host
    trie fallback). ``lengths`` counts levels capped at ``max_levels``; the
    empty topic has one (empty) level.
    """
    b = len(topics)
    zero = (0, 0)
    pad = [zero] * max_levels
    rows: list = []
    lengths = np.empty(b, dtype=np.int32)
    is_dollar = np.zeros(b, dtype=bool)
    overflow = np.zeros(b, dtype=bool)
    for i, topic in enumerate(topics):
        parts = topic.split("/")
        n = len(parts)
        if n > max_levels:
            overflow[i] = True
            n = max_levels
            parts = parts[:n]
        lengths[i] = n
        is_dollar[i] = topic.startswith("$")
        row = [hash_token(p, salt) for p in parts]
        row.extend(pad[: max_levels - n])
        rows.append(row)
    if b == 0 or max_levels == 0:
        tok = np.zeros((b, max_levels, 2), dtype=np.uint32)
    else:
        tok = np.array(rows, dtype=np.uint32)
    return (
        np.ascontiguousarray(tok[:, :, 0]),
        np.ascontiguousarray(tok[:, :, 1]),
        lengths,
        is_dollar,
        overflow,
    )
