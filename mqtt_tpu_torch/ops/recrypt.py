"""The device half of per-subscriber payload re-encryption: AES-128-CTR
keystream generation, vectorized over blocks (MQT-TZ, arxiv 2007.12442).

Two independent paths compute the same bytes:

- ``host_keystream``: numpy AES in the fused T-table formulation — the
  sampled oracle of the tenancy engine, and the path for batches too
  small to be worth a launch.
- ``keystream``: one launch evaluates every counter block of every job in
  a staged batch or fan-out tick (K6 in ``csrc/recrypt.cu`` on CUDA
  tensors; its plain PyTorch version, the byte-wise S-box/ShiftRows/
  MixColumns formulation, on CPU tensors). Per-block round keys are
  gathered from a dense key table by index.

CTR framing (SP 800-38A): the counter block of block ``i`` of a message is
``nonce(12 bytes) || BE32(i)``; the wire payload of an encrypted publish is
``nonce || ciphertext``. The XOR with the payload runs on the host.

The S-box is generated from its GF(2^8) definition, not transcribed; the
tests pin the construction to the FIPS-197 C.1 block vector and the
SP 800-38A F.5.1 CTR vector.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import kernels
from .flat import _bucket, resolve_device

#: bytes per AES block / per keystream row
BLOCK = 16
#: wire nonce prefix of an encrypted payload (counter block = nonce || BE32(i))
NONCE_BYTES = 12
#: AES-128 rounds (round keys are [11, 16])
ROUNDS = 10


def _build_sbox() -> np.ndarray:
    """The AES S-box from the field definition: the multiplicative
    inverse in GF(2^8), then the affine transform."""
    sbox = [0] * 256
    p = q = 1
    while True:
        # p walks the multiplicative group via generator 3; q tracks 1/p
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        q &= 0xFF
        affine = (
            q
            ^ ((q << 1) | (q >> 7))
            ^ ((q << 2) | (q >> 6))
            ^ ((q << 3) | (q >> 5))
            ^ ((q << 4) | (q >> 4))
        ) & 0xFF
        sbox[p] = affine ^ 0x63
        if p == 1:
            break
    sbox[0] = 0x63
    return np.array(sbox, dtype=np.uint8)


SBOX = _build_sbox()

# ShiftRows as a flat permutation over the column-major state layout
# (state[4c + r]): row r rotates left by r, so out[4c+r] = in[4((c+r)%4)+r]
SHIFT_ROWS = np.array(
    [4 * (((i // 4) + (i % 4)) % 4) + (i % 4) for i in range(16)],
    dtype=np.int32,
)


def expand_key(key: bytes) -> np.ndarray:
    """FIPS-197 AES-128 key expansion: 16-byte key -> uint8 [11, 16]
    round keys (flat, in the byte order of the state and counter blocks)."""
    if len(key) != 16:
        raise ValueError(f"AES-128 key must be 16 bytes, got {len(key)}")
    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]  # RotWord
            t = [int(SBOX[b]) for b in t]  # SubWord
            t[0] ^= rcon
            rcon = ((rcon << 1) ^ 0x1B) & 0xFF if rcon & 0x80 else rcon << 1
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, dtype=np.uint8).reshape(ROUNDS + 1, 16)


def _build_ttables() -> tuple:
    """The four fused SubBytes+ShiftRows+MixColumns tables in the native
    little-endian word packing of ``_as_words`` (byte k of a word is
    state row k of its column)."""
    s = SBOX.astype(np.uint32)
    s2 = ((s << 1) ^ (0x1B * (s >> 7))) & 0xFF
    s3 = s2 ^ s

    def pack(b0, b1, b2, b3):
        return (b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)).astype(np.uint32)

    return pack(s2, s, s, s3), pack(s3, s2, s, s), pack(s, s3, s2, s), pack(s, s, s3, s2)


_T0, _T1, _T2, _T3 = _build_ttables()


def _as_words(a: np.ndarray) -> np.ndarray:
    """Flat uint8 [..., 16] state -> native uint32 [..., 4] column words."""
    return np.ascontiguousarray(a).view(np.uint32).reshape(*a.shape[:-1], 4)


def aes_encrypt_blocks(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Numpy AES-128 of ``blocks`` uint8 [N, 16] under per-block
    ``round_keys`` uint8 [N, 11, 16], in the T-table formulation: the
    host path and the kernel's oracle."""
    rkw = _as_words(round_keys)  # [N, 11, 4]
    w = _as_words(blocks) ^ rkw[:, 0]  # [N, 4]
    # output column c takes T_k[byte k of column (c+k) % 4]
    r1, r2, r3 = (1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2)
    for rnd in range(1, ROUNDS):
        b = w.view(np.uint8).reshape(-1, 4, 4)  # [N, column, byte]
        w = (
            np.take(_T0, b[:, :, 0])
            ^ np.take(_T1, b[:, r1, 1])
            ^ np.take(_T2, b[:, r2, 2])
            ^ np.take(_T3, b[:, r3, 3])
            ^ rkw[:, rnd]
        )
    # last round: SubBytes + ShiftRows + AddRoundKey (no MixColumns)
    s = np.ascontiguousarray(w).view(np.uint8).reshape(-1, BLOCK)
    s = SBOX[s]
    s = s[:, SHIFT_ROWS]
    return (s ^ round_keys[:, ROUNDS]).astype(np.uint8)


def host_keystream(key_table: np.ndarray, kidx: np.ndarray, counters: np.ndarray) -> np.ndarray:
    """The numpy keystream: each block's round keys gathered from
    ``key_table`` uint8 [T, 11, 16] by ``kidx`` int32 [N], then
    ``counters`` uint8 [N, 16] encrypted."""
    if len(kidx) == 0:
        return np.zeros((0, BLOCK), dtype=np.uint8)
    return aes_encrypt_blocks(key_table[kidx], counters)


def _xtime(v: torch.Tensor) -> torch.Tensor:
    """GF(2^8) doubling on uint8 tensors."""
    return (v << 1) ^ ((v >> 7) * 0x1B)


def keystream_plain(key_table, kidx, counters):
    """The plain version of K6 (``keystream_core``): AES-128 in the
    byte-wise S-box / ShiftRows / MixColumns formulation over uint8
    tensors. ``kidx`` follows ``jnp.take``: a negative index wraps once,
    and one still out of range reads round keys of 0xFF."""
    T = key_table.shape[0]
    device = counters.device
    k = kidx.long()
    k = torch.where(k < 0, k + T, k)
    valid = (k >= 0) & (k < T)
    rk = key_table[k.clamp(0, max(T - 1, 0))]  # [N, 11, 16]
    rk = torch.where(valid[:, None, None], rk, torch.full_like(rk, 0xFF))
    sbox = torch.from_numpy(SBOX).to(device)
    shift = torch.from_numpy(SHIFT_ROWS).long().to(device)

    def mix(s):
        c = s.reshape(-1, 4, 4)
        a0, a1, a2, a3 = c[:, :, 0], c[:, :, 1], c[:, :, 2], c[:, :, 3]
        x0, x1, x2, x3 = _xtime(a0), _xtime(a1), _xtime(a2), _xtime(a3)
        out = torch.stack(
            [
                x0 ^ x1 ^ a1 ^ a2 ^ a3,
                a0 ^ x1 ^ x2 ^ a2 ^ a3,
                a0 ^ a1 ^ x2 ^ x3 ^ a3,
                x0 ^ a0 ^ a1 ^ a2 ^ x3,
            ],
            dim=2,
        )
        return out.reshape(-1, 16)

    s = counters ^ rk[:, 0]
    for rnd in range(1, ROUNDS):
        s = sbox[s.long()]
        s = s[:, shift]
        s = mix(s)
        s = s ^ rk[:, rnd]
    s = sbox[s.long()]
    s = s[:, shift]
    return s ^ rk[:, ROUNDS]


def keystream(key_table, kidx, counters):
    """K6 on CUDA tensors, its plain version on CPU tensors."""
    if counters.device.type == "cpu":
        return keystream_plain(key_table, kidx, counters)
    return kernels.keystream(key_table, kidx, counters)


def ctr_counters(nonce: bytes, n_blocks: int, start: int = 0) -> np.ndarray:
    """Counter blocks ``nonce || BE32(start + i)`` as uint8 [n, 16]."""
    out = np.zeros((n_blocks, BLOCK), dtype=np.uint8)
    if n_blocks == 0:
        return out
    out[:, :NONCE_BYTES] = np.frombuffer(nonce[:NONCE_BYTES], dtype=np.uint8)
    ctr = (start + np.arange(n_blocks, dtype=np.uint32)).astype(">u4")
    out[:, NONCE_BYTES:] = ctr.view(np.uint8).reshape(n_blocks, 4)
    return out


def xor_into(data: bytes, ks_rows: np.ndarray) -> bytes:
    """XOR ``data`` against the flattened keystream rows (cut to the data
    length): the CTR en/decrypt step, on the host."""
    if not data:
        return b""
    flat = ks_rows.reshape(-1)[: len(data)]
    return (np.frombuffer(data, dtype=np.uint8) ^ flat).tobytes()


def keystream_async(
    key_table: np.ndarray, kidx: np.ndarray, counters: np.ndarray, device="cuda"
) -> Callable[[], np.ndarray]:
    """Issue one keystream launch on ``device``; returns a zero-arg
    resolver yielding uint8 [N, 16] rows. The block axis pads to a power
    of two of at least 16 (key 0, zero counters; sliced off at resolve);
    the key table ships at its true size. On the card the rows come back
    into a pinned buffer of this batch's own, behind an event."""
    device = resolve_device(device)
    n = len(kidx)
    pad_n = _bucket(max(1, n), minimum=16)
    k = np.zeros(pad_n, dtype=np.int32)
    c = np.zeros((pad_n, BLOCK), dtype=np.uint8)
    k[:n] = kidx
    c[:n] = counters
    table_t = torch.from_numpy(np.ascontiguousarray(key_table))
    k_t = torch.from_numpy(k)
    c_t = torch.from_numpy(c)
    if device.type == "cpu":
        rows = keystream(table_t, k_t, c_t)
        return lambda: rows.numpy()[:n]
    ins = tuple(t.pin_memory().to(device, non_blocking=True) for t in (table_t, k_t, c_t))
    rows_dev = keystream(*ins)
    host = torch.empty(rows_dev.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(rows_dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    in_flight = (ins, rows_dev)  # referenced until the batch resolves

    def resolve() -> np.ndarray:
        done.synchronize()
        assert in_flight
        return host.numpy()[:n]

    return resolve
