"""The port's tenant re-encryption plane against the JAX package, on the CPU.

K6 ``keystream`` (its plain PyTorch version here) on the FIPS-197 C.1 and
SP 800-38A F.5.1 vectors and against the JAX package's ``keystream_core``
on seeded tables, tolerance 0 (AES is exact). Then ``KeyRegistry`` and
``RecryptEngine`` against ``mqtt_tpu.tenancy``: the same keys give the
same round-key table, and engines seeded with the same nonce stream give
byte-identical sealed fan-outs and decrypted publishes, epoch-tagged
nonces included.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mqtt_tpu.ops import recrypt as jrec
from mqtt_tpu.tenancy import KeyRegistry as JKeyRegistry
from mqtt_tpu.tenancy import RecryptEngine as JEngine
from mqtt_tpu.tenancy import TenantPlane

from mqtt_tpu_torch import tenancy as tten
from mqtt_tpu_torch.ops import recrypt as trec

KEY_A = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
KEY_S = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")


def _plain(table, kidx, counters) -> np.ndarray:
    return trec.keystream(torch.from_numpy(table), torch.from_numpy(kidx), torch.from_numpy(counters)).numpy()


def test_fips_197_c1_block():
    rk = trec.expand_key(KEY_A)
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"), dtype=np.uint8).reshape(1, 16)
    want = "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert _plain(rk[None], np.zeros(1, np.int32), pt.copy()).tobytes().hex() == want
    assert trec.aes_encrypt_blocks(rk[None], pt).tobytes().hex() == want


def test_sp800_38a_f51_ctr_keystream():
    rk = trec.expand_key(KEY_S)
    ctr = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), dtype=np.uint8).reshape(1, 16)
    ks = _plain(rk[None], np.zeros(1, np.int32), ctr.copy())
    pt1 = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a")
    assert trec.xor_into(pt1, ks).hex() == "874d6191b620e3261bef6864990db6ce"


def test_tables_match_jax():
    assert np.array_equal(trec.SBOX, jrec.SBOX)
    assert np.array_equal(trec.SHIFT_ROWS, jrec.SHIFT_ROWS)
    for key in (KEY_A, KEY_S, bytes(16), b"\xff" * 16):
        assert np.array_equal(trec.expand_key(key), jrec.expand_key(key))
    with pytest.raises(ValueError):
        trec.expand_key(b"short")


def test_cuda_sbox_table_is_the_field_sbox():
    """K6 carries the S-box as a constant table in its source: it must be
    the one built from the field definition (and pinned by the vectors
    above)."""
    src = (Path(trec.__file__).resolve().parent.parent / "csrc" / "recrypt.cu").read_text()
    body = re.search(r"kSbox\[256\] = \{(.*?)\};", src, re.S).group(1)
    table = np.array([int(v, 16) for v in re.findall(r"0x[0-9a-fA-F]{2}", body)], dtype=np.uint8)
    assert table.shape == (256,) and np.array_equal(table, trec.SBOX)


@pytest.mark.parametrize("seed,T,N", [(0, 1, 1), (1, 2, 17), (2, 7, 300), (3, 512, 4096)])
def test_keystream_plain_matches_jax(seed, T, N):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (T, 11, 16), dtype=np.uint8)
    # indices past both ends: jnp.take wraps a negative index once and
    # fills the rest with 0xFF round keys
    kidx = rng.integers(-T - 2, T + 2, N).astype(np.int32)
    counters = rng.integers(0, 256, (N, 16), dtype=np.uint8)
    want = np.asarray(jax.jit(jrec.keystream_core)(table, kidx, counters))
    got = _plain(table, kidx, counters)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    ok = np.clip(kidx, 0, T - 1)
    assert np.array_equal(trec.host_keystream(table, ok, counters), _plain(table, ok, counters))


@pytest.mark.parametrize("n", [1, 15, 16, 100])
def test_keystream_async_matches_jax(n):
    rng = np.random.default_rng(n)
    table = np.stack([trec.expand_key(KEY_A), trec.expand_key(KEY_S)])
    kidx = rng.integers(0, 2, n).astype(np.int32)
    counters = trec.ctr_counters(bytes(range(12)), n, start=7)
    assert np.array_equal(counters, jrec.ctr_counters(bytes(range(12)), n, start=7))
    got = trec.keystream_async(table, kidx, counters, device="cpu")()
    assert got.shape == (n, 16)
    assert np.array_equal(got, jrec.keystream_async(table, kidx, counters)())


def _registries():
    jreg, treg = JKeyRegistry(), tten.KeyRegistry()
    for reg in (jreg, treg):
        for t in range(3):
            for k in range(5):
                reg.set_key(f"t{t}", f"c{k}", bytes([t, k]) * 8)
        reg.set_key("t0", "c1", KEY_S)  # a rotation in place
    return jreg, treg


def test_key_registry_table_matches_jax():
    jreg, treg = _registries()
    assert np.array_equal(treg.table(), jreg.table())
    for reg in (jreg, treg):
        reg.stage_epoch("t1", {"c0": KEY_A, "c3": KEY_S})
        reg.activate_epoch("t1")
        reg.stage_epoch("t1", {"c0": KEY_S})
        reg.activate_epoch("t1")
        reg.retire_epoch("t1", 0)
    assert np.array_equal(treg.table(), jreg.table())
    for args in (("t1", "c0", 0), ("t1", "c0", 1), ("t1", "c0", 2), ("t1", "c3", 1), ("t2", "c4", 0)):
        assert treg.kid_for_epoch(*args) == jreg.kid_for_epoch(*args)
    idents = [("c9", "c1"), ("",), ("c0",), ("c3", "c0")]
    assert treg.key_ids_with_epoch("t1", idents) == jreg.key_ids_with_epoch("t1", idents)
    assert (len(treg), treg.current_epoch("t1"), treg.has_epochs("t1")) == (
        len(jreg), jreg.current_epoch("t1"), jreg.has_epochs("t1"))


def _engines(**kw):
    jreg, treg = _registries()
    jeng = JEngine(jreg, oracle_sample=1, **kw)
    teng = tten.RecryptEngine(treg, oracle_sample=1, device="cpu", **kw)
    jeng.reseed_nonce(b"seed", 40)
    teng.reseed_nonce(b"seed", 40)
    jt = TenantPlane().register("t0", encrypted=("e/",))
    tt = tten.Tenant("t0", encrypted=("e/",))
    return jeng, teng, jt, tt


@pytest.mark.parametrize("size", [0, 1, 16, 17, 256, 4096])
def test_engine_seal_and_open_match_jax(size):
    jeng, teng, jt, tt = _engines()
    plaintext = (bytes(range(256)) * (size // 256 + 1))[:size]
    wire = teng.seal_with_key(KEY_S, plaintext)
    assert wire == jeng.seal_with_key(KEY_S, plaintext)
    jjob, tjob = jeng.decrypt_job(jt, ("c1",), wire), teng.decrypt_job(tt, ("c1",), wire)
    assert (tjob.key_id, tjob.nonce, tjob.n_blocks, tjob.error) == (jjob.key_id, jjob.nonce, jjob.n_blocks, jjob.error)
    assert teng.open_publish(tt, ("c1",), wire, tjob) == plaintext == jeng.open_publish(jt, ("c1",), wire, jjob)
    targets = [(f"s{i}", (f"c{i % 7}", "c2")) for i in range(9)] + [("nokey", ("zz",))]
    sealed_t = teng.seal_fanout(tt, plaintext, targets)
    sealed_j = jeng.seal_fanout(jt, plaintext, targets)
    assert sealed_t == sealed_j and "nokey" not in sealed_t
    for tkey, idents in targets[:-1]:
        kid = teng.keys.key_ids("t0", [idents])[0]
        key = next(k for k in [bytes([0, j]) * 8 for j in range(5)] + [KEY_S]
                   if np.array_equal(trec.expand_key(k), teng.keys.table()[kid]))
        assert teng.open_with_key(key, sealed_t[tkey]) == plaintext
    g_t, g_j = teng.gauges(), jeng.gauges()
    for k in ("fanouts", "device_blocks", "host_blocks", "no_key_drops", "oracle_checks", "oracle_mismatches"):
        assert g_t[k] == g_j[k], k
    assert g_t["oracle_mismatches"] == 0


def test_engine_epoch_tagged_nonces_match_jax():
    jeng, teng, jt, tt = _engines()
    for eng in (jeng, teng):
        eng.keys.stage_epoch("t0", {"c1": KEY_A, "c2": KEY_S})
        eng.keys.activate_epoch("t0")
    targets = [("a", ("c1",)), ("b", ("c2",)), ("c", ("c4",))]
    sealed_t = teng.seal_fanout(tt, b"x" * 40, targets)
    assert sealed_t == jeng.seal_fanout(jt, b"x" * 40, targets)
    assert tten.nonce_epoch(sealed_t["a"][:12]) == 1 and sealed_t["a"][0] == tten.EPOCH_NONCE_MAGIC
    # a publish sealed under the old epoch's key still opens, by its tag
    old = teng.seal_with_key(KEY_S, b"y" * 33, tten.epoch_tag_nonce(bytes(12), 0))
    for eng, t in ((teng, tt), (jeng, jt)):
        assert eng.open_publish(t, ("c1",), old) == b"y" * 33
    new = teng.seal_with_key(KEY_A, b"z" * 5, tten.epoch_tag_nonce(bytes(12), 1))
    assert teng.open_publish(tt, ("c1",), new) == jeng.open_publish(jt, ("c1",), new) == b"z" * 5


def test_issue_batch_attaches_the_same_keystream_as_jax():
    jeng, teng, jt, tt = _engines(device_min_blocks=1)
    rng = random.Random(3)
    wires = [teng.seal_with_key(KEY_S, bytes(rng.randrange(256) for _ in range(rng.randrange(0, 90))))
             for _ in range(12)]
    wires += [b"short"]
    jjobs = [jeng.decrypt_job(jt, ("c1",), w) for w in wires] + [None]
    tjobs = [teng.decrypt_job(tt, ("c1",), w) for w in wires] + [None]
    jeng.attach(jeng.issue_batch(jjobs)())
    teng.attach(teng.issue_batch(tjobs)())
    for j, t, w in zip(jjobs, tjobs, wires):
        assert t.error == j.error
        if j.keystream is None:
            assert t.keystream is None
        else:
            assert np.array_equal(t.keystream, j.keystream)
            assert teng.open_publish(tt, ("c1",), w, t) == jeng.open_publish(jt, ("c1",), w, j)
    assert teng.device_blocks == jeng.device_blocks and teng.oracle_mismatches == 0


def test_small_batches_take_the_host_keystream_counted():
    _jeng, teng, _jt, tt = _engines(device_min_blocks=64)
    wire = teng.seal_with_key(KEY_S, b"q" * 40)
    job = teng.decrypt_job(tt, ("c1",), wire)
    assert teng.issue_batch([job]) is None
    assert teng.open_publish(tt, ("c1",), wire, job) == b"q" * 40
    teng.seal_fanout(tt, b"q" * 40, [("s", ("c2",))])
    assert teng.host_reasons == {"no_keystream": 3, "small_batch": 3}
    assert teng.device_batches == 0 and teng.host_blocks == 6


def test_keyless_and_malformed_jobs():
    _jeng, teng, _jt, tt = _engines()
    job = teng.decrypt_job(tt, ("nobody", ""), b"\x00" * 64)
    assert job.error == "no_key" and teng.no_key_drops == 1
    job = teng.decrypt_job(tt, ("c1",), b"short")
    assert job.error == "malformed" and teng.malformed == 1
    assert teng.open_publish(tt, ("c1",), b"short") is None


def test_a_disabled_device_takes_the_host_keystream_as_jax():
    """``set_device_enabled(False)`` in both engines: the staged decrypt
    issues nothing, the fan-out seal and the re-seal take the host
    keystream, and every byte equals the JAX engine's; switched on again,
    the seal rides the device in both."""
    jeng, teng, jt, tt = _engines(device_min_blocks=1)
    for eng in (jeng, teng):
        eng.set_device_enabled(False)
    wire = teng.seal_with_key(KEY_S, b"p" * 70)
    assert wire == jeng.seal_with_key(KEY_S, b"p" * 70)
    jjob, tjob = jeng.decrypt_job(jt, ("c1",), wire), teng.decrypt_job(tt, ("c1",), wire)
    assert jeng.issue_batch([jjob]) is None and teng.issue_batch([tjob]) is None
    assert teng.open_publish(tt, ("c1",), wire, tjob) == jeng.open_publish(jt, ("c1",), wire, jjob) == b"p" * 70
    targets = [(f"s{i}", (f"c{i % 5}",)) for i in range(6)]
    sealed = teng.seal_fanout(tt, b"q" * 100, targets)
    assert sealed == jeng.seal_fanout(jt, b"q" * 100, targets)
    kid = teng.keys.key_ids("t0", [("c1",)])[0]
    items = [(sealed["s1"], kid, kid), (sealed["s2"][:12], kid, kid)]
    assert teng.reseal_batch(tt, items, 1) == jeng.reseal_batch(jt, items, 1)
    assert teng.device_blocks == jeng.device_blocks == 0 and teng.host_blocks == jeng.host_blocks > 0
    for eng in (jeng, teng):
        eng.set_device_enabled(True)
    assert teng.seal_fanout(tt, b"r" * 48, targets) == jeng.seal_fanout(jt, b"r" * 48, targets)
    assert teng.device_blocks == jeng.device_blocks > 0
