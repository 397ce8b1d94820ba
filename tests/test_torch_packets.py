"""The port's MQTT codec (``mqtt_tpu_torch.packets``) against the JAX
package's, on the golden catalogue.

Every case of ``tests/tpackets.py``'s ``CASES`` goes through both codecs:
the decoded fields must be equal, the encoded bytes identical, and each
error the same ``Code`` (byte and reason). The catalogue holds the JAX
package's records; ``to_port`` rebuilds each as the port's by class name.
All comparisons are exact.
"""

import copy
import dataclasses
import random

import pytest
from tests.tpackets import CASES

from mqtt_tpu import packets as jp
from mqtt_tpu.packets import codec as jcodec
from mqtt_tpu.packets import codes as jcodes
from mqtt_tpu_torch import packets as tp
from mqtt_tpu_torch.packets import codec as tcodec
from mqtt_tpu_torch.packets import codes as tcodes


def to_port(obj):
    """A JAX-package record rebuilt as the port's class of the same name,
    field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(tp, type(obj).__name__)
        fields = dataclasses.fields(obj)
        out = cls(**{f.name: to_port(getattr(obj, f.name)) for f in fields if f.init})
        for f in fields:
            if not f.init:
                setattr(out, f.name, to_port(getattr(obj, f.name)))
        return out
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def canon(obj):
    """A package-free form of a record: class name and fields, recursively."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, tuple((f.name, canon(getattr(obj, f.name))) for f in dataclasses.fields(obj)))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(canon(x) for x in obj))
    if isinstance(obj, dict):
        return ("dict", tuple((k, canon(v)) for k, v in obj.items()))
    return obj


def outcome(fn):
    """``("ok", canon(value))`` or ``("code", byte, reason)`` of a codec call."""
    try:
        return ("ok", canon(fn()))
    except (jcodes.Code, tcodes.Code) as e:
        return ("code", e.code, e.reason)


def validate(pkts, pk, case):
    t = pk.fixed_header.type
    if t == pkts.PUBLISH:
        return pk.publish_validate(case.validate_arg)
    if t == pkts.SUBSCRIBE:
        return pk.subscribe_validate()
    if t == pkts.UNSUBSCRIBE:
        return pk.unsubscribe_validate()
    if t == pkts.AUTH:
        return pk.auth_validate()
    return pk.connect_validate()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.desc)
def test_golden_case_through_both_codecs(case):
    if case.raw and case.group in ("", "decode", "validate"):
        want = outcome(lambda: jp.decode_packet(case.raw, case.version))
        got = outcome(lambda: tp.decode_packet(case.raw, case.version))
        assert got == want
    if case.packet is not None and case.group in ("", "encode"):
        want = jp.encode_packet(copy.deepcopy(case.packet))
        got = tp.encode_packet(to_port(case.packet))
        assert got == want == case.raw
    if case.validate_err is not None:
        if case.raw:
            jpk, tpk = jp.decode_packet(case.raw, case.version), tp.decode_packet(case.raw, case.version)
        else:
            jpk, tpk = copy.deepcopy(case.packet), to_port(case.packet)
        want, got = validate(jp, jpk, case), validate(tp, tpk, case)
        assert (got.code, got.reason) == (want.code, want.reason) == (case.validate_err.code, case.validate_err.reason)


@pytest.mark.parametrize("case", [c for c in CASES if c.group == "" and c.packet is not None], ids=lambda c: c.desc)
def test_round_trip_and_copy_equal_the_jax_package(case):
    """encode(decode(bytes)) is the bytes in both packages, and a packet's
    ``copy`` (with and without transfer) keeps the same fields."""
    tpk = tp.decode_packet(case.raw, case.version)
    assert tp.encode_packet(tpk) == case.raw
    jpk = jp.decode_packet(case.raw, case.version)
    for transfer in (False, True):
        assert canon(tpk.copy(transfer)) == canon(jpk.copy(transfer))


def test_reason_code_tables_are_the_jax_package_tables():
    names = sorted(n for n in dir(jcodes) if isinstance(getattr(jcodes, n), jcodes.Code))
    assert names == sorted(n for n in dir(tcodes) if isinstance(getattr(tcodes, n), tcodes.Code))
    for n in names:
        j, t = getattr(jcodes, n), getattr(tcodes, n)
        assert (t.code, t.reason) == (j.code, j.reason), n
    assert {(k.code, k.reason): (v.code, v.reason) for k, v in tcodes.V5_CODES_TO_V3.items()} == \
        {(k.code, k.reason): (v.code, v.reason) for k, v in jcodes.V5_CODES_TO_V3.items()}
    assert sorted(tp.DECODERS) == sorted(jp.DECODERS) and sorted(tp.ENCODERS) == sorted(jp.ENCODERS)
    assert tp.PACKET_NAMES == jp.PACKET_NAMES


def test_primitive_codec_equals_the_jax_package_on_seeded_inputs():
    rng = random.Random(13)
    for _ in range(2000):
        n = rng.choice([0, 1, 127, 128, 16383, 16384, 2097151, 2097152, 268435455, rng.randrange(1 << 28)])
        jb, tb = bytearray(), bytearray()
        jcodec.encode_length(jb, n)
        tcodec.encode_length(tb, n)
        assert tb == jb
        assert tcodec.decode_length(bytes(tb), 0) == jcodec.decode_length(bytes(jb), 0)
        raw = bytes(rng.randrange(256) for _ in range(rng.randrange(6)))
        assert outcome(lambda: tcodec.decode_length(raw, 0)) == outcome(lambda: jcodec.decode_length(raw, 0))
        assert tcodec.valid_utf8(raw) == jcodec.valid_utf8(raw)
        assert outcome(lambda: tcodec.decode_string(raw, 0)) == outcome(lambda: jcodec.decode_string(raw, 0))


def test_hostile_bytes_decode_to_the_same_code():
    """Seeded mutations of the catalogue's well-formed packets: every
    outcome (fields or error code) is the JAX package's."""
    rng = random.Random(7)
    good = [c for c in CASES if c.group == "" and c.raw]
    for _ in range(1500):
        case = rng.choice(good)
        raw = bytearray(case.raw)
        for _ in range(rng.randrange(1, 4)):
            raw[rng.randrange(len(raw))] = rng.randrange(256)
        if rng.random() < 0.3:
            del raw[rng.randrange(len(raw)) :]
        raw = bytes(raw)
        want = outcome(lambda: jp.decode_packet(raw, case.version))
        assert outcome(lambda: tp.decode_packet(raw, case.version)) == want, raw.hex()
