"""The JAX package's ``tests/test_native.py`` run over the port through
``tests/torch_mirror.py``: the same bodies, parameters and assertions,
every ``mqtt_tpu`` import answered by ``mqtt_tpu_torch`` on the CPU."""

from tests import torch_mirror

# cases left out, each with its class and reason (tests/torch_mirror.py)
EXCLUDED: dict = {
    "TestVarint": (
        "(d) holds the C varint codec against _varint_encode_py/_varint_decode_py, the JAX package's "
        "Python codec; the port has no Python scanners by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_golden_catalogue_stream": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_partial_tail": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_reserved_type_scans_as_frame": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_malformed_header_flags": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_malformed_second_packet": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_max_packet_size": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_max_frames": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_incomplete_varint": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_empty_buffer": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
    "TestFrameScan::test_dup_without_qos_rejected": (
        "(d) _both() holds frame_scan against _frame_scan_py, the JAX package's Python scanner; the port "
        "has none by design (ROADMAP, Departures)"
    ),
}

torch_mirror.export(torch_mirror.mirror("tests.test_native"), globals(), "MNative", exclude=EXCLUDED)
