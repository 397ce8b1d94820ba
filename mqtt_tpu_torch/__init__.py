"""mqtt_tpu_torch: the MQTT broker's publish path on PyTorch and CUDA.

The port of the ``mqtt_tpu`` device plane to an NVIDIA Hopper card. It
runs the PUBLISH fan-out match — every topic against every wildcard
subscription, with subscriber sets bit-identical to the host trie walk —
through the same chain as the JAX package: ``MatchStage`` →
``DeltaMatcher`` → ``TorchMatcher`` → the flat-hash kernels, written by
hand in CUDA C++ (``csrc/flat_match.cu``). On the same staged batch it
evaluates MQTT+ payload predicates (``PredicateEngine``,
``csrc/predicates.cu``) and decrypts tenant publishes
(``RecryptEngine``, ``csrc/recrypt.cu``), and the fan-out applies both.
A wildcard SUBSCRIBE finds its retained messages through
``RetainedMatchEngine`` (the matcher's probe kernel run over the retained
topic names), and a tenant's key rotation re-seals its retained payloads
in one keystream launch (``RecryptEngine.reseal_batch``; tenants resolve
through ``TenantPlane``).
``parallel`` shards the subscriptions over a mesh of device positions
(``DeltaMatcher(mesh=parallel.make_mesh(...))``, ``csrc/sharded.cu``).
It imports ``torch`` and numpy and keeps its own copies of the host code
it needs, its C tokenizer and C result materializer among them
(``native``, built with the host compiler at first use): a match returns
lazy ``SubscribersView`` results by default, which read like
``Subscribers``.

The device plane carries the JAX package's instruments: ``telemetry``
(the metrics registry), ``utils.locked`` (named instrumented locks, the
lock plane and its order witness), ``ops.devicestats`` (the first-launch
ledger, per-card memory gauges) and ``tracing`` (the device pipeline
profiler the matchers and the stage stamp).

Entry points run on ``"cuda"`` unless given ``device="cpu"``, which runs
the plain PyTorch version of every kernel.
"""

from .native import NativeError
from .ops import DeltaMatcher, KernelError, MatcherStats, RetainedMatchEngine, TorchMatcher, subscribers_equal
from .packets import PUBLISH, FixedHeader, Packet, PacketStore, Subscription
from .predicates import PredicateEngine, PublishFeatures
from .staging import MatchStage
from .tenancy import KeyRegistry, RecryptEngine, RecryptJob, Tenant, TenantPlane
from .topics import SHARE_PREFIX, InlineSubscription, Subscribers, TopicsIndex
from .utils import freeze_index, tune_for_throughput

__all__ = [
    "DeltaMatcher",
    "FixedHeader",
    "InlineSubscription",
    "KernelError",
    "KeyRegistry",
    "MatchStage",
    "MatcherStats",
    "NativeError",
    "PUBLISH",
    "Packet",
    "PacketStore",
    "PredicateEngine",
    "PublishFeatures",
    "RecryptEngine",
    "RecryptJob",
    "RetainedMatchEngine",
    "SHARE_PREFIX",
    "Subscribers",
    "Subscription",
    "Tenant",
    "TenantPlane",
    "TopicsIndex",
    "TorchMatcher",
    "freeze_index",
    "subscribers_equal",
    "tune_for_throughput",
]
