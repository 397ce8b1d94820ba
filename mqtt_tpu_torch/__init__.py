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

The broker itself is ``server.Server``: CONNECT, dispatch, the QoS flows,
retained, wills, $SYS, expiry and the restart from a storage hook, over
the listeners (``listeners``: TCP, unix socket, a pre-bound socket, the
mock), with the auth and storage hooks (``hooks.auth``,
``hooks.storage``). With ``Options(device_matcher=True)`` its publishes
are matched by the chain above on the card, with the predicate and
re-encryption legs and the retained engine at their call sites. Beneath
it lies the wire and session layer: the MQTT codec (``packets``), the
frame scanners (``native.frame_scan``), ``Inflight``, ``Hooks`` (with the
``on_select_subscribers`` seam) and ``Client``/``Clients``; a matched
publish's ``$SHARE`` groups select one member each
(``Subscribers.select_shared``) before delivery.

The device plane carries the JAX package's instruments: ``telemetry``
(the metrics registry), ``utils.locked`` (named instrumented locks, the
lock plane and its order witness), ``ops.devicestats`` (the first-launch
ledger, per-card memory gauges) and ``tracing`` (the device pipeline
profiler the matchers and the stage stamp).

The broker scales out as the JAX package's does: ``shards`` serves
connections on several event-loop threads (``Options.loop_shards``), and
``cluster`` joins worker processes (``python -m mqtt_tpu_torch serve
--workers N``) into a forwarding mesh, all-pairs or a spanning tree
(``mesh_topology``).

Entry points run on ``"cuda"`` unless given ``device="cpu"``, which runs
the plain PyTorch version of every kernel.
"""

__version__ = "0.1.0"

from .clients import Client, Clients, Will
from .hooks import Hook, Hooks
from .inflight import Inflight
from .native import NativeError
from .ops import DeltaMatcher, KernelError, MatcherStats, RetainedMatchEngine, TorchMatcher, subscribers_equal
from .packets import PUBLISH, FixedHeader, Packet, PacketStore, Subscription
from .predicates import PredicateEngine, PublishFeatures
from .overload import OverloadConfig, OverloadGovernor
from .server import (
    Capabilities,
    Compatibilities,
    InlineClientNotEnabledError,
    ListenerIDExistsError,
    Options,
    Server,
)
from .staging import MatchStage
from .tenancy import KeyRegistry, RecryptEngine, RecryptJob, Tenant, TenantPlane
from .system import Info
from .topics import (
    SHARE_PREFIX,
    SYS_PREFIX,
    InlineSubscription,
    Subscribers,
    TopicAliases,
    TopicsIndex,
    is_shared_filter,
    is_valid_filter,
)
from .utils import freeze_index, tune_for_throughput

__all__ = [
    "Capabilities",
    "Client",
    "Clients",
    "Compatibilities",
    "DeltaMatcher",
    "FixedHeader",
    "Hook",
    "Hooks",
    "Inflight",
    "Info",
    "InlineClientNotEnabledError",
    "InlineSubscription",
    "KernelError",
    "KeyRegistry",
    "ListenerIDExistsError",
    "MatchStage",
    "MatcherStats",
    "NativeError",
    "Options",
    "OverloadConfig",
    "OverloadGovernor",
    "PUBLISH",
    "Packet",
    "PacketStore",
    "PredicateEngine",
    "PublishFeatures",
    "RecryptEngine",
    "RecryptJob",
    "RetainedMatchEngine",
    "SHARE_PREFIX",
    "SYS_PREFIX",
    "Server",
    "Subscribers",
    "Subscription",
    "Tenant",
    "TenantPlane",
    "TopicAliases",
    "TopicsIndex",
    "TorchMatcher",
    "Will",
    "freeze_index",
    "is_shared_filter",
    "is_valid_filter",
    "subscribers_equal",
    "tune_for_throughput",
]
