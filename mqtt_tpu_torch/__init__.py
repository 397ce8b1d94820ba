"""mqtt_tpu_torch: the MQTT broker's publish matcher on PyTorch and CUDA.

The port of the ``mqtt_tpu`` device plane to an NVIDIA Hopper card. It
runs the PUBLISH fan-out match — every topic against every wildcard
subscription, with subscriber sets bit-identical to the host trie walk —
through the same chain as the JAX package: ``MatchStage`` →
``DeltaMatcher`` → ``TorchMatcher`` → the flat-hash kernels, written by
hand in CUDA C++ (``csrc/flat_match.cu``). It imports ``torch`` and numpy
and keeps its own copies of the host code it needs.

Entry points run on ``"cuda"`` unless given ``device="cpu"``, which runs
the plain PyTorch version of every kernel.
"""

from .ops import DeltaMatcher, KernelError, MatcherStats, TorchMatcher, subscribers_equal
from .packets import Subscription
from .staging import MatchStage
from .topics import SHARE_PREFIX, InlineSubscription, Subscribers, TopicsIndex

__all__ = [
    "DeltaMatcher",
    "InlineSubscription",
    "KernelError",
    "MatchStage",
    "MatcherStats",
    "SHARE_PREFIX",
    "Subscribers",
    "Subscription",
    "TopicsIndex",
    "TorchMatcher",
    "subscribers_equal",
]
