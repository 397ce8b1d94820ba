"""Topic trie: subscriptions, shared subscriptions, inline subscriptions and
the wildcard match walk.

A copy of the subscription half of the JAX package's ``topics`` module
(behavioural parity with reference ``topics.go``). This host walk is the
bit-identical oracle and the fallback path for the device matcher in
``mqtt_tpu_torch.ops``. The corner cases that define "bit-identical":

- ``zen/#`` matches ``zen`` (spec 4.7.1.2), via the child-``#`` gather at the
  terminal level (topics.go:612-616).
- ``a/b`` must NOT match ``a/b/c`` (no prefix inheritance).
- ``$``-prefixed topics are not matched by TOP-LEVEL ``+``/``#`` filters
  [MQTT-4.7.1-1/2]; the check is on the subscription's original filter string
  (topics.go:637).
- Empty levels are real levels: ``/a/`` is ``["", "a", ""]``.
- ``#`` is gathered at every walk level; ``+`` forks the frontier.
- Shared subscriptions (``$SHARE/<group>/<filter>``) root their subtree at
  depth 2 (topics.go:407-411).

Quirk replicated on purpose (topics.go:615): in the terminal child-``#``
branch, the reference gathers the *parent* particle's inline subscriptions
again instead of the wild child's — so an inline subscription on ``a/#``
does not match topic ``a``.

Retained messages (``retain_message``/``messages``) come with the
retained-engine slice of the port.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from .packets import Subscription
from .utils import LockedMap

SHARE_PREFIX = "$SHARE"  # prefix indicating a shared-subscription filter
SYS_PREFIX = "$SYS"  # prefix indicating a system info topic

# Tenant namespaces: a tenant's keys carry one extra leading level
# ``NS_CHAR + tenant``. NS_CHAR is U+0000, which no client-supplied topic or
# filter may contain [MQTT-4.7.3-2], so a scoped key cannot be forged from
# the wire. The gather guards below keep GLOBAL top-level wildcards out of
# namespace subtrees the same way [MQTT-4.7.1-1/2] keeps them off
# ``$``-topics.
NS_CHAR = "\x00"


def _ns_local0(key: str) -> str:
    """First character of the tenant-local portion of a (possibly
    scoped) key — the character the [MQTT-4.7.1-1/2] ``$``-rules apply
    to inside a namespace."""
    if key[:1] != NS_CHAR:
        return key[:1]
    i = key.find("/")
    return key[i + 1 : i + 2] if i >= 0 else ""


@dataclass(frozen=True)
class Mutation:
    """One subscription mutation, delivered to trie observers (the delta
    overlay of ``mqtt_tpu_torch.ops.delta``)."""

    filter: str
    kind: str  # "sub" (client/shared subscription) or "inline"
    op: str  # "add" or "del"
    client: str = ""  # client id for kind="sub"; "" for inline
    subscription: Optional[object] = None  # the added Subscription / InlineSubscription
    identifier: int = 0  # inline subscription identifier (kind="inline")


def isolate_particle(filter: str, d: int) -> tuple[str, bool]:
    """Extract the topic level at depth ``d`` and whether more levels follow.
    Depths past the last level clamp to the last level (topics.go:679-698)."""
    parts = filter.split("/")
    if d >= len(parts):
        return parts[-1], False
    return parts[d], d < len(parts) - 1


def is_shared_filter(filter: str) -> bool:
    prefix, _ = isolate_particle(filter, 0)
    return prefix.upper() == SHARE_PREFIX


# -- subscription containers -----------------------------------------------


class Subscriptions(LockedMap[str, Subscription]):
    """A map of subscriptions keyed by client id (topics.go:249-301)."""

    __slots__ = ()


class SharedSubscriptions:
    """Shared subscriptions for one filter: group -> client id -> sub
    (topics.go:109-187)."""

    __slots__ = ("internal", "_lock")

    def __init__(self) -> None:
        self.internal: dict[str, dict[str, Subscription]] = {}
        self._lock = threading.Lock()

    def add(self, group: str, id_: str, val: Subscription) -> None:
        with self._lock:
            self.internal.setdefault(group, {})[id_] = val

    def delete(self, group: str, id_: str) -> None:
        with self._lock:
            subs = self.internal.get(group)
            if subs is None:
                return
            subs.pop(id_, None)
            if not subs:
                del self.internal[group]

    def get(self, group: str, id_: str) -> Optional[Subscription]:
        with self._lock:
            return self.internal.get(group, {}).get(id_)

    def get_all(self) -> dict[str, dict[str, Subscription]]:
        with self._lock:
            return {group: dict(subs) for group, subs in self.internal.items()}

    def __len__(self) -> int:
        with self._lock:
            return sum(len(subs) for subs in self.internal.values())


# Signature of an inline (in-process) subscription callback: receives the
# local client, the matched subscription, and the publish packet.
InlineSubFn = Callable[[object, Subscription, object], None]


@dataclass(slots=True)
class InlineSubscription(Subscription):
    """An in-process subscription: a Subscription plus a handler callback,
    keyed on the subscription identifier (topics.go:306-309)."""

    handler: InlineSubFn | None = None


class InlineSubscriptions(LockedMap[int, "InlineSubscription"]):
    """Inline subscriptions for one particle, keyed on identifier
    (topics.go:195-246)."""

    __slots__ = ()

    def add_inline(self, val: "InlineSubscription") -> None:
        self.add(val.identifier, val)


class Subscribers:
    """The result set of a subscriber scan (topics.go:312-347)."""

    __slots__ = ("shared", "subscriptions", "inline_subscriptions")

    def __init__(self) -> None:
        self.shared: dict[str, dict[str, Subscription]] = {}
        self.subscriptions: dict[str, Subscription] = {}
        self.inline_subscriptions: dict[int, InlineSubscription] = {}


# -- the trie --------------------------------------------------------------


class _Particle:
    """One trie node (reference 'particle', topics.go:748-769)."""

    __slots__ = (
        "key",
        "parent",
        "particles",
        "subscriptions",
        "shared",
        "inline_subscriptions",
    )

    def __init__(self, key: str, parent: "_Particle | None") -> None:
        self.key = key
        self.parent = parent
        self.particles: dict[str, _Particle] = {}
        self.subscriptions = Subscriptions()
        self.shared = SharedSubscriptions()
        self.inline_subscriptions = InlineSubscriptions()


class TopicsIndex:
    """A trie of topic filters with the subscriber scan (reference
    TopicsIndex, topics.go:350+)."""

    def __init__(self) -> None:
        self.root = _Particle("", None)
        self._lock = threading.RLock()
        # bumped on every subscription mutation; device indexes compare
        # against it to detect staleness
        self.version = 0
        # mutation observers: called with a Mutation under the trie lock,
        # after the version bump (the delta overlay must observe a mutation
        # atomically with the version bump)
        self._observers: list[Callable[[Mutation], None]] = []

    def add_observer(self, fn: Callable[[Mutation], None]) -> None:
        """Register a subscription-mutation observer (delta stream consumer)."""
        with self._lock:
            self._observers.append(fn)

    def remove_observer(self, fn: Callable[[Mutation], None]) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def _notify(self, mutation: Mutation) -> None:
        for fn in self._observers:
            fn(mutation)

    # -- mutation ----------------------------------------------------------

    def _subscribe_locked(self, client: str, subscription: Subscription) -> bool:
        self.version += 1
        prefix, _ = isolate_particle(subscription.filter, 0)
        if prefix.upper() == SHARE_PREFIX:
            group, _ = isolate_particle(subscription.filter, 1)
            n = self._set(subscription.filter, 2)
            existed = n.shared.get(group, client) is not None
            n.shared.add(group, client, subscription)
        else:
            n = self._set(subscription.filter, 0)
            existed = n.subscriptions.get(client) is not None
            n.subscriptions.add(client, subscription)
        self._notify(Mutation(subscription.filter, "sub", "add", client, subscription))
        return not existed

    def subscribe(self, client: str, subscription: Subscription) -> bool:
        """Add a subscription; returns True if it was new (topics.go:401-419).
        ``$SHARE/<group>/<filter>`` roots the subtree at depth 2."""
        with self._lock:
            return self._subscribe_locked(client, subscription)

    def subscribe_bulk(self, entries: list[tuple[str, Subscription]]) -> int:
        """Batched :meth:`subscribe` under one lock acquisition; returns how
        many were new. Per-entry semantics (version bump, observer call) are
        those of :meth:`subscribe`."""
        with self._lock:
            return sum(self._subscribe_locked(c, s) for c, s in entries)

    def unsubscribe(self, filter: str, client: str) -> bool:
        """Remove a client's subscription; returns True if it existed
        (topics.go:423-448)."""
        with self._lock:
            share_sub = is_shared_filter(filter)
            particle = self._seek(filter, 2 if share_sub else 0)
            if particle is None:
                return False
            self.version += 1
            if share_sub:
                group, _ = isolate_particle(filter, 1)
                particle.shared.delete(group, client)
            else:
                particle.subscriptions.delete(client)
            self._trim(particle)
            self._notify(Mutation(filter, "sub", "del", client))
            return True

    def inline_subscribe(self, subscription: InlineSubscription) -> bool:
        """Add an in-process subscription keyed on its identifier; returns
        True if new (topics.go:368-378)."""
        with self._lock:
            self.version += 1
            n = self._set(subscription.filter, 0)
            existed = n.inline_subscriptions.get(subscription.identifier) is not None
            n.inline_subscriptions.add_inline(subscription)
            self._notify(
                Mutation(
                    subscription.filter,
                    "inline",
                    "add",
                    subscription=subscription,
                    identifier=subscription.identifier,
                )
            )
            return not existed

    def inline_unsubscribe(self, id_: int, filter: str) -> bool:
        with self._lock:
            particle = self._seek(filter, 0)
            if particle is None:
                return False
            self.version += 1
            particle.inline_subscriptions.delete(id_)
            if len(particle.inline_subscriptions) == 0:
                self._trim(particle)
            self._notify(Mutation(filter, "inline", "del", identifier=id_))
            return True

    def _set(self, topic: str, d: int) -> _Particle:
        """Create (or find) the particle at a topic address (topics.go:479)."""
        parts = topic.split("/")
        n = self.root
        for key in parts[d:] if d < len(parts) else [parts[-1]]:
            p = n.particles.get(key)
            if p is None:
                p = _Particle(key, n)
                n.particles[key] = p
            n = p
        return n

    def _seek(self, filter: str, d: int) -> _Particle | None:
        parts = filter.split("/")
        n = self.root
        for key in parts[d:] if d < len(parts) else [parts[-1]]:
            n = n.particles.get(key)
            if n is None:
                return None
        return n

    def _trim(self, n: _Particle) -> None:
        """Prune empty particles up the parent chain (topics.go:516-522)."""
        while (
            n.parent is not None
            and len(n.particles) + len(n.subscriptions) + len(n.shared) + len(n.inline_subscriptions) == 0
        ):
            key = n.key
            n = n.parent
            n.particles.pop(key, None)

    # -- scans -------------------------------------------------------------

    def subscribers(self, topic: str) -> Subscribers:
        """All clients subscribed to filters matching ``topic`` — the hot
        walk the device matcher accelerates (topics.go:583-628). Iterative
        frontier walk (explicit stack) so deep topics cannot overflow the
        interpreter's recursion limit."""
        subs = Subscribers()
        if len(topic) == 0:
            return subs
        parts = topic.split("/")
        last = len(parts) - 1
        stack: list[tuple[_Particle, int]] = [(self.root, 0)]
        while stack:
            n, d = stack.pop()
            key = parts[d] if d < len(parts) else parts[-1]
            has_next = d < last
            for part_key in (key, "+"):
                particle = n.particles.get(part_key)
                if particle is not None:  # [MQTT-3.3.2-3]
                    if has_next:
                        stack.append((particle, d + 1))
                    else:
                        self._gather_subscriptions(topic, particle, subs)
                        self._gather_shared(topic, particle, subs)
                        self._gather_inline(topic, particle, subs)
                        wild = particle.particles.get("#")
                        if wild is not None and part_key != "+":
                            # filter/# matches filter itself, per spec 4.7.1.2
                            self._gather_subscriptions(topic, wild, subs)
                            self._gather_shared(topic, wild, subs)
                            # reference quirk (topics.go:615): gathers the
                            # parent particle's inline subs, not the wild
                            # child's
                            self._gather_inline(topic, particle, subs)
            particle = n.particles.get("#")
            if particle is not None:
                self._gather_subscriptions(topic, particle, subs)
                self._gather_shared(topic, particle, subs)
                self._gather_inline(topic, particle, subs)
        return subs

    @staticmethod
    def _ns_excluded(topic: str, filter: str) -> bool:
        """The namespace gather guards: a GLOBAL top-level-wildcard filter
        never reaches into a tenant namespace, and inside a namespace the
        [MQTT-4.7.1-1/2] ``$``-rule applies to the tenant-LOCAL first
        level."""
        if topic[:1] != NS_CHAR or not filter:
            return False
        if filter[0] in "+#":
            return True  # global wildcard vs scoped topic
        return _ns_local0(topic) == "$" and _ns_local0(filter) in "+#"

    def _gather_subscriptions(self, topic: str, particle: _Particle, subs: Subscribers) -> None:
        """Merge a particle's subscriptions into the result set, excluding
        top-level-wildcard filters for $-topics [MQTT-4.7.1-1/2]
        (topics.go:631-648)."""
        for client, sub in particle.subscriptions.get_all().items():
            if sub.filter and topic[0] == "$" and sub.filter[0] in "+#":
                continue
            if self._ns_excluded(topic, sub.filter):
                continue
            cls = subs.subscriptions.get(client, sub)
            subs.subscriptions[client] = cls.merge(sub)

    def _gather_shared(self, topic: str, particle: _Particle, subs: Subscribers) -> None:
        for shares in particle.shared.get_all().values():
            for client, sub in shares.items():
                if topic[:1] == NS_CHAR:
                    # the namespace guard applies to the INNER filter
                    # (publishes match the inner topic space)
                    parts = sub.filter.split("/", 2)
                    inner = parts[2] if len(parts) > 2 else ""
                    if self._ns_excluded(topic, inner):
                        continue
                subs.shared.setdefault(sub.filter, {})[client] = sub

    def _gather_inline(self, topic: str, particle: _Particle, subs: Subscribers) -> None:
        if topic[:1] == NS_CHAR:
            for iid, isub in particle.inline_subscriptions.get_all().items():
                if not self._ns_excluded(topic, isub.filter):
                    subs.inline_subscriptions[iid] = isub
            return
        subs.inline_subscriptions.update(particle.inline_subscriptions.get_all())
