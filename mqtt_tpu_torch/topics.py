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

Also here: the tenant-namespace helpers (``ns_*``) and the MQTT+
predicate-suffix split (``split_predicate_suffix``) that the predicate
and tenancy planes use.

The retained half: ``retain_message``/``retain_bulk`` keep one packet
per topic in ``retained`` and mark its node (``retain_path``), and
``messages`` walks a filter over the marked nodes. The walk hides
``$SYS`` from top-level wildcards (at the tenant-local top level inside a
namespace), never takes a global wildcard into a namespace, and under
``#`` collects only strictly deeper topics. ``_trim`` keeps a node that
holds a retained message. The retained walk is the oracle of
``ops/retained.RetainedMatchEngine``.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from .packets import Packet, PacketStore, Subscription
from .utils import LockedMap
from .utils.locked import InstrumentedLock

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


def shared_inner(filter: str) -> str:
    """The inner filter of a ``$SHARE/<group>/<filter>`` subscription
    ("" when it has none): the topic space its publishes match."""
    parts = filter.split("/", 2)
    return parts[2] if len(parts) > 2 else ""


def ns_guard_class(filter: str) -> int:
    """Which topics the namespace guard keeps ``filter`` from (for a
    shared subscription, pass its inner filter): 0 none; 1 every scoped
    topic (a GLOBAL ``+``/``#`` first level); 2 scoped topics whose
    tenant-local first level starts with ``$`` (a scoped filter with a
    local ``+``/``#`` first level)."""
    if not filter:
        return 0
    if filter[0] in "+#":
        return 1
    return 2 if _ns_local0(filter) in "+#" else 0


def ns_guard_mode(topic: str) -> int:
    """The highest guard class ``topic`` excludes: 0 outside every
    namespace, 2 for a scoped topic whose tenant-local first level starts
    with ``$``, else 1. ``TopicsIndex._ns_excluded(topic, f)`` is
    ``0 < ns_guard_class(f) <= ns_guard_mode(topic)``."""
    if topic[:1] != NS_CHAR:
        return 0
    return 2 if _ns_local0(topic) == "$" else 1


def ns_scope_topic(tenant: str, topic: str) -> str:
    """Prefix a tenant-local topic NAME into its namespace."""
    return NS_CHAR + tenant + "/" + topic


def ns_scope_filter(tenant: str, filter: str) -> str:
    """Prefix a tenant-local FILTER into its namespace. A shared
    subscription scopes its inner filter: ``$SHARE/g/f`` ->
    ``$SHARE/g/<ns>/f`` (the trie roots shared subtrees at depth 2)."""
    if is_shared_filter(filter):
        parts = filter.split("/", 2)
        inner = parts[2] if len(parts) > 2 else ""
        return f"{parts[0]}/{parts[1]}/{NS_CHAR}{tenant}/{inner}"
    return NS_CHAR + tenant + "/" + filter


def ns_tenant(key: str) -> str:
    """The tenant a scoped key belongs to ("" for global keys)."""
    if key[:1] != NS_CHAR:
        return ""
    i = key.find("/")
    return key[1:i] if i > 0 else key[1:]


def ns_local(key: str) -> str:
    """Strip the namespace level off a scoped key (identity for global
    keys): the tenant-local topic or filter the client sees."""
    if key[:1] != NS_CHAR:
        return key
    i = key.find("/")
    return key[i + 1 :] if i >= 0 else ""


# -- MQTT+ predicate suffixes (mqtt_tpu_torch.predicates) ------------------
#
# An MQTT+ subscription rides a standard SUBSCRIBE filter with a payload
# predicate appended: ``sensors/+/temp$GT{25.0}``. The trie only ever sees
# the BASE filter: the suffix is split off at SUBSCRIBE time.

#: ops that compare a numeric payload feature against a threshold
PREDICATE_NUMERIC_OPS = ("GT", "GTE", "LT", "LTE", "EQ", "NE")
#: ops that aggregate a numeric payload feature over a message window
PREDICATE_AGG_OPS = ("MEAN", "MAX", "MIN")
#: every simple predicate op (compounds AND/OR are parsed separately)
PREDICATE_OPS = PREDICATE_NUMERIC_OPS + ("CONTAINS", "EQS") + PREDICATE_AGG_OPS
#: compound ops combining SIMPLE predicates: ``$AND{$GT{t:20}$LT{t:30}}``
PREDICATE_COMPOUND_OPS = ("AND", "OR")

_PREDICATE_RE = re.compile(
    r"^(?P<base>.*?)\$(?P<op>" + "|".join(PREDICATE_OPS) + r")\{(?P<arg>[^{}]*)\}$",
    re.DOTALL,
)
# one SIMPLE predicate token anchored at the string start: the unit the
# compound-argument scanner consumes
_PREDICATE_TOKEN_RE = re.compile(
    r"^\$(?P<op>" + "|".join(PREDICATE_OPS) + r")\{(?P<arg>[^{}]*)\}",
    re.DOTALL,
)
_COMPOUND_RE = re.compile(r"^(?P<base>.*?)\$(?P<op>AND|OR)\{(?P<arg>.*)\}$", re.DOTALL)


def _predicate_arg_ok(op: str, arg: str) -> bool:
    """Validate a predicate argument for ``op``. An invalid argument means
    the token is NOT a predicate: the filter stays literal."""
    if op == "CONTAINS":
        return len(arg) > 0
    if op == "EQS":
        _field, sep, _literal = arg.partition(":")
        return bool(sep)
    _field, _, num = arg.rpartition(":")
    if op in PREDICATE_AGG_OPS:
        try:
            return int(num) >= 1
        except ValueError:
            return False
    try:
        value = float(num)
    except ValueError:
        return False
    return value == value  # an explicit nan threshold is no predicate


def split_predicate_tokens(arg: str) -> tuple:
    """Scan a compound argument into its simple ``$OP{...}`` member
    tokens; () unless it is a well-formed run of >= 2 valid simple,
    non-aggregation predicates."""
    tokens = []
    rest = arg
    while rest:
        m = _PREDICATE_TOKEN_RE.match(rest)
        if m is None or not _predicate_arg_ok(m.group("op"), m.group("arg")):
            return ()
        if m.group("op") in PREDICATE_AGG_OPS:
            return ()  # a window has no boolean verdict to combine
        tokens.append(m.group(0))
        rest = rest[len(m.group(0)) :]
    return tuple(tokens) if len(tokens) >= 2 else ()


def split_predicate_suffix(filter: str) -> tuple[str, str]:
    """Split a trailing MQTT+ predicate off a subscription filter:
    ``(base_filter, suffix)``, with suffix "" when the filter carries no
    well-formed predicate (it stays a literal filter). A bare predicate
    means every topic: the base widens to ``#``. Compounds match first:
    their argument holds nested braces, which the simple grammar
    excludes."""
    m = _COMPOUND_RE.match(filter)
    if m is not None and split_predicate_tokens(m.group("arg")):
        base = m.group("base") or "#"
        return base, filter[len(m.group("base")) :]
    m = _PREDICATE_RE.match(filter)
    if m is None or not _predicate_arg_ok(m.group("op"), m.group("arg")):
        return filter, ""
    base = m.group("base") or "#"
    return base, filter[len(m.group("base")) :]


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
        "retain_path",
    )

    def __init__(self, key: str, parent: "_Particle | None") -> None:
        self.key = key
        self.parent = parent
        self.particles: dict[str, _Particle] = {}
        self.subscriptions = Subscriptions()
        self.shared = SharedSubscriptions()
        self.inline_subscriptions = InlineSubscriptions()
        self.retain_path = ""  # the topic of the retained message held here


class TopicsIndex:
    """A trie of topic filters with the subscriber scan (reference
    TopicsIndex, topics.go:350+)."""

    def __init__(self, lock_name: str = "topics_trie") -> None:
        self.retained = PacketStore(name="retained")
        self.root = _Particle("", None)
        # the lock plane's instrumented re-entrant lock (utils/locked):
        # every host walk, subscribe/unsubscribe and retained-store
        # mutation serializes here, measured under ``lock_name``
        self._lock = InstrumentedLock(lock_name, rlock=True)
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

    def retain_message(self, pk: Packet) -> int:
        """Store or clear the retained message for a topic. Returns 1 when a
        message was retained, -1 when an existing one was cleared, 0 for a
        clear with nothing to clear (topics.go:453-476)."""
        with self._lock:
            n = self._set(pk.topic_name, 0)
            if pk.payload:
                n.retain_path = pk.topic_name
                self.retained.add(pk.topic_name, pk)
                return 1
            out = 0
            pke = self.retained.get(pk.topic_name)
            if pke is not None and pke.payload and pke.fixed_header.retain:
                out = -1
            n.retain_path = ""
            self.retained.delete(pk.topic_name)  # [MQTT-3.3.1-6] [MQTT-3.3.1-7]
            self._trim(n)
            return out

    def retain_bulk(self, packets: list[Packet]) -> int:
        """:meth:`retain_message` over a batch under one lock acquisition
        (restart restore). Returns how many were retained; clears are
        applied but not summed."""
        retained = 0
        with self._lock:
            for pk in packets:
                n = self._set(pk.topic_name, 0)
                if pk.payload:
                    n.retain_path = pk.topic_name
                    self.retained.add(pk.topic_name, pk)
                    retained += 1
                else:
                    n.retain_path = ""
                    self.retained.delete(pk.topic_name)
                    self._trim(n)
        return retained

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
        """Prune empty particles up the parent chain, stopping at one that
        holds a retained message (topics.go:516-522)."""
        while (
            n.parent is not None
            and n.retain_path == ""
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
        return 0 < ns_guard_class(filter) <= ns_guard_mode(topic)

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
                    if self._ns_excluded(topic, shared_inner(sub.filter)):
                        continue
                subs.shared.setdefault(sub.filter, {})[client] = sub

    def _gather_inline(self, topic: str, particle: _Particle, subs: Subscribers) -> None:
        if topic[:1] == NS_CHAR:
            for iid, isub in particle.inline_subscriptions.get_all().items():
                if not self._ns_excluded(topic, isub.filter):
                    subs.inline_subscriptions[iid] = isub
            return
        subs.inline_subscriptions.update(particle.inline_subscriptions.get_all())

    def messages(self, filter: str) -> list[Packet]:
        """All retained messages matching ``filter`` (topics.go:525-579).
        Iterative walk, as :meth:`subscribers`."""
        pks: list[Packet] = []
        if len(filter) == 0 or len(self.retained) == 0:
            return pks
        if "#" not in filter and "+" not in filter:
            pk = self.retained.get(filter)
            if pk is not None:
                pks.append(pk)
            return pks
        parts = filter.split("/")
        last = len(parts) - 1
        # a scoped filter's tenant-local top level sits at depth 1; the
        # $SYS wildcard exclusion applies there
        sys_d = 1 if parts[0][:1] == NS_CHAR else 0
        stack: list[tuple[_Particle, int]] = [(self.root, 0)]
        while stack:
            n, d = stack.pop()
            key = parts[d] if d < len(parts) else parts[-1]
            has_next = d < last
            if key in ("+", "#"):
                for adjacent in list(n.particles.values()):
                    if d == sys_d and adjacent.key == SYS_PREFIX:
                        continue
                    if d == 0 and adjacent.key[:1] == NS_CHAR:
                        # a global wildcard never descends into a tenant
                        # namespace (scoped filters name its level)
                        continue
                    if not has_next and adjacent.retain_path:
                        pk = self.retained.get(adjacent.retain_path)
                        if pk is not None:
                            pks.append(pk)
                    if has_next or key == "#":
                        stack.append((adjacent, d + 1))
            else:
                particle = n.particles.get(key)
                if particle is not None:
                    if has_next:
                        stack.append((particle, d + 1))
                    elif particle.retain_path:
                        pk = self.retained.get(particle.retain_path)
                        if pk is not None:
                            pks.append(pk)
        return pks
