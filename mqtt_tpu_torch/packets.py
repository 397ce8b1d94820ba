"""The records the trie stores: subscriptions and retained packets.

Copies of ``Subscription``, ``FixedHeader``, ``Packet`` and ``PacketStore``
from the JAX package's packet codec, cut to the fields and methods the
subscription trie, the match result, the predicate engine, the retained
half of the trie, the retained-match engine and the re-key re-seal read
and write. The wire codec (CONNECT/PUBLISH/SUBSCRIBE encoding) comes with
the broker slice of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .utils.locked import LockedMap

# the packet type id of PUBLISH (bits 7-4 of the header byte, MQTT §2.1.2)
PUBLISH = 3


@dataclass(slots=True)
class Subscription:
    """A client's subscription to a topic filter (packets.go:172-182)."""

    filter: str = ""
    share_name: list[str] = field(default_factory=list)
    identifier: int = 0
    identifiers: dict[str, int] | None = None
    retain_handling: int = 0
    qos: int = 0
    retain_as_published: bool = False
    no_local: bool = False
    # True when this subscription forms part of a retained-publish response.
    fwd_retained_flag: bool = False
    # MQTT+ payload predicates (``mqtt_tpu_torch.predicates``): the suffix
    # texts (e.g. "$GT{temp:25.0}") split off the filter at SUBSCRIBE time.
    # () = unpredicated: every payload is delivered.
    predicates: tuple = ()

    def merge(self, n: "Subscription") -> "Subscription":
        """Fold ``n`` into this subscription: max QoS [MQTT-3.3.4-2], union of
        identifiers, sticky NoLocal [MQTT-3.8.3-3] (packets.go:254-274).

        Mirrors the reference's value-receiver semantics: the receiver is not
        mutated, but an existing identifiers map is shared and extended.

        Predicates merge with OR semantics: a client matched through an
        unpredicated filter must receive every payload, so either side
        being () clears the merge; otherwise the union is kept and delivery
        needs any one predicate to pass."""
        s = Subscription(
            filter=self.filter,
            share_name=self.share_name,
            identifier=self.identifier,
            identifiers=self.identifiers,
            retain_handling=self.retain_handling,
            qos=self.qos,
            retain_as_published=self.retain_as_published,
            no_local=self.no_local,
            fwd_retained_flag=self.fwd_retained_flag,
            predicates=(
                ()
                if not self.predicates or not n.predicates
                else self.predicates
                if n.predicates == self.predicates
                else tuple(dict.fromkeys(self.predicates + n.predicates))
            ),
        )
        if s.identifiers is None:
            s.identifiers = {s.filter: s.identifier}
        if n.identifier > 0:
            s.identifiers[n.filter] = n.identifier
        if n.qos > s.qos:
            s.qos = n.qos
        if n.no_local:
            s.no_local = True
        return s

    def self_merged_copy(self) -> "Subscription":
        """``merge(self, self)``'s value without the second argument: a
        fresh instance (subclass-preserving) whose identifiers map is
        materialized ({filter: identifier}) or shared-and-extended when
        identifier > 0 — the per-client first-sighting copy the result
        gather makes (reference gatherSubscriptions, topics.go:631-649)."""
        s = dataclasses.replace(self)
        if s.identifiers is None:
            s.identifiers = {s.filter: s.identifier}
        elif s.identifier > 0:
            s.identifiers[s.filter] = s.identifier
        return s


@dataclass
class FixedHeader:
    """The first byte's packed fields that the retained store reads
    (fixedheader.go:12-20)."""

    type: int = 0
    qos: int = 0
    retain: bool = False


@dataclass
class Packet:
    """A PUBLISH as the retained store keeps it: the fields a retained
    message carries between its PUBLISH and its delivery (packets.go:123-141)."""

    payload: bytes = b""
    topic_name: str = ""
    origin: str = ""  # client id of the issuing client (internal)
    fixed_header: FixedHeader = field(default_factory=FixedHeader)
    created: int = 0  # unix ts when the packet was created/received
    expiry: int = 0  # unix ts when the packet expires and should be deleted

    def copy(self, allow_transfer: bool) -> "Packet":
        """A copy with its own payload bytes (packets.go:185-250). The
        packet id and properties that ``allow_transfer`` moves are not
        part of this cut, so the flag changes nothing here."""
        del allow_transfer
        return Packet(
            payload=bytes(self.payload),
            topic_name=self.topic_name,
            origin=self.origin,
            fixed_header=FixedHeader(
                type=self.fixed_header.type,
                qos=self.fixed_header.qos,
                retain=self.fixed_header.retain,
            ),
            created=self.created,
            expiry=self.expiry,
        )


class PacketStore(LockedMap[str, Packet]):
    """Topic-keyed packet map: the retained-message store
    (packets.go:66-117)."""

    __slots__ = ("name",)

    def __init__(self, name: str = "") -> None:
        # a named store registers its lock with the lock plane
        super().__init__(name or None)
        self.name = name
