"""The subscription record the trie stores and the matcher returns.

A copy of ``Subscription`` from the JAX package's packet codec, cut to the
fields and methods the subscription trie and the match result need. The
wire codec (CONNECT/PUBLISH/SUBSCRIBE encoding) comes with the broker
slice of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


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

    def merge(self, n: "Subscription") -> "Subscription":
        """Fold ``n`` into this subscription: max QoS [MQTT-3.3.4-2], union of
        identifiers, sticky NoLocal [MQTT-3.8.3-3] (packets.go:254-274).

        Mirrors the reference's value-receiver semantics: the receiver is not
        mutated, but an existing identifiers map is shared and extended."""
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
