"""Hook (plugin) system: the event ids, the no-op :class:`Hook` base, and the
ordered :class:`Hooks` dispatcher. A copy of the JAX package's, with its
auth (``hooks.auth``), storage (``hooks.storage``) and debug
(``hooks.debug``) hooks.

Behavioral parity with reference ``hooks.go``: event ids :19-58, the Hook
interface :71-115 (the Python base merges the reference's ``Hook`` +
``HookBase``), and the dispatcher semantics :199-680 —

- modifier chains (on_packet_read / on_subscribe / on_publish / ...) thread
  the packet through hooks in attach order;
- ``ERR_REJECT_PACKET`` short-circuits on_packet_read / on_publish;
- ``CODE_SUCCESS_IGNORE`` from on_publish marks the message ignore-only;
- Stored* readers return the first non-empty result;
- on_connect_authenticate / on_acl_check OR across hooks, default deny-all.
"""

from __future__ import annotations

import logging
import threading
from typing import TYPE_CHECKING, Any, Optional

from ..packets import (
    CODE_SUCCESS_IGNORE,
    ERR_REJECT_PACKET,
    Code,
    Packet,
)
from ..system import Info

if TYPE_CHECKING:
    from ..clients import Will
    from ..topics import Subscribers

# Hook event ids (hooks.go:19-58).
SET_OPTIONS = 0
ON_SYS_INFO_TICK = 1
ON_STARTED = 2
ON_STOPPED = 3
ON_CONNECT_AUTHENTICATE = 4
ON_ACL_CHECK = 5
ON_CONNECT = 6
ON_SESSION_ESTABLISH = 7
ON_SESSION_ESTABLISHED = 8
ON_DISCONNECT = 9
ON_AUTH_PACKET = 10
ON_PACKET_READ = 11
ON_PACKET_ENCODE = 12
ON_PACKET_SENT = 13
ON_PACKET_PROCESSED = 14
ON_SUBSCRIBE = 15
ON_SUBSCRIBED = 16
ON_SELECT_SUBSCRIBERS = 17
ON_UNSUBSCRIBE = 18
ON_UNSUBSCRIBED = 19
ON_PUBLISH = 20
ON_PUBLISHED = 21
ON_PUBLISH_DROPPED = 22
ON_RETAIN_MESSAGE = 23
ON_RETAIN_PUBLISHED = 24
ON_QOS_PUBLISH = 25
ON_QOS_COMPLETE = 26
ON_QOS_DROPPED = 27
ON_PACKET_ID_EXHAUSTED = 28
ON_WILL = 29
ON_WILL_SENT = 30
ON_CLIENT_EXPIRED = 31
ON_RETAINED_EXPIRED = 32
STORED_CLIENTS = 33
STORED_SUBSCRIPTIONS = 34
STORED_INFLIGHT_MESSAGES = 35
STORED_RETAINED_MESSAGES = 36
STORED_SYS_INFO = 37


class HookOptions:
    """Server values propagated to hooks on attach (hooks.go:118-120)."""

    def __init__(self, capabilities: Any = None) -> None:
        self.capabilities = capabilities


class Hook:
    """Base hook: every handler is a no-op and :meth:`provides` is empty —
    override both in concrete hooks (merges reference Hook + HookBase,
    hooks.go:71-115, :684-861)."""

    def __init__(self) -> None:
        self.log: logging.Logger = logging.getLogger("mqtt_tpu_torch.hook")
        self.opts: HookOptions = HookOptions()

    # -- lifecycle ---------------------------------------------------------

    def id(self) -> str:
        return "base"

    def provides(self, b: int) -> bool:
        return False

    def init(self, config: Any) -> None:
        """Pre-start initialization (connect to stores etc.). Raise to
        abort attach."""

    def stop(self) -> None:
        """Gracefully shut down the hook."""

    def set_opts(self, log: logging.Logger, opts: HookOptions) -> None:
        self.log = log
        self.opts = opts

    # -- events (no-op defaults) ------------------------------------------

    def on_started(self) -> None: ...
    def on_stopped(self) -> None: ...
    def on_sys_info_tick(self, info: Info) -> None: ...
    def on_connect_authenticate(self, cl, pk: Packet) -> bool:
        return False
    def on_acl_check(self, cl, topic: str, write: bool) -> bool:
        return False
    def on_connect(self, cl, pk: Packet) -> None: ...
    def on_session_establish(self, cl, pk: Packet) -> None: ...
    def on_session_established(self, cl, pk: Packet) -> None: ...
    def on_disconnect(self, cl, err: Optional[Exception], expire: bool) -> None: ...
    def on_auth_packet(self, cl, pk: Packet) -> Packet:
        return pk
    def on_packet_read(self, cl, pk: Packet) -> Packet:
        return pk
    def on_packet_encode(self, cl, pk: Packet) -> Packet:
        return pk
    def on_packet_sent(self, cl, pk: Packet, b: bytes) -> None: ...
    def on_packet_processed(self, cl, pk: Packet, err: Optional[Exception]) -> None: ...
    def on_subscribe(self, cl, pk: Packet) -> Packet:
        return pk
    def on_subscribed(self, cl, pk: Packet, reason_codes: bytes) -> None: ...
    def on_select_subscribers(self, subs: "Subscribers", pk: Packet) -> "Subscribers":
        return subs
    def on_unsubscribe(self, cl, pk: Packet) -> Packet:
        return pk
    def on_unsubscribed(self, cl, pk: Packet) -> None: ...
    def on_publish(self, cl, pk: Packet) -> Packet:
        return pk
    def on_published(self, cl, pk: Packet) -> None: ...
    def on_publish_dropped(self, cl, pk: Packet) -> None: ...
    def on_retain_message(self, cl, pk: Packet, r: int) -> None: ...
    def on_retain_published(self, cl, pk: Packet) -> None: ...
    def on_qos_publish(self, cl, pk: Packet, sent: int, resends: int) -> None: ...
    def on_qos_complete(self, cl, pk: Packet) -> None: ...
    def on_qos_dropped(self, cl, pk: Packet) -> None: ...
    def on_packet_id_exhausted(self, cl, pk: Packet) -> None: ...
    def on_will(self, cl, will: "Will") -> "Will":
        return will
    def on_will_sent(self, cl, pk: Packet) -> None: ...
    def on_client_expired(self, cl) -> None: ...
    def on_retained_expired(self, filter: str) -> None: ...

    # -- persistent store readers -----------------------------------------

    def stored_clients(self) -> list:
        return []
    def stored_subscriptions(self) -> list:
        return []
    def stored_inflight_messages(self) -> list:
        return []
    def stored_retained_messages(self) -> list:
        return []
    def stored_sys_info(self):
        return None


class Hooks:
    """An ordered chain of hooks called in attach sequence (hooks.go:123+)."""

    def __init__(self, log: Optional[logging.Logger] = None) -> None:
        self.log = log or logging.getLogger("mqtt_tpu_torch.hooks")
        self._lock = threading.Lock()
        self._hooks: list[Hook] = []
        # bumped on every add; lets hot paths cache provides() verdicts
        self.generation = 0

    def __len__(self) -> int:
        return len(self._hooks)

    def get_all(self) -> list[Hook]:
        return self._hooks

    def provides(self, *bs: int) -> bool:
        return any(h.provides(b) for h in self._hooks for b in bs)

    def add(self, hook: Hook, config: Any) -> None:
        """Initialize and append a hook; raises if init fails
        (hooks.go:150-170)."""
        with self._lock:
            try:
                hook.init(config)
            except Exception as e:
                raise RuntimeError(f"failed initialising {hook.id()} hook: {e}") from e
            # copy-on-write so dispatch iteration never sees a mid-append
            # list. The generation bumps BRACKET the publish: a reader that
            # scanned the old list against the pre-publish generation can
            # never cache its verdict as current, because by the time add()
            # returns the generation has moved again (the fast-publish gate
            # in server.py re-checks the generation before caching).
            self.generation += 1
            self._hooks = self._hooks + [hook]
            self.generation += 1

    def stop(self) -> None:
        for hook in self._hooks:
            self.log.info("stopping hook %s", hook.id())
            try:
                hook.stop()
            except Exception as e:
                self.log.debug("problem stopping hook %s: %s", hook.id(), e)

    # -- notification dispatchers (fire all providers) ---------------------

    def on_sys_info_tick(self, info: Info) -> None:
        for h in self._hooks:
            if h.provides(ON_SYS_INFO_TICK):
                h.on_sys_info_tick(info)

    def on_started(self) -> None:
        for h in self._hooks:
            if h.provides(ON_STARTED):
                h.on_started()

    def on_stopped(self) -> None:
        for h in self._hooks:
            if h.provides(ON_STOPPED):
                h.on_stopped()

    def on_connect(self, cl, pk: Packet) -> None:
        """First hook error aborts the connection (hooks.go:226-236)."""
        for h in self._hooks:
            if h.provides(ON_CONNECT):
                h.on_connect(cl, pk)

    def on_session_establish(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_SESSION_ESTABLISH):
                h.on_session_establish(cl, pk)

    def on_session_established(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_SESSION_ESTABLISHED):
                h.on_session_established(cl, pk)

    def on_disconnect(self, cl, err: Optional[Exception], expire: bool) -> None:
        for h in self._hooks:
            if h.provides(ON_DISCONNECT):
                h.on_disconnect(cl, err, expire)

    def on_packet_read(self, cl, pk: Packet) -> Packet:
        """Modifier chain; ERR_REJECT_PACKET raises through, any other hook
        error skips that hook (hooks.go:267-284)."""
        pkx = pk
        for h in self._hooks:
            if h.provides(ON_PACKET_READ):
                try:
                    pkx = h.on_packet_read(cl, pkx)
                except Code as e:
                    if e == ERR_REJECT_PACKET:
                        self.log.debug("packet rejected by hook %s", h.id())
                        raise
                    continue
        return pkx

    def on_auth_packet(self, cl, pk: Packet) -> Packet:
        """Modifier chain; any error aborts (hooks.go:288-302)."""
        pkx = pk
        for h in self._hooks:
            if h.provides(ON_AUTH_PACKET):
                pkx = h.on_auth_packet(cl, pkx)
        return pkx

    def on_packet_encode(self, cl, pk: Packet) -> Packet:
        for h in self._hooks:
            if h.provides(ON_PACKET_ENCODE):
                pk = h.on_packet_encode(cl, pk)
        return pk

    def on_packet_processed(self, cl, pk: Packet, err: Optional[Exception]) -> None:
        for h in self._hooks:
            if h.provides(ON_PACKET_PROCESSED):
                h.on_packet_processed(cl, pk, err)

    def on_packet_sent(self, cl, pk: Packet, b: bytes) -> None:
        for h in self._hooks:
            if h.provides(ON_PACKET_SENT):
                h.on_packet_sent(cl, pk, b)

    def on_subscribe(self, cl, pk: Packet) -> Packet:
        for h in self._hooks:
            if h.provides(ON_SUBSCRIBE):
                pk = h.on_subscribe(cl, pk)
        return pk

    def on_subscribed(self, cl, pk: Packet, reason_codes: bytes) -> None:
        for h in self._hooks:
            if h.provides(ON_SUBSCRIBED):
                h.on_subscribed(cl, pk, reason_codes)

    def on_select_subscribers(self, subs: "Subscribers", pk: Packet) -> "Subscribers":
        """The device seam: a hook can replace the subscriber set, e.g. with
        the device matcher's result (hooks.go:360-367)."""
        for h in self._hooks:
            if h.provides(ON_SELECT_SUBSCRIBERS):
                subs = h.on_select_subscribers(subs, pk)
        return subs

    def on_unsubscribe(self, cl, pk: Packet) -> Packet:
        for h in self._hooks:
            if h.provides(ON_UNSUBSCRIBE):
                pk = h.on_unsubscribe(cl, pk)
        return pk

    def on_unsubscribed(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_UNSUBSCRIBED):
                h.on_unsubscribed(cl, pk)

    def on_publish(self, cl, pk: Packet) -> Packet:
        """Modifier chain with reject/ignore semantics (hooks.go:394-420):
        ERR_REJECT_PACKET and CODE_SUCCESS_IGNORE raise through; any other
        error also aborts the chain (caller classifies)."""
        pkx = pk
        for h in self._hooks:
            if h.provides(ON_PUBLISH):
                try:
                    pkx = h.on_publish(cl, pkx)
                except Code as e:
                    if e == ERR_REJECT_PACKET:
                        self.log.debug("publish packet rejected by hook %s", h.id())
                    elif e != CODE_SUCCESS_IGNORE:
                        self.log.error("publish packet error in hook %s: %s", h.id(), e)
                    raise
        return pkx

    def on_published(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_PUBLISHED):
                h.on_published(cl, pk)

    def on_publish_dropped(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_PUBLISH_DROPPED):
                h.on_publish_dropped(cl, pk)

    def on_retain_message(self, cl, pk: Packet, r: int) -> None:
        for h in self._hooks:
            if h.provides(ON_RETAIN_MESSAGE):
                h.on_retain_message(cl, pk, r)

    def on_retain_published(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_RETAIN_PUBLISHED):
                h.on_retain_published(cl, pk)

    def on_qos_publish(self, cl, pk: Packet, sent: int, resends: int) -> None:
        for h in self._hooks:
            if h.provides(ON_QOS_PUBLISH):
                h.on_qos_publish(cl, pk, sent, resends)

    def on_qos_complete(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_QOS_COMPLETE):
                h.on_qos_complete(cl, pk)

    def on_qos_dropped(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_QOS_DROPPED):
                h.on_qos_dropped(cl, pk)

    def on_packet_id_exhausted(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_PACKET_ID_EXHAUSTED):
                h.on_packet_id_exhausted(cl, pk)

    def on_will(self, cl, will: "Will") -> "Will":
        """Modifier chain; a hook error skips that hook (hooks.go:506-522)."""
        for h in self._hooks:
            if h.provides(ON_WILL):
                try:
                    will = h.on_will(cl, will)
                except Exception as e:
                    self.log.error("parse will error in hook %s: %s", h.id(), e)
                    continue
        return will

    def on_will_sent(self, cl, pk: Packet) -> None:
        for h in self._hooks:
            if h.provides(ON_WILL_SENT):
                h.on_will_sent(cl, pk)

    def on_client_expired(self, cl) -> None:
        for h in self._hooks:
            if h.provides(ON_CLIENT_EXPIRED):
                h.on_client_expired(cl)

    def on_retained_expired(self, filter: str) -> None:
        for h in self._hooks:
            if h.provides(ON_RETAINED_EXPIRED):
                h.on_retained_expired(filter)

    # -- auth gates (OR across hooks, default deny) ------------------------

    def on_connect_authenticate(self, cl, pk: Packet) -> bool:
        for h in self._hooks:
            if h.provides(ON_CONNECT_AUTHENTICATE) and h.on_connect_authenticate(cl, pk):
                return True
        return False

    def on_acl_check(self, cl, topic: str, write: bool) -> bool:
        for h in self._hooks:
            if h.provides(ON_ACL_CHECK) and h.on_acl_check(cl, topic, write):
                return True
        return False

    # -- persistent store readers (first non-empty wins) -------------------

    def stored_clients(self) -> list:
        for h in self._hooks:
            if h.provides(STORED_CLIENTS):
                v = h.stored_clients()
                if v:
                    return v
        return []

    def stored_subscriptions(self) -> list:
        for h in self._hooks:
            if h.provides(STORED_SUBSCRIPTIONS):
                v = h.stored_subscriptions()
                if v:
                    return v
        return []

    def stored_inflight_messages(self) -> list:
        for h in self._hooks:
            if h.provides(STORED_INFLIGHT_MESSAGES):
                v = h.stored_inflight_messages()
                if v:
                    return v
        return []

    def stored_retained_messages(self) -> list:
        for h in self._hooks:
            if h.provides(STORED_RETAINED_MESSAGES):
                v = h.stored_retained_messages()
                if v:
                    return v
        return []

    def stored_sys_info(self):
        for h in self._hooks:
            if h.provides(STORED_SYS_INFO):
                v = h.stored_sys_info()
                if v is not None and getattr(v.info, "version", ""):
                    return v
        return None
