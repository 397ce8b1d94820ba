"""The secure multi-tenant plane (MQT-TZ, arxiv 2007.12442): the tenant
registry, the key registry and the batched re-encryption engine.

- :class:`TenantPlane`: the tenant registry and CONNECT-time resolution.
  A client maps (username first, then client id, then the default) to a
  :class:`Tenant`; from then on every key the broker stores or matches
  for it carries the tenant's namespace prefix (``topics.ns_scope_topic``
  / ``ns_scope_filter``), so two tenants' identical topics land on
  disjoint trie subtrees. Per-tenant counters register lazily, at a
  tenant's first CONNECT, as labelled ``mqtt_tpu_tenant_*`` families on a
  ``telemetry.MetricsRegistry`` given to the plane.
- :class:`KeyRegistry`: per-(tenant, identity) AES-128 keys, expanded
  once into a dense round-key table (``uint8 [T, 11, 16]``) that a launch
  gathers per-block keys from by index; re-key epochs layer on top.
- :class:`RecryptEngine`: publishes in a tenant's ``encrypted``
  namespaces arrive as ``nonce || ciphertext`` under the publisher's key.
  The broker decrypts once (the keystream launch rides the staged match
  batch: a :class:`RecryptJob` travels through ``staging.MatchStage``
  beside the predicate feature rows) and re-encrypts per subscriber with
  each subscriber's key: ONE keystream launch per fan-out tick covers
  every (publish, subscriber) block, and the XOR runs on the host
  (numpy). Across a key rotation, ``reseal_batch`` re-seals stored
  ciphertexts (the retained store) from the old generation to the new in
  ONE launch of decrypt and seal blocks. The numpy keystream is the
  sampled oracle.

Unlike the JAX engine there is no circuit breaker: a failed launch or
copy raises to the caller (in the stage: the batch's futures). The host
keystream serves only what the JAX engine routes there by design —
batches below ``device_min_blocks``, and jobs that reach
``open_publish`` without a staged keystream — counted in
``host_reasons``. The plane's and the key registry's locks are the lock
plane's ``tenants`` and ``recrypt_keys`` (``utils/locked``).

Subscribers without a key receive NOTHING from an encrypted namespace
(counted, never plaintext); ciphertext shorter than the nonce delivers
nothing and counts.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from typing import Callable, Optional

import numpy as np

from .ops.flat import resolve_device
from .ops.recrypt import (
    NONCE_BYTES,
    aes_encrypt_blocks,
    ctr_counters,
    expand_key,
    host_keystream,
    keystream_async,
    xor_into,
)
from .telemetry import MetricsRegistry
from .topics import NS_CHAR, ns_local, ns_scope_filter, ns_scope_topic, ns_tenant
from .utils.locked import InstrumentedLock

_log = logging.getLogger("mqtt_tpu_torch.tenancy")

# -- epoch-tagged nonces (live tenant re-key) ------------------------------
#
# CTR ciphertext carries no authentication, so during a key rotation the
# broker cannot tell which epoch's key sealed a payload. Rekey-aware clients
# stamp the epoch into their nonce: byte 0 is a magic marker, bytes 1:3 the
# big-endian epoch, bytes 3:12 the client's own material. The tag is read
# only for tenants that have staged an epoch.

EPOCH_NONCE_MAGIC = 0xA7


def epoch_tag_nonce(nonce: bytes, epoch: int) -> bytes:
    """Stamp an epoch tag over a 12-byte nonce's first 3 bytes."""
    return bytes((EPOCH_NONCE_MAGIC, (epoch >> 8) & 0xFF, epoch & 0xFF)) + nonce[3:]


def nonce_epoch(nonce: bytes) -> Optional[int]:
    """The epoch a tagged nonce names, or None for an untagged nonce."""
    if len(nonce) >= 3 and nonce[0] == EPOCH_NONCE_MAGIC:
        return (nonce[1] << 8) | nonce[2]
    return None


def scope_client_id(tenant: str, client_id: str) -> str:
    """The broker-registry identity of a tenant client, scoped like a
    topic: two tenants' equal client ids never take over each other's
    sessions."""
    return NS_CHAR + tenant + "/" + client_id


def local_client_id(client_id: str) -> str:
    """The tenant-local client id (identity for global ids)."""
    return ns_local(client_id)


class Tenant:
    """One tenant: namespace name, quota class, encrypted prefixes, count
    caps and the per-tenant counters (``$SYS`` rows and labelled registry
    families). Counter bumps are plain ``+=`` on the event loop."""

    __slots__ = (
        "name",
        "quota_class",
        "encrypted",
        "connected",
        "connects",
        "messages_in",
        "messages_out",
        "messages_dropped",
        "bytes_in",
        "bytes_out",
        "recrypt_fanouts",
        "max_retained",
        "max_subscriptions",
        "retained_count",
        "subscriptions_count",
        "retained_refused",
        "subscriptions_refused",
    )

    def __init__(
        self,
        name: str,
        quota_class: str = "",
        encrypted: tuple = (),
        max_retained: int = 0,
        max_subscriptions: int = 0,
    ) -> None:
        self.name = name
        self.quota_class = quota_class
        # tenant-local topic prefixes whose publishes carry the
        # nonce || ciphertext wire format and re-encrypt per subscriber
        self.encrypted = tuple(encrypted)
        self.connected = 0
        self.connects = 0
        self.messages_in = 0
        self.messages_out = 0
        self.messages_dropped = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.recrypt_fanouts = 0
        # how many retained topics / stored subscriptions the tenant may
        # hold (0 = unlimited); the broker keeps the counts and refuses
        # growth past a cap with v5 0x97 Quota exceeded
        self.max_retained = max_retained
        self.max_subscriptions = max_subscriptions
        self.retained_count = 0
        self.subscriptions_count = 0
        self.retained_refused = 0
        self.subscriptions_refused = 0

    def is_encrypted(self, local_topic: str) -> bool:
        """Does a tenant-local topic live in an encrypted namespace?"""
        return any(local_topic.startswith(prefix) for prefix in self.encrypted)

    def sys_rows(self) -> dict:
        """The per-tenant ``$SYS/broker/tenant/*`` rows."""
        return {
            "connected": self.connected,
            "connects": self.connects,
            "messages/in": self.messages_in,
            "messages/out": self.messages_out,
            "messages/dropped": self.messages_dropped,
            "bytes/in": self.bytes_in,
            "bytes/out": self.bytes_out,
            "recrypt_fanouts": self.recrypt_fanouts,
            "retained/count": self.retained_count,
            "retained/refused": self.retained_refused,
            "subscriptions/count": self.subscriptions_count,
            "subscriptions/refused": self.subscriptions_refused,
        }


def _valid_tenant_name(name: str) -> bool:
    return bool(name) and not any(c in name for c in ("/", "+", "#", NS_CHAR))


class TenantPlane:
    """The tenant registry and CONNECT-time resolver. Registration runs at
    startup (config) or from embedder code, resolution once per CONNECT.
    The lock guards the registry maps only; scoping and counter bumps take
    no lock."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self._lock = InstrumentedLock("tenants")
        self._tenants: dict[str, Tenant] = {}
        self._users: dict[str, str] = {}  # username-or-client-id -> tenant
        self.default = ""  # tenant for unmapped clients ("" = untenanted)
        self.keys = KeyRegistry()
        self._registry = registry
        self._metered: set[str] = set()  # tenants with registered families

    # -- registration ------------------------------------------------------

    def register(self, name: str, quota_class: str = "", encrypted: tuple = ()) -> Tenant:
        """Create (or return) one tenant. An invalid name raises: tenancy
        is operator config, so a typo fails at startup."""
        if not _valid_tenant_name(name):
            raise ValueError(f"invalid tenant name: {name!r}")
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(name, quota_class=quota_class, encrypted=tuple(encrypted))
            return t

    def map_user(self, ident: str, tenant: str) -> None:
        """Route a username-or-client-id to a tenant at CONNECT."""
        with self._lock:
            self._users[ident] = tenant

    def configure(self, tenants: Optional[dict], users: Optional[dict], default: str = "") -> None:
        """Load the config maps: ``tenants`` is name -> {quota_class,
        encrypted: [prefix...], max_retained, max_subscriptions, keys:
        {ident: hex}}, ``users`` is username-or-client-id -> tenant name."""
        for name, cfg in (tenants or {}).items():
            cfg = cfg or {}
            t = self.register(
                str(name),
                quota_class=str(cfg.get("quota_class", "") or ""),
                encrypted=tuple(cfg.get("encrypted", ()) or ()),
            )
            try:
                t.max_retained = int(cfg.get("max_retained", t.max_retained))
                t.max_subscriptions = int(cfg.get("max_subscriptions", t.max_subscriptions))
            except (TypeError, ValueError):
                _log.warning("tenant %r max_retained/max_subscriptions is not an integer; cap ignored", t.name)
            for ident, hexkey in (cfg.get("keys") or {}).items():
                try:
                    self.keys.set_key(t.name, str(ident), bytes.fromhex(str(hexkey)))
                except ValueError:
                    _log.warning("tenant %r key for %r is not a 32-hex-char AES-128 key; ignored", t.name, ident)
        for ident, tenant in (users or {}).items():
            self.map_user(str(ident), str(tenant))
        if default:
            self.register(str(default))
            self.default = str(default)

    # -- resolution --------------------------------------------------------

    def resolve(self, username: str, client_id: str) -> Optional[Tenant]:
        """The CONNECT-time tenant: username first, then client id, then
        the default; None = untenanted (the global namespace). A tenant
        name in the user map that is not registered registers itself."""
        with self._lock:
            name = self._users.get(username) or self._users.get(client_id) or self.default
            if not name:
                return None
            t = self._tenants.get(name)
        if t is None:
            t = self.register(name)
        return t

    def get(self, name: str) -> Optional[Tenant]:
        with self._lock:
            return self._tenants.get(name)

    def tenant_of_topic(self, scoped_topic: str) -> Optional[Tenant]:
        """The tenant owning a scoped topic key (None for global)."""
        name = ns_tenant(scoped_topic)
        if not name:
            return None
        with self._lock:
            return self._tenants.get(name)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    scope_topic = staticmethod(ns_scope_topic)
    scope_filter = staticmethod(ns_scope_filter)
    local = staticmethod(ns_local)

    # -- accounting --------------------------------------------------------

    def note_connect(self, tenant: Tenant) -> None:
        tenant.connects += 1
        tenant.connected += 1
        if self._registry is not None and tenant.name not in self._metered:
            # families register at a tenant's first CONNECT, outside the
            # plane lock (the registry takes its own)
            with self._lock:
                fresh = tenant.name not in self._metered
                self._metered.add(tenant.name)
            if fresh:
                self._register_tenant_metrics(tenant)

    def note_disconnect(self, tenant: Tenant) -> None:
        tenant.connected = max(0, tenant.connected - 1)

    def active_tenants(self) -> list[Tenant]:
        """Tenants with live connections or a connect in their history:
        the set the per-tenant ``$SYS`` tick publishes for."""
        with self._lock:
            snap = list(self._tenants.values())
        return [t for t in snap if t.connected > 0 or t.connects > 0]

    def _register_tenant_metrics(self, tenant: Tenant) -> None:
        r = self._registry
        for name, attr in (
            ("mqtt_tpu_tenant_messages_in_total", "messages_in"),
            ("mqtt_tpu_tenant_messages_out_total", "messages_out"),
            ("mqtt_tpu_tenant_messages_dropped_total", "messages_dropped"),
            ("mqtt_tpu_tenant_bytes_in_total", "bytes_in"),
            ("mqtt_tpu_tenant_bytes_out_total", "bytes_out"),
            ("mqtt_tpu_tenant_connects_total", "connects"),
            ("mqtt_tpu_tenant_retained_refused_total", "retained_refused"),
            ("mqtt_tpu_tenant_subscriptions_refused_total", "subscriptions_refused"),
        ):
            r.counter(name, f"Per-tenant Tenant.{attr}", fn=lambda t=tenant, a=attr: getattr(t, a),
                      tenant=tenant.name)
        r.gauge("mqtt_tpu_tenant_connected", "Live connections per tenant",
                fn=lambda t=tenant: t.connected, tenant=tenant.name)
        r.gauge("mqtt_tpu_tenant_retained_count",
                "Retained topics currently held per tenant (count-capped by "
                "max_retained / tenant_max_retained)",
                fn=lambda t=tenant: t.retained_count, tenant=tenant.name)
        r.gauge("mqtt_tpu_tenant_subscriptions_count",
                "Stored subscriptions currently held per tenant (count-capped "
                "by max_subscriptions / tenant_max_subscriptions)",
                fn=lambda t=tenant: t.subscriptions_count, tenant=tenant.name)


class KeyRegistry:
    """Per-(tenant, identity) AES-128 keys, expanded once into a dense
    round-key table. Identity is a tenant-local client id or username.

    Re-key epochs: ``stage_epoch`` registers a tenant's next key generation
    as fresh table rows (current lookups untouched), ``activate_epoch``
    flips the tenant's current-id map to them (old rows stay addressable
    by epoch for the in-flight drain), and ``retire_epoch`` cuts the old
    generation off: tagged lookups below the floor answer -2 and the
    retired rows are scrubbed to zeros. Launches snapshot ``table()``, so
    work keyed before a rotation drains on the old key material."""

    def __init__(self) -> None:
        self._lock = InstrumentedLock("recrypt_keys")
        self._ids: dict[tuple[str, str], int] = {}
        self._round_keys: list[np.ndarray] = []  # [11, 16] per key id
        self._table: Optional[np.ndarray] = None  # stacked cache
        # tenant -> current epoch (absent = 0); (tenant, ident, epoch) ->
        # kid; tenant -> staged epoch; tenant -> lowest live epoch
        self._epochs: dict[str, int] = {}
        self._epoch_kids: dict[tuple[str, str, int], int] = {}
        self._staged: dict[str, int] = {}
        self._floor: dict[str, int] = {}

    def set_key(self, tenant: str, ident: str, key: bytes) -> int:
        """Register (or rotate) one identity's key; returns its dense id."""
        rk = expand_key(key)  # raises on a non-16-byte key
        with self._lock:
            kid = self._ids.get((tenant, ident))
            if kid is None:
                kid = len(self._round_keys)
                self._ids[(tenant, ident)] = kid
                self._round_keys.append(rk)
            else:
                self._round_keys[kid] = rk
            self._epoch_kids[(tenant, ident, self._epochs.get(tenant, 0))] = kid
            self._table = None
            return kid

    def stage_epoch(self, tenant: str, keys: dict) -> int:
        """Register a tenant's NEXT key generation (ident -> raw key) as
        fresh rows; returns the staged epoch number."""
        rks = {ident: expand_key(key) for ident, key in keys.items()}
        with self._lock:
            epoch = self._epochs.get(tenant, 0) + 1
            for ident, rk in rks.items():
                kid = len(self._round_keys)
                self._round_keys.append(rk)
                self._epoch_kids[(tenant, ident, epoch)] = kid
            self._staged[tenant] = epoch
            self._table = None
            return epoch

    def activate_epoch(self, tenant: str) -> int:
        """Flip the tenant's current ids to the staged generation; returns
        the now-current epoch (-1 when nothing is staged)."""
        with self._lock:
            epoch = self._staged.pop(tenant, -1)
            if epoch < 0:
                return -1
            for (t, ident, ep), kid in self._epoch_kids.items():
                if t == tenant and ep == epoch:
                    self._ids[(tenant, ident)] = kid
            self._epochs[tenant] = epoch
            return epoch

    def retire_epoch(self, tenant: str, epoch: int) -> int:
        """Retire every generation of a tenant up to ``epoch`` (never the
        live one); returns how many rows were scrubbed."""
        scrubbed = 0
        with self._lock:
            floor = max(self._floor.get(tenant, 0), epoch + 1)
            floor = min(floor, self._epochs.get(tenant, 0))
            self._floor[tenant] = floor
            live = set(self._ids.values())
            for (t, _ident, ep), kid in self._epoch_kids.items():
                if t == tenant and ep < floor and kid not in live:
                    if self._round_keys[kid].any():
                        self._round_keys[kid] = np.zeros((11, 16), np.uint8)
                        scrubbed += 1
            if scrubbed:
                self._table = None
        return scrubbed

    def current_epoch(self, tenant: str) -> int:
        with self._lock:
            return self._epochs.get(tenant, 0)

    def staged_epoch(self, tenant: str) -> int:
        """The staged-but-inactive epoch, or -1."""
        with self._lock:
            return self._staged.get(tenant, -1)

    def has_epochs(self, tenant: str) -> bool:
        """Has this tenant ever staged a re-key? (Only then are nonce
        epoch tags read.)"""
        with self._lock:
            return self._epochs.get(tenant, 0) > 0 or tenant in self._staged

    def kid_for_epoch(self, tenant: str, ident: str, epoch: int) -> int:
        """The key id of one identity AT one epoch: -1 = no such key,
        -2 = that generation is retired."""
        with self._lock:
            if epoch < self._floor.get(tenant, 0):
                return -2
            kid = self._epoch_kids.get((tenant, ident, epoch))
            if kid is not None:
                return kid
            if epoch == 0:  # keyed before the first rotation
                return self._ids.get((tenant, ident), -1)
            return -1

    def key_id(self, tenant: str, ident: str) -> int:
        """The dense key id of an identity, or -1."""
        with self._lock:
            return self._ids.get((tenant, ident), -1)

    def key_ids(self, tenant: str, idents_list: list) -> list:
        """Batch lookup: each element of ``idents_list`` is a tuple of
        candidate identities; the first registered one wins (-1 = none)."""
        return self.key_ids_with_epoch(tenant, idents_list)[0]

    def key_ids_with_epoch(self, tenant: str, idents_list: list) -> tuple[list, int]:
        """:meth:`key_ids` plus the tenant's current epoch, under one lock,
        so a tick racing ``activate_epoch`` never mixes generations."""
        with self._lock:
            ids = self._ids
            out = []
            for idents in idents_list:
                kid = -1
                for ident in idents:
                    if ident:
                        kid = ids.get((tenant, ident), -1)
                        if kid >= 0:
                            break
                out.append(kid)
            return out, self._epochs.get(tenant, 0)

    def table(self) -> Optional[np.ndarray]:
        """The stacked round-key table ``uint8 [T, 11, 16]`` (None when no
        keys exist), cached until the next mutation."""
        with self._lock:
            if self._table is None and self._round_keys:
                self._table = np.stack(self._round_keys)
            return self._table

    def __len__(self) -> int:
        with self._lock:
            return len(self._ids)


class RecryptJob:
    """One publish's decrypt leg through the stage: its keystream launch
    rides the match batch, and the fan-out XORs the attached keystream."""

    __slots__ = ("key_id", "nonce", "n_blocks", "keystream", "error")

    def __init__(self, key_id: int, nonce: bytes, n_blocks: int, error: str = "") -> None:
        self.key_id = key_id
        self.nonce = nonce
        self.n_blocks = n_blocks
        self.keystream: Optional[np.ndarray] = None  # uint8 [n_blocks, 16]
        self.error = error  # "no_key" | "malformed" | "stale_epoch" | ""


class RecryptEngine:
    """Batched per-subscriber payload re-encryption with the numpy
    keystream as its sampled oracle. ``device`` is where the keystream
    kernel runs: ``"cuda"`` by default (raises where there is no card),
    ``"cpu"`` for the plain PyTorch version."""

    def __init__(
        self,
        keys: KeyRegistry,
        oracle_sample: int = 64,
        device_min_blocks: int = 4,
        device="cuda",
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.keys = keys
        self.nonce_bytes = NONCE_BYTES
        self.oracle_sample = max(0, oracle_sample)
        # a launch below this many blocks runs on the host: the data is on
        # the host, and a tiny batch's round trip costs more than it saves
        self.device_min_blocks = max(1, device_min_blocks)
        # False: every keystream is generated on the host, a route the
        # caller chose (set_device_enabled); a kernel fault still raises
        self._device_enabled = True
        # nonce source: a 6-byte random base per engine lifetime and a
        # 6-byte big-endian counter; the base keeps restarts from reusing
        # a nonce under one persistent key
        self._nonce_base = os.urandom(6)
        self._nonce_ctr = 0
        self._nonce_lock = threading.Lock()
        self.fanouts = 0  # publishes re-encrypted per subscriber
        self.device_batches = 0
        self.device_blocks = 0
        self.host_blocks = 0
        self.oracle_checks = 0
        self.oracle_mismatches = 0
        self.no_key_drops = 0  # deliveries withheld: subscriber keyless
        self.malformed = 0  # publishes dropped: bad ciphertext framing
        self.stale_epoch_drops = 0  # publishes under a retired epoch key
        self.rekeys = 0  # epoch rotations completed
        self.resealed = 0  # stored payloads re-sealed across epochs
        # host keystream blocks by reason: small_batch (a fan-out under
        # device_min_blocks), device_disabled (a fan-out or re-seal while
        # set_device_enabled(False)), no_keystream (a decrypt job that
        # reached open_publish without a staged keystream)
        self.host_reasons: dict[str, int] = {}
        self._dispatch_seq = 0  # oracle sampling clock
        # the engine's mqtt_tpu_recrypt_* families, and where note_rekey
        # registers its per-tenant epoch gauge
        self._registry = registry
        self._epoch_metered: set[str] = set()
        if registry is not None:
            self._register_metrics(registry)

    def _host(self, reason: str, n: int) -> None:
        self.host_reasons[reason] = self.host_reasons.get(reason, 0) + n

    def set_device_enabled(self, enabled: bool) -> None:
        """Route every keystream to the card (True, the default) or to the
        host (False), at the points where the JAX engine reads the same
        switch: the staged decrypt launch, the fan-out seal, the re-seal."""
        self._device_enabled = enabled

    def reseed_nonce(self, base: bytes, ctr: int = 0) -> None:
        """Pin the nonce stream (tests, differential replays)."""
        with self._nonce_lock:
            self._nonce_base = base[:6].ljust(6, b"\x00")
            self._nonce_ctr = ctr

    def next_nonce(self) -> bytes:
        with self._nonce_lock:
            self._nonce_ctr += 1
            ctr = self._nonce_ctr
        return self._nonce_base + struct.pack(">Q", ctr)[2:]

    def _next_nonces(self, n: int) -> np.ndarray:
        """``n`` fresh 12-byte nonces as uint8 [n, 12], one lock round trip."""
        with self._nonce_lock:
            start = self._nonce_ctr + 1
            self._nonce_ctr += n
        out = np.empty((n, 12), dtype=np.uint8)
        out[:, :6] = np.frombuffer(self._nonce_base, dtype=np.uint8)
        ctrs = (start + np.arange(n, dtype=np.uint64)).astype(">u8")
        out[:, 6:] = ctrs.view(np.uint8).reshape(n, 8)[:, 2:]
        return out

    # -- the decrypt leg ---------------------------------------------------

    def decrypt_job(self, tenant: Tenant, idents: tuple, payload: bytes) -> RecryptJob:
        """The publisher-side decrypt job of one encrypted-namespace
        publish. ``idents`` are the candidate key identities. A keyless
        publisher, a retired epoch or malformed framing gives an errored
        job: the fan-out drops the publish (counted)."""
        if len(payload) < self.nonce_bytes:
            self.malformed += 1
            return RecryptJob(-1, b"", 0, error="malformed")
        epoch = None
        if self.keys.has_epochs(tenant.name):
            epoch = nonce_epoch(payload[: self.nonce_bytes])
        kid = -1
        for ident in idents:
            if not ident:
                continue
            if epoch is None:
                kid = self.keys.key_id(tenant.name, ident)
            else:
                kid = self.keys.kid_for_epoch(tenant.name, ident, epoch)
                if kid == -2:
                    self.stale_epoch_drops += 1
                    return RecryptJob(-1, b"", 0, error="stale_epoch")
            if kid >= 0:
                break
        if kid < 0:
            self.no_key_drops += 1
            return RecryptJob(-1, b"", 0, error="no_key")
        nonce = payload[: self.nonce_bytes]
        n_blocks = (len(payload) - self.nonce_bytes + 15) // 16
        return RecryptJob(kid, nonce, n_blocks)

    def issue_batch(self, jobs: list) -> Optional[Callable]:
        """Issue ONE keystream launch covering every viable decrypt job of
        a staged batch; returns a zero-arg resolver (run in the stage's
        drain leg beside the match's) yielding ``[(job, rows), ...]``, or
        None when there is no device work (no viable job, fewer blocks
        than ``device_min_blocks``, no keys). A failed launch or copy
        raises."""
        viable = [j for j in jobs if j is not None and not j.error and j.n_blocks > 0]
        if not viable or not self._device_enabled:
            return None
        total = sum(j.n_blocks for j in viable)
        if total < self.device_min_blocks:
            return None
        table = self.keys.table()
        if table is None:
            return None
        kidx = np.empty(total, dtype=np.int32)
        counters = np.empty((total, 16), dtype=np.uint8)
        spans = []
        off = 0
        for j in viable:
            kidx[off : off + j.n_blocks] = j.key_id
            counters[off : off + j.n_blocks] = ctr_counters(j.nonce, j.n_blocks)
            spans.append((j, off, off + j.n_blocks))
            off += j.n_blocks
        resolver = keystream_async(table, kidx, counters, self.device)

        def resolve() -> list:
            rows = resolver()
            self.device_batches += 1
            self.device_blocks += total
            self._maybe_oracle(table, kidx, counters, rows)
            return [(j, rows[a:b]) for j, a, b in spans]

        return resolve

    @staticmethod
    def attach(resolved: Optional[list]) -> None:
        """Stamp resolved keystream slices onto their jobs (the stage's
        drain leg, before the futures complete)."""
        if resolved is None:
            return
        for job, rows in resolved:
            job.keystream = rows

    def _maybe_oracle(self, table: np.ndarray, kidx: np.ndarray, counters: np.ndarray,
                      rows: np.ndarray) -> None:
        """The sampled differential: one in ``oracle_sample`` launches is
        re-derived on the numpy path and compared byte for byte; on a
        mismatch the host rows replace the device rows."""
        self._dispatch_seq += 1
        if self.oracle_sample <= 0 or self._dispatch_seq % self.oracle_sample:
            return
        self.oracle_checks += 1
        want = host_keystream(table, kidx, counters)
        if not np.array_equal(want, rows):
            self.oracle_mismatches += 1
            _log.warning("recrypt oracle mismatch over %d blocks; host wins", len(kidx))
            rows[:] = want

    def _host_keystream_for(self, key_id: int, nonce: bytes, n_blocks: int) -> np.ndarray:
        table = self.keys.table()
        assert table is not None  # the caller resolved key_id from it
        self.host_blocks += n_blocks
        return host_keystream(table, np.full(n_blocks, key_id, dtype=np.int32), ctr_counters(nonce, n_blocks))

    def open_publish(self, tenant: Tenant, idents: tuple, payload: bytes,
                     job: Optional[RecryptJob] = None) -> Optional[bytes]:
        """The publish's plaintext, from the job's staged keystream when
        its batch rode the card, else the host keystream. None =
        undeliverable (keyless publisher, malformed framing)."""
        if job is None:
            job = self.decrypt_job(tenant, idents, payload)
        if job.error:
            return None
        ks = job.keystream
        if ks is None:
            self._host("no_keystream", job.n_blocks)
            ks = self._host_keystream_for(job.key_id, job.nonce, job.n_blocks)
        return xor_into(payload[self.nonce_bytes :], ks)

    # -- the fan-out leg ---------------------------------------------------

    def _keystream_rows(self, table, kidx: np.ndarray, counters: np.ndarray) -> np.ndarray:
        """One keystream generation: one launch from ``device_min_blocks``
        blocks up, the host keystream below (counted)."""
        total = len(kidx)
        if total >= self.device_min_blocks and self._device_enabled:
            rows = keystream_async(table, kidx, counters, self.device)()
            self.device_batches += 1
            self.device_blocks += total
            self._maybe_oracle(table, kidx, counters, rows)
            return rows
        self._host("small_batch" if self._device_enabled else "device_disabled", total)
        self.host_blocks += total
        return host_keystream(table, kidx, counters)

    def seal_fanout_raw(self, tenant: Tenant, plaintext: bytes, targets: list) -> Optional[tuple]:
        """One keystream generation for every keyed target (the card when
        the tick has at least ``device_min_blocks`` blocks, the host
        otherwise), without the per-target assembly. Returns ``(keyed,
        nonces, rows)`` — ``keyed`` the ``[(target_key, key_id), ...]``
        that resolved a key, aligned with ``nonces`` uint8 [J, 12] and
        ``rows`` uint8 [J*n_blocks, 16] (None for an empty plaintext) — or
        None when no target is keyed. Keyless targets are counted."""
        n_blocks = (len(plaintext) + 15) // 16
        kids, epoch = self.keys.key_ids_with_epoch(tenant.name, [t[1] for t in targets])
        keyed = [(t[0], kid) for t, kid in zip(targets, kids) if kid >= 0]
        dropped = len(targets) - len(keyed)
        if dropped:
            self.no_key_drops += dropped
        if not keyed:
            return None
        self.fanouts += 1
        tenant.recrypt_fanouts += 1
        j = len(keyed)
        nonces = self._next_nonces(j)
        if epoch > 0:
            # after a rotation, subscriber nonces carry the epoch tag
            nonces[:, 0] = EPOCH_NONCE_MAGIC
            nonces[:, 1] = (epoch >> 8) & 0xFF
            nonces[:, 2] = epoch & 0xFF
        if n_blocks == 0:
            return keyed, nonces, None  # the wire payload is the bare nonce
        total = n_blocks * j
        table = self.keys.table()
        # each job's blocks repeat its nonce and count 0..n_blocks-1
        kidx = np.repeat(np.array([kid for _t, kid in keyed], dtype=np.int32), n_blocks)
        counters = np.empty((total, 16), dtype=np.uint8)
        counters[:, :12] = np.repeat(nonces, n_blocks, axis=0)
        ctr = np.tile(np.arange(n_blocks, dtype=np.uint32).astype(">u4"), j)
        counters[:, 12:] = ctr.view(np.uint8).reshape(total, 4)
        return keyed, nonces, self._keystream_rows(table, kidx, counters)

    def seal_fanout(self, tenant: Tenant, plaintext: bytes, targets: list) -> dict:
        """Re-encrypt one plaintext for every keyed target in ONE
        keystream generation. ``targets`` yield ``(target_key, idents)``;
        returns target_key -> ``nonce || ciphertext`` for keyed targets
        (keyless targets are counted and withheld)."""
        out: dict = {}
        raw = self.seal_fanout_raw(tenant, plaintext, targets)
        if raw is None:
            return out
        keyed, nonces, rows = raw
        if rows is None:
            for i, (tkey, _kid) in enumerate(keyed):
                out[tkey] = nonces[i].tobytes()
            return out
        j = len(keyed)
        n_blocks = (len(plaintext) + 15) // 16
        pt = np.frombuffer(plaintext, dtype=np.uint8)
        ct = rows.reshape(j, n_blocks * 16)[:, : len(plaintext)] ^ pt[None, :]
        for i, (tkey, _kid) in enumerate(keyed):
            out[tkey] = nonces[i].tobytes() + ct[i].tobytes()
        return out

    # -- the re-key re-seal ------------------------------------------------

    def reseal_batch(self, tenant: Tenant, items: list, epoch: int) -> list:
        """Re-seal stored ciphertexts across a key rotation in ONE keystream
        generation: every item's decrypt blocks (old key) and seal blocks
        (new key) share the launch, ``[decrypt blocks | seal blocks]``, then
        one XOR per item rewrites its ciphertext. ``items`` yield
        ``(payload, old_kid, new_kid)`` with payload ``nonce ||
        ciphertext``; returns the new payloads (a fresh nonce tagged with
        ``epoch``, then the ciphertext; a zero-length ciphertext gives the
        nonce alone), None per malformed or keyless item."""
        del tenant  # the kids name the keys; the signature is the JAX engine's
        nb = self.nonce_bytes
        out: list = [None] * len(items)
        spans = []  # (item, old nonce, ciphertext, first block, blocks)
        total = 0
        for i, (payload, old_kid, new_kid) in enumerate(items):
            if len(payload) < nb or old_kid < 0 or new_kid < 0:
                continue
            ct = payload[nb:]
            n = (len(ct) + 15) // 16
            spans.append((i, payload[:nb], ct, total, n))
            total += n
        if not spans:
            return out
        fresh = self._next_nonces(len(spans))
        fresh[:, 0] = EPOCH_NONCE_MAGIC
        fresh[:, 1] = (epoch >> 8) & 0xFF
        fresh[:, 2] = epoch & 0xFF
        rows = None
        if total:
            kidx = np.empty(2 * total, dtype=np.int32)
            counters = np.empty((2 * total, 16), dtype=np.uint8)
            for s, (i, old_nonce, _ct, off, n) in enumerate(spans):
                _payload, old_kid, new_kid = items[i]
                kidx[off : off + n] = old_kid
                counters[off : off + n] = ctr_counters(old_nonce, n)
                kidx[total + off : total + off + n] = new_kid
                counters[total + off : total + off + n] = ctr_counters(fresh[s].tobytes(), n)
            rows = self._keystream_rows(self.keys.table(), kidx, counters)
        for s, (i, _old_nonce, ct, off, n) in enumerate(spans):
            self.resealed += 1
            if n == 0:
                out[i] = fresh[s].tobytes()
                continue
            c = np.frombuffer(ct, dtype=np.uint8)
            ks_old = rows[off : off + n].reshape(-1)[: len(ct)]
            ks_new = rows[total + off : total + off + n].reshape(-1)[: len(ct)]
            out[i] = fresh[s].tobytes() + (c ^ ks_old ^ ks_new).tobytes()
        return out

    def note_rekey(self, tenant: str) -> None:
        """Count one completed rotation and register the tenant's epoch
        gauge (``mqtt_tpu_recrypt_epoch``) on the registry, once."""
        self.rekeys += 1
        r = self._registry
        if r is not None and tenant not in self._epoch_metered:
            self._epoch_metered.add(tenant)
            r.gauge(
                "mqtt_tpu_recrypt_epoch",
                "Current re-key epoch per tenant (0 = never rotated)",
                fn=lambda t=tenant: self.keys.current_epoch(t),
                tenant=tenant,
            )

    # -- client-side helpers -----------------------------------------------

    def seal_with_key(self, key: bytes, plaintext: bytes, nonce: Optional[bytes] = None) -> bytes:
        """Encrypt ``plaintext`` under a raw key: what a publishing client
        does before the wire."""
        nonce = nonce if nonce is not None else self.next_nonce()
        n_blocks = (len(plaintext) + 15) // 16
        if n_blocks == 0:
            return nonce
        ks = aes_encrypt_blocks(np.broadcast_to(expand_key(key), (n_blocks, 11, 16)),
                                ctr_counters(nonce, n_blocks))
        return nonce + xor_into(plaintext, ks)

    def open_with_key(self, key: bytes, payload: bytes) -> bytes:
        """Decrypt a ``nonce || ciphertext`` wire payload under a raw key:
        what a subscribing client does."""
        nonce, ct = payload[: self.nonce_bytes], payload[self.nonce_bytes :]
        n_blocks = (len(ct) + 15) // 16
        if n_blocks == 0:
            return b""
        ks = aes_encrypt_blocks(np.broadcast_to(expand_key(key), (n_blocks, 11, 16)),
                                ctr_counters(nonce, n_blocks))
        return xor_into(ct, ks)

    def gauges(self) -> dict:
        """The ``$SYS/broker/recrypt/*`` tree (the JAX engine's, without
        the breaker state, plus the host blocks by reason)."""
        return {
            "keys": len(self.keys),
            "fanouts": self.fanouts,
            "device_batches": self.device_batches,
            "device_blocks": self.device_blocks,
            "host_blocks": self.host_blocks,
            "oracle_checks": self.oracle_checks,
            "oracle_mismatches": self.oracle_mismatches,
            "no_key_drops": self.no_key_drops,
            "malformed": self.malformed,
            "rekeys": self.rekeys,
            "resealed": self.resealed,
            "stale_epoch_drops": self.stale_epoch_drops,
            "host_reasons": dict(self.host_reasons),
        }

    def _register_metrics(self, registry: MetricsRegistry) -> None:
        """The JAX engine's Prometheus families, without its device-error
        counter: here a failed launch raises."""
        registry.gauge(
            "mqtt_tpu_recrypt_keys",
            "Registered per-(tenant, identity) AES keys",
            fn=lambda: len(self.keys),
        )
        for name, attr in (
            ("mqtt_tpu_recrypt_fanouts_total", "fanouts"),
            ("mqtt_tpu_recrypt_device_batches_total", "device_batches"),
            ("mqtt_tpu_recrypt_device_blocks_total", "device_blocks"),
            ("mqtt_tpu_recrypt_host_blocks_total", "host_blocks"),
            ("mqtt_tpu_recrypt_oracle_checks_total", "oracle_checks"),
            ("mqtt_tpu_recrypt_oracle_mismatches_total", "oracle_mismatches"),
            ("mqtt_tpu_recrypt_no_key_drops_total", "no_key_drops"),
            ("mqtt_tpu_recrypt_malformed_total", "malformed"),
            ("mqtt_tpu_recrypt_epoch_rekeys_total", "rekeys"),
            ("mqtt_tpu_recrypt_epoch_resealed_total", "resealed"),
            ("mqtt_tpu_recrypt_epoch_stale_drops_total", "stale_epoch_drops"),
        ):
            registry.counter(
                name,
                f"RecryptEngine.{attr}",
                fn=lambda a=attr: getattr(self, a),
            )
