"""MQTT+ payload-predicate subscriptions (arxiv 1810.00773), the host
engine.

An MQTT+ client appends a payload filter to a SUBSCRIBE filter —
``sensors/+/temp$GT{25.0}``, ``alerts/#$CONTAINS{alarm}`` — or an
aggregation window — ``sensors/+/temp$MEAN{temp:10}`` — and the broker
delivers only the publishes whose payload satisfies it. The split between
host and card follows the topic matcher's:

- ``topics.split_predicate_suffix`` strips the suffix at SUBSCRIBE time;
  the trie only ever sees the base filter.
- :class:`PredicateEngine` interns each distinct suffix into a
  :class:`CompiledRule` (op code, field slot, float32 threshold,
  contains-bit) and compiles the live rule set into the device rule table
  (``ops/predicates.DeviceRuleEvaluator``), rebuilt on registry
  generation bumps.
- Per publish the HOST extracts the payload features once (a float32
  vector over the field slots and a bitmask over the interned substrings
  and string equalities); the stage ships the batch's features beside
  its topics, and one kernel evaluates every rule on every publish in the
  same staged batch as the topic match.
- The host interpreter (:func:`eval_rule_host`) is the sampled oracle of
  the device verdicts, and decides where the JAX package's engine routes
  to the host by design: rows of an older registry generation, rules past
  ``max_rules``, the boolean combine of a compound's children, windows
  below ``DEVICE_AGG_MIN_WINDOW`` samples and ticks of fewer than
  ``DEVICE_AGG_MIN_BATCH`` windows. Each is counted in ``host_reasons``.

Unlike the JAX engine there is no circuit breaker: a kernel or copy that
fails raises to the caller (in the stage: the batch's futures), and no
host path answers for it.

Skip-to-pass: a numeric predicate whose field is missing, not numeric,
or whose payload is not JSON passes. Thresholds and values are float32 on
both paths, so host and card agree bit for bit.

Aggregation windows (``$MEAN{field:N}``, ``$MAX``, ``$MIN``) withhold raw
delivery and accumulate the value per (rule, subscriber); every Nth
sample emits one synthesized publish carrying the aggregate, during the
fan-out that completed the window.
"""

from __future__ import annotations

import json
import logging
import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from .ops.flat import resolve_device
from .telemetry import MetricsRegistry
from .topics import (
    PREDICATE_AGG_OPS,
    PREDICATE_COMPOUND_OPS,
    PREDICATE_NUMERIC_OPS,
    Subscribers,
    split_predicate_suffix,
    split_predicate_tokens,
)
from .utils.locked import InstrumentedLock

_log = logging.getLogger("mqtt_tpu_torch.predicates")

# op codes shared with the device kernel (ops/predicates.py)
OP_NONE = 0
OP_GT = 1
OP_GTE = 2
OP_LT = 3
OP_LTE = 4
OP_EQ = 5
OP_NE = 6
OP_CONTAINS = 7
OP_MEAN = 8
OP_MAX = 9
OP_MIN = 10
OP_EQS = 11
OP_AND = 12
OP_OR = 13

_OP_CODES = {
    "GT": OP_GT,
    "GTE": OP_GTE,
    "LT": OP_LT,
    "LTE": OP_LTE,
    "EQ": OP_EQ,
    "NE": OP_NE,
    "CONTAINS": OP_CONTAINS,
    "MEAN": OP_MEAN,
    "MAX": OP_MAX,
    "MIN": OP_MIN,
    "EQS": OP_EQS,
    "AND": OP_AND,
    "OR": OP_OR,
}
_AGG_CODES = {OP_MEAN, OP_MAX, OP_MIN}
_COMPOUND_CODES = {OP_AND, OP_OR}

# aggregation windows at least this wide buffer their samples and reduce
# on the card, one launch per fan-out tick...
DEVICE_AGG_MIN_WINDOW = 32
# ...when that tick completed at least this many of them: the samples are
# on the host, so a lone window is reduced there
DEVICE_AGG_MIN_BATCH = 4


@dataclass(frozen=True)
class PredicateSpec:
    """One parsed predicate: the semantic form of a ``$OP{arg}`` suffix."""

    op: int  # OP_* code
    field: str = ""  # JSON field name; "" = whole payload as the number
    value: float = 0.0  # comparison threshold (numeric ops)
    text: bytes = b""  # substring (CONTAINS) / literal utf-8 (EQS)
    window: int = 0  # sample count per emission (aggregation ops)
    children: tuple = ()  # member specs (AND/OR compounds only)

    @property
    def is_agg(self) -> bool:
        return self.op in _AGG_CODES

    @property
    def is_compound(self) -> bool:
        return self.op in _COMPOUND_CODES


def predicate_digest(suffix: str) -> int:
    """The 32-bit interning digest of one predicate suffix: CRC32 over
    the literal suffix text, deterministic across processes (two workers
    must agree on the digest of the same interned rule). A collision
    only merges two rules' cache slots — the suffix itself always
    travels beside the digest, so evaluation never trusts the digest
    alone."""
    return zlib.crc32(suffix.encode("utf-8", "surrogatepass"))


def compile_suffix(suffix: str) -> PredicateSpec:
    """Compile a validated ``$OP{arg}`` suffix (as ``split_predicate_suffix``
    returns it) into its spec. Raises ValueError on malformed input."""
    if not suffix.startswith("$") or not suffix.endswith("}"):
        raise ValueError(f"not a predicate suffix: {suffix!r}")
    op_name, _, arg = suffix[1:-1].partition("{")
    code = _OP_CODES.get(op_name)
    if code is None:
        raise ValueError(f"unknown predicate op: {op_name!r}")
    if op_name in PREDICATE_COMPOUND_OPS:
        tokens = split_predicate_tokens(arg)
        if not tokens:
            raise ValueError(f"malformed compound predicate: {suffix!r}")
        return PredicateSpec(op=code, children=tuple(compile_suffix(t) for t in tokens))
    if code == OP_CONTAINS:
        if not arg:
            raise ValueError("empty $CONTAINS argument")
        return PredicateSpec(op=code, text=arg.encode("utf-8"))
    if code == OP_EQS:
        field_part, sep, literal = arg.partition(":")
        if not sep:
            raise ValueError(f"malformed $EQS argument: {arg!r}")
        return PredicateSpec(op=code, field=field_part, text=literal.encode("utf-8"))
    field_part, _, num = arg.rpartition(":")
    if op_name in PREDICATE_AGG_OPS:
        window = int(num)
        if window < 1:
            raise ValueError(f"aggregation window must be >= 1: {suffix!r}")
        return PredicateSpec(op=code, field=field_part, window=window)
    if op_name not in PREDICATE_NUMERIC_OPS:  # pragma: no cover - the map is total
        raise ValueError(f"unhandled predicate op: {op_name!r}")
    value = float(num)
    if math.isnan(value):
        raise ValueError("nan threshold")
    return PredicateSpec(op=code, field=field_part, value=value)


# -- payload features (once per publish, on the host) ----------------------

_NOT_JSON = object()  # sentinel: the payload parsed and is not a JSON object


def _parse(payload: bytes) -> Any:
    try:
        return json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        return _NOT_JSON


def _field_value(doc: Any, field: str) -> Any:
    """``doc[field]``; a dotted field walks nested objects unless the
    dotted string is itself a key (the flat key wins)."""
    v = doc.get(field)
    if v is None and "." in field and field not in doc:
        v = doc
        for seg in field.split("."):
            if not isinstance(v, dict):
                return None
            v = v.get(seg)
    return v


def payload_number(payload: bytes, field: str, doc: Any = None) -> float:
    """The numeric feature ``field`` of a payload; NaN when there is none
    (skip-to-pass upstream). ``field=""`` reads the whole payload as one
    number. ``doc`` is an optional pre-parsed JSON document, so a publish
    with several field rules parses once."""
    if field == "":
        try:
            return float(payload)
        except ValueError:
            return math.nan
    if doc is None:
        doc = _parse(payload)
    if not isinstance(doc, dict):
        return math.nan
    v = _field_value(doc, field)
    # bool is an int subclass: True > 0.5 would be a surprising predicate
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return math.nan


def payload_string(payload: bytes, field: str, doc: Any = None) -> Optional[str]:
    """The STRING feature ``field`` of a JSON payload; None when there is
    none (skip-to-pass upstream)."""
    if doc is None:
        doc = _parse(payload)
    if not isinstance(doc, dict):
        return None
    v = _field_value(doc, field)
    return v if isinstance(v, str) else None


def eval_equals(payload: bytes, field: str, text: bytes, doc: Any = None) -> bool:
    """The $EQS verdict. ``field=""`` compares the whole payload; a
    missing or non-string field passes (skip-to-pass)."""
    if field == "":
        return payload == text
    v = payload_string(payload, field, doc)
    if v is None:
        return True
    return v.encode("utf-8") == text


def eval_rule_host(spec: PredicateSpec, payload: bytes, doc: Any = None) -> bool:
    """The host predicate interpreter: the oracle of the device verdicts.
    Numeric comparisons coerce both sides to float32, as the card does.
    Compounds recurse over their members with one shared JSON parse."""
    if spec.children:
        if doc is None and any(c.field for c in spec.children):
            doc = _parse(payload)
        verdicts = (eval_rule_host(c, payload, doc) for c in spec.children)
        return all(verdicts) if spec.op == OP_AND else any(verdicts)
    if spec.op == OP_CONTAINS:
        return spec.text in payload
    if spec.op == OP_EQS:
        return eval_equals(payload, spec.field, spec.text, doc)
    v = payload_number(payload, spec.field, doc)
    if math.isnan(v):
        return True  # skip-to-pass
    v32 = np.float32(v)
    t32 = np.float32(spec.value)
    if spec.op == OP_GT:
        return bool(v32 > t32)
    if spec.op == OP_GTE:
        return bool(v32 >= t32)
    if spec.op == OP_LT:
        return bool(v32 < t32)
    if spec.op == OP_LTE:
        return bool(v32 <= t32)
    if spec.op == OP_EQ:
        return bool(v32 == t32)
    return bool(v32 != t32)  # OP_NE


class PublishFeatures:
    """One publish's payload features, carried through the stage: built
    by ``PredicateEngine.features_for``; the stage batches the vectors to
    the card and attaches the resolved pass-bit row back here, where the
    fan-out's ``apply`` finds it."""

    __slots__ = ("payload", "fvec", "cmask", "version", "device_row", "row_gen")

    def __init__(self, payload: bytes, fvec: np.ndarray, cmask: np.ndarray, version: int) -> None:
        self.payload = payload
        self.fvec = fvec  # float32 [n_slots]
        self.cmask = cmask  # uint32 [n_contains_words]
        self.version = version  # registry generation the vectors match
        self.device_row: Optional[np.ndarray] = None  # uint32 pass bits
        self.row_gen = -1  # table generation of device_row


@dataclass
class CompiledRule:
    """One interned predicate: spec, registry bookkeeping, and its dense
    row in the current device table (-1 = host-only).

    ``idx`` is meaningful only with ``idx_gen``, the table generation it
    was assigned at: a row decodes through ``idx`` only when its
    generation equals ``idx_gen`` (a rebuild clears ``idx_gen`` before it
    moves ``idx``)."""

    spec: PredicateSpec
    slot: int = -1  # field slot in the feature vector (-1: CONTAINS/EQS)
    cbit: int = -1  # verdict bitmask bit (-1: numeric/agg/compound)
    refs: int = 0  # live subscriptions referencing this rule
    idx: int = -1  # dense row in the device table (valid per idx_gen)
    idx_gen: int = -1  # table generation idx belongs to
    device: bool = True  # eligible for the device table at all
    children: tuple = ()  # member suffixes (compounds)


class _AggWindow:
    """One (rule, subscriber) aggregation accumulator. Small windows keep
    O(1) state; windows of at least ``DEVICE_AGG_MIN_WINDOW`` samples
    buffer the samples, and the completed buffers of one fan-out tick
    reduce in one launch (``ops/predicates.agg_reduce``)."""

    __slots__ = ("count", "total", "best", "values")

    def __init__(self, buffered: bool = False) -> None:
        self.count = 0
        self.total = 0.0
        self.best = math.nan
        self.values: Optional[list[float]] = [] if buffered else None

    def add(self, op: int, v: float) -> None:
        self.count += 1
        if self.values is not None:
            self.values.append(v)
            return
        self.total += v
        if math.isnan(self.best):
            self.best = v
        elif op == OP_MAX:
            self.best = max(self.best, v)
        elif op == OP_MIN:
            self.best = min(self.best, v)

    def emit(self, op: int) -> float:
        assert self.values is None  # buffered windows drain via take_values
        value = self.total / self.count if op == OP_MEAN else self.best
        self.count = 0
        self.total = 0.0
        self.best = math.nan
        return value

    def take_values(self) -> list[float]:
        """Drain the buffered samples (buffered windows only)."""
        assert self.values is not None
        vals = self.values
        self.values = []
        self.count = 0
        return vals


def host_reduce_window(op: int, values: list[float]) -> float:
    """The host window reduction: the oracle of ``agg_reduce``. MAX/MIN
    reduce float32-coerced samples (bit-identical to the card); MEAN
    accumulates in float64 (the card in float32: the oracle compares
    within a relative tolerance)."""
    if op == OP_MEAN:
        return sum(values) / len(values)
    vals32 = [float(np.float32(v)) for v in values]
    return max(vals32) if op == OP_MAX else min(vals32)


def _format_agg(value: float) -> bytes:
    """One aggregate emission's payload (ASCII decimal)."""
    return b"%.10g" % value


class PredicateEngine:
    """The predicate plane: suffix registry, feature extraction, batched
    evaluation on the card, result-set filtering, aggregation windows,
    and the sampled oracle.

    ``device`` is where the rule table lives and the kernels run:
    ``"cuda"`` by default (raises where there is no card), ``"cpu"`` for
    the plain PyTorch versions. Registry mutation takes ``_lock`` (the
    lock plane's ``predicate_rules``); the publish path reads interned
    rules without it. ``registry`` (a ``telemetry.MetricsRegistry``)
    receives the engine's ``mqtt_tpu_predicate_*`` families."""

    def __init__(
        self,
        max_rules: int = 1 << 20,
        oracle_sample: int = 64,
        device="cuda",
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.max_rules = max(1, max_rules)
        self.oracle_sample = max(0, oracle_sample)
        self._lock = InstrumentedLock("predicate_rules")
        self._rules: dict[str, CompiledRule] = {}
        self._fields: dict[str, int] = {}  # field name -> feature slot
        # ONE bit space for CONTAINS substrings and EQS (field, literal)
        # pairs; bits stay put until the whole rule set drains
        self._contains: dict[bytes, int] = {}
        self._equals: dict[tuple[str, bytes], int] = {}
        self._gen = 0  # bumped on every registry mutation
        self._table_gen = -1  # generation the device table was built at
        self._evaluator = None  # ops/predicates.DeviceRuleEvaluator, built lazily
        # False: rules and windows are evaluated by the host, a route the
        # caller chose (set_device_enabled); a kernel fault still raises
        self._device_enabled = True
        # features_for's layout snapshot: (gen, fields, contains,
        # {field: {literal: bit}}, n_bits)
        self._layout: Optional[tuple] = None
        # aggregation windows: (suffix, subscriber key) -> accumulator;
        # touched only on the fan-out path
        self._agg: dict[tuple[str, str], _AggWindow] = {}
        self.device_evals = 0  # rule evaluations on the card
        self.host_evals = 0  # rule evaluations by the host interpreter
        self.device_decisions = 0  # verdicts taken from device bits
        self.filtered = 0  # deliveries suppressed by a failing predicate
        self.deliveries = 0  # predicated deliveries that passed
        self.agg_emits = 0  # synthesized aggregate publishes
        self.agg_device_reductions = 0  # windows reduced on the card
        self.oracle_checks = 0
        self.oracle_mismatches = 0
        self.device_batches = 0
        self.stale_rows = 0  # feature rows of an older generation, kept off the card
        # host decisions by the reason the JAX package routes them there:
        # no_row (the publish carried no device row), host_only (a rule
        # past max_rules), stale_generation (row and rule index of
        # different tables), released (a compound member released in
        # flight), compound (a compound combined from its members' bits),
        # agg_small_window / agg_small_tick (windows reduced on the host)
        self.host_reasons: dict[str, int] = {}
        self._apply_seq = 0  # oracle sampling clock (1-in-N publishes)
        if registry is not None:
            self._register_metrics(registry)

    def _host(self, reason: str, n: int = 1) -> None:
        self.host_reasons[reason] = self.host_reasons.get(reason, 0) + n

    # -- registry ----------------------------------------------------------

    @property
    def rule_count(self) -> int:
        return len(self._rules)

    @property
    def active(self) -> bool:
        """Any live rules at all? False keeps every publish path at one
        attribute read."""
        return bool(self._rules)

    @property
    def generation(self) -> int:
        return self._gen

    def parse_subscribe(self, filter: str) -> tuple[str, tuple]:
        """Split and register a SUBSCRIBE filter's predicate: returns
        ``(base_filter, predicates)``, with () for a plain subscription."""
        base, suffix = split_predicate_suffix(filter)
        if not suffix:
            return filter, ()
        self.register(suffix)
        return base, (suffix,)

    def register(self, suffix: str) -> CompiledRule:
        """Intern one predicate suffix (refcounted)."""
        with self._lock:
            return self._register_locked(suffix)

    def _register_locked(self, suffix: str) -> CompiledRule:
        rule = self._rules.get(suffix)
        if rule is not None:
            rule.refs += 1
            return rule
        spec = compile_suffix(suffix)
        rule = CompiledRule(spec=spec, refs=1)
        if spec.children:
            # each member interns as its own device-eligible rule holding
            # one parent reference; the compound itself has no table row
            _op_name, _, arg = suffix[1:-1].partition("{")
            tokens = split_predicate_tokens(arg)
            for t in tokens:
                self._register_locked(t)
            rule.children = tokens
        elif spec.op == OP_CONTAINS:
            bit = self._contains.get(spec.text)
            if bit is None:
                bit = self._contains[spec.text] = len(self._contains) + len(self._equals)
            rule.cbit = bit
        elif spec.op == OP_EQS:
            key = (spec.field, spec.text)
            bit = self._equals.get(key)
            if bit is None:
                bit = self._equals[key] = len(self._contains) + len(self._equals)
            rule.cbit = bit
        else:
            slot = self._fields.get(spec.field)
            if slot is None:
                slot = self._fields[spec.field] = len(self._fields)
            rule.slot = slot
        # aggregation is host state, compounds combine on the host, and
        # rules past the table cap stay host-interpreted
        rule.device = not spec.is_agg and not spec.children and len(self._rules) < self.max_rules
        self._rules[suffix] = rule
        self._gen += 1
        return rule

    def release(self, predicates: tuple) -> None:
        """Drop one reference per suffix (unsubscribe / replace)."""
        if not predicates:
            return
        with self._lock:
            for suffix in predicates:
                self._release_locked(suffix)
            if not self._rules:
                self._fields.clear()
                self._contains.clear()
                self._equals.clear()
                self._agg.clear()

    def _release_locked(self, suffix: str) -> None:
        rule = self._rules.get(suffix)
        if rule is None:
            return
        rule.refs -= 1
        if rule.refs <= 0:
            del self._rules[suffix]
            self._gen += 1
            for child in rule.children:
                self._release_locked(child)
            # slots and bits stay put: vectors keep their indices, and the
            # widths reset only when the whole rule set drains

    # -- feature extraction ------------------------------------------------

    def _feature_layout(self) -> tuple:
        """The registry's field slots, substrings and string equalities
        at one generation, with the equalities grouped by field (one
        string lookup per field, not one per literal)."""
        lay = self._layout
        if lay is not None and lay[0] == self._gen:
            return lay
        with self._lock:
            by_field: dict[str, dict[bytes, int]] = {}
            for (field, text), bit in self._equals.items():
                by_field.setdefault(field, {})[text] = bit
            lay = (
                self._gen,
                list(self._fields.items()),
                list(self._contains.items()),
                by_field,
                len(self._contains) + len(self._equals),
            )
            self._layout = lay
        return lay

    def features_for(self, payload: bytes) -> PublishFeatures:
        """One publish's payload features, parsed ONCE: the float32 field
        vector and the verdict bitmask, stamped with the registry
        generation of their layout."""
        gen, fields, contains, by_field, n_bits = self._feature_layout()
        fvec = np.empty(max(1, len(fields)), dtype=np.float32)
        doc: Any = None
        if any(name != "" for name, _ in fields) or any(f != "" for f in by_field):
            doc = _parse(payload)
        for name, slot in fields:
            fvec[slot] = np.float32(payload_number(payload, name, doc))
        mask = np.zeros(max(1, (n_bits + 31) // 32), dtype=np.uint32)
        for text, bit in contains:
            if text in payload:
                mask[bit >> 5] |= np.uint32(1 << (bit & 31))
        for field, lits in by_field.items():
            if field == "":
                hit = lits.get(bytes(payload))
                bits = () if hit is None else (hit,)
            else:
                v = payload_string(payload, field, doc)
                if v is None:
                    bits = lits.values()  # skip-to-pass: every literal passes
                else:
                    hit = lits.get(v.encode("utf-8"))
                    bits = () if hit is None else (hit,)
            for bit in bits:
                mask[bit >> 5] |= np.uint32(1 << (bit & 31))
        return PublishFeatures(payload, fvec, mask, gen)

    # -- device evaluation (rides the staged batch) ------------------------

    def _device_rules(self) -> list[CompiledRule]:
        return [r for r in list(self._rules.values()) if r.device]

    def _rebuild_evaluator(self) -> None:
        """(Re)compile the live rule set into the device table. Dense
        indices are assigned here and stamped with the generation, so a
        pass-bit row is never decoded against another table's layout."""
        from .ops.predicates import DeviceRuleEvaluator

        gen = self._gen
        rules = self._device_rules()
        for i, rule in enumerate(rules):
            rule.idx_gen = -1  # invalidate, then move
            rule.idx = i
        if self._evaluator is None:
            self._evaluator = DeviceRuleEvaluator(self.device)
        self._evaluator.rebuild(
            [r.spec for r in rules],
            [r.slot for r in rules],
            [r.cbit for r in rules],
            n_slots=max(1, len(self._fields)),
            n_cwords=max(1, (len(self._contains) + len(self._equals) + 31) // 32),
        )
        self._table_gen = gen
        for rule in rules:
            rule.idx_gen = gen

    def set_device_enabled(self, enabled: bool) -> None:
        """Route rule evaluation and window reductions to the card (True,
        the default) or to the host interpreter (False), at the points
        where the JAX engine reads the same switch."""
        self._device_enabled = enabled

    def eval_batch_async(self, feats_list: list) -> Optional[Callable]:
        """Issue ONE device evaluation for a staged batch's features.
        Returns a zero-arg resolver yielding ``(rows, eligible, gen)``
        (``rows`` uint32 ``[B, R_padded/32]``), or None when there is no
        device work: no feature rows, no device rules, or only rows of an
        older generation. A failed launch or copy raises."""
        live = [f for f in feats_list if f is not None]
        if not self._device_enabled or not live or not any(r.device for r in list(self._rules.values())):
            return None
        gen_now = self._gen
        if not any(f.version == gen_now for f in live):
            self.stale_rows += len(live)
            return None
        with self._lock:
            if self._table_gen != self._gen:
                self._rebuild_evaluator()
            evaluator = self._evaluator
            gen = self._table_gen
            table = evaluator.table if evaluator is not None else None
        if table is None:
            return None  # every device rule was released in between
        B = len(feats_list)
        F = np.zeros((B, table.n_slots), dtype=np.float32)
        M = np.zeros((B, table.n_cwords), dtype=np.uint32)
        eligible = []
        for i, f in enumerate(feats_list):
            if f is None:
                continue
            if f.version != gen:
                # built against another registry layout: the host decides
                self.stale_rows += 1
                continue
            k = min(table.n_slots, f.fvec.shape[0])
            F[i, :k] = f.fvec[:k]
            k = min(table.n_cwords, f.cmask.shape[0])
            M[i, :k] = f.cmask[:k]
            eligible.append(i)
        if not eligible:
            return None
        resolver = evaluator.eval_async(F, M, table)
        n_rules = table.n_rules

        def resolve() -> tuple:
            rows = resolver()
            self.device_batches += 1
            self.device_evals += len(eligible) * n_rules
            return rows, eligible, gen

        return resolve

    def attach_rows(self, feats_list: list, resolved: Optional[tuple]) -> None:
        """Stamp resolved pass-bit rows onto their feature carriers (the
        stage's drain leg, before the futures complete)."""
        if resolved is None:
            return
        rows, eligible, gen = resolved
        for i in eligible:
            f = feats_list[i]
            if f is not None:
                f.device_row = rows[i]
                f.row_gen = gen

    # -- delivery filtering (the fan-out choke point) ----------------------

    @staticmethod
    def _doc(payload: bytes, memo: list) -> Any:
        """The publish's parsed JSON document, parsed at most once."""
        if memo[0] is None:
            memo[0] = _parse(payload)
        return memo[0]

    def _rule_passes(self, rule: CompiledRule, payload: bytes, feats, oracle: bool, memo: list) -> bool:
        spec = rule.spec
        if rule.children:
            # a compound combines its members' verdicts on the host; each
            # member rides the device row when one is attached
            self._host("compound")
            verdicts = []
            for sfx, cspec in zip(rule.children, spec.children):
                crule = self._rules.get(sfx)
                if crule is not None:
                    verdicts.append(self._rule_passes(crule, payload, feats, oracle, memo))
                else:
                    # member released in flight: evaluate its spec directly
                    self.host_evals += 1
                    self._host("released")
                    verdicts.append(eval_rule_host(
                        cspec, payload, self._doc(payload, memo) if cspec.field else None
                    ))
            return all(verdicts) if spec.op == OP_AND else any(verdicts)
        # read idx BEFORE idx_gen (a rebuild clears idx_gen first)
        idx = rule.idx
        row = feats.device_row if feats is not None else None
        if row is not None and idx >= 0 and rule.idx_gen == feats.row_gen:
            bit = bool((row[idx >> 5] >> np.uint32(idx & 31)) & 1)
            self.device_decisions += 1
            if oracle:
                self.oracle_checks += 1
                want = eval_rule_host(spec, payload, self._doc(payload, memo) if spec.field else None)
                if want != bit:
                    self.oracle_mismatches += 1
                    _log.warning(
                        "predicate oracle mismatch: device=%s host=%s op=%d field=%r value=%r "
                        "payload[:64]=%r", bit, want, spec.op, spec.field, spec.value, payload[:64],
                    )
                    return want  # the host interpreter is ground truth
            return bit
        self.host_evals += 1
        if row is None:
            self._host("no_row")
        elif not rule.device:
            self._host("host_only")
        else:
            self._host("stale_generation")
        return eval_rule_host(spec, payload, self._doc(payload, memo) if spec.field else None)

    def _decide(self, predicates: tuple, payload: bytes, feats, agg_key: str, oracle: bool,
                memo: list) -> tuple[bool, list, list]:
        """One subscriber's verdict: ``(deliver_raw, emissions, pending)``
        with emissions the (suffix, value) completions of O(1) windows and
        pending the ``(op, values)`` completions of buffered windows. OR
        across the subscriber's predicates; aggregation rules withhold raw
        delivery and accumulate instead."""
        deliver = False
        saw_filter = False
        emissions: list = []
        pending: list = []
        for suffix in predicates:
            rule = self._rules.get(suffix)
            if rule is None:
                # released in flight: fail open, like an unpredicated one
                deliver = True
                saw_filter = True
                continue
            spec = rule.spec
            if spec.is_agg:
                v = payload_number(payload, spec.field, self._doc(payload, memo) if spec.field else None)
                if not math.isnan(v):
                    win = self._agg.get((suffix, agg_key))
                    if win is None:
                        buffered = spec.window >= DEVICE_AGG_MIN_WINDOW and self._device_enabled
                        win = self._agg[(suffix, agg_key)] = _AggWindow(buffered)
                    win.add(spec.op, v)
                    if win.count >= spec.window:
                        if win.values is not None:
                            pending.append((spec.op, win.take_values()))
                        else:
                            self._host("agg_small_window")
                            emissions.append((suffix, win.emit(spec.op)))
                continue
            saw_filter = True
            if not deliver and self._rule_passes(rule, payload, feats, oracle, memo):
                deliver = True
        # an aggregation-only subscription receives only the aggregates
        return deliver if saw_filter else False, emissions, pending

    def _filter_group(self, members: dict, payload: bytes, feats, key_of, kind: str,
                      oracle: bool, memo: list, emissions: list, agg_pending: list) -> None:
        """Apply the predicates of one container of subscriptions in place."""
        drop = []
        for key, sub in members.items():
            if not sub.predicates:
                continue
            deliver, emits, pend = self._decide(sub.predicates, payload, feats, key_of(key), oracle, memo)
            target = sub if kind == "inline" else key
            for _suffix, value in emits:
                emissions.append((kind, target, sub, _format_agg(value)))
            for op, values in pend:
                agg_pending.append((kind, target, sub, op, values))
            if deliver:
                self.deliveries += 1
            else:
                drop.append(key)
        if drop:
            self.filtered += len(drop)
            for key in drop:
                del members[key]

    def apply(self, subs: Subscribers, payload: bytes, feats=None) -> tuple[Subscribers, list]:
        """Filter one publish's matched subscriber set in place and collect
        the aggregate emissions: ``(subs, emissions)`` with emissions as
        ``(kind, target, sub, payload)`` ("client": target is a client
        id; "inline": target is the InlineSubscription). Unpredicated
        subscriptions are untouched."""
        self._apply_seq += 1
        oracle = self.oracle_sample > 0 and self._apply_seq % self.oracle_sample == 0
        memo: list = [None]
        emissions: list = []
        agg_pending: list = []
        self._filter_group(subs.subscriptions, payload, feats, lambda cid: cid, "client",
                           oracle, memo, emissions, agg_pending)
        # shared groups: drop failing members BEFORE group selection, so a
        # passing member is picked when there is one
        if subs.shared:
            for gfilter in list(subs.shared):
                members = subs.shared[gfilter]
                self._filter_group(members, payload, feats, lambda _cid, g=gfilter: "$share:" + g,
                                   "client", oracle, memo, emissions, agg_pending)
                if not members:
                    del subs.shared[gfilter]
        if subs.inline_subscriptions:
            self._filter_group(subs.inline_subscriptions, payload, feats, lambda iid: f"$inline:{iid}",
                               "inline", oracle, memo, emissions, agg_pending)
        if agg_pending:
            self._flush_agg(agg_pending, emissions, oracle)
        if emissions:
            self.agg_emits += len(emissions)
        return subs, emissions

    def _flush_agg(self, agg_pending: list, emissions: list, oracle: bool) -> None:
        """Reduce the buffered windows this fan-out tick completed in ONE
        launch (when there are at least ``DEVICE_AGG_MIN_BATCH`` of them;
        fewer reduce on the host, counted) and append the emissions."""
        values_out = None
        if len(agg_pending) >= DEVICE_AGG_MIN_BATCH and self._device_enabled:
            from .ops.predicates import agg_reduce_batch

            values_out = agg_reduce_batch(
                [(op, values) for _k, _t, _s, op, values in agg_pending], self.device
            )
            self.agg_device_reductions += len(agg_pending)
            if oracle:
                # MAX/MIN bit-identical, MEAN within float32 accumulation
                for got, (_k, _t, _s, op, values) in zip(values_out, agg_pending):
                    self.oracle_checks += 1
                    want = host_reduce_window(op, values)
                    tol = 1e-5 * max(1.0, abs(want)) if op == OP_MEAN else 0.0
                    if abs(float(got) - want) > tol:
                        self.oracle_mismatches += 1
                        _log.warning("window-reduction oracle mismatch: device=%r host=%r op=%d n=%d",
                                     float(got), want, op, len(values))
        else:
            self._host("agg_small_tick", len(agg_pending))
        for i, (kind, target, sub, op, values) in enumerate(agg_pending):
            value = float(values_out[i]) if values_out is not None else host_reduce_window(op, values)
            emissions.append((kind, target, sub, _format_agg(value)))

    def passes_retained(self, sub, payload: bytes) -> bool:
        """Gate one retained message against a fresh subscription's
        predicates: filter rules apply; an aggregation-only subscription
        receives no retained messages."""
        preds = sub.predicates
        if not preds:
            return True
        deliver = False
        saw_filter = False
        memo: list = [None]
        for suffix in preds:
            rule = self._rules.get(suffix)
            if rule is None:
                return True
            spec = rule.spec
            if spec.is_agg:
                continue
            saw_filter = True
            self.host_evals += 1
            if eval_rule_host(spec, payload, self._doc(payload, memo) if spec.field else None):
                deliver = True
        return deliver if saw_filter else False

    # -- observability -----------------------------------------------------

    def filtered_ratio(self) -> float:
        total = self.filtered + self.deliveries
        return self.filtered / total if total else 0.0

    def gauges(self) -> dict:
        """The ``$SYS/broker/predicates/*`` tree (the JAX engine's, without
        the breaker state, plus the host decisions by reason)."""
        return {
            "rules": len(self._rules),
            "device_rules": sum(1 for r in list(self._rules.values()) if r.device),
            "fields": len(self._fields),
            "contains": len(self._contains),
            "equals": len(self._equals),
            "device_evals": self.device_evals,
            "device_batches": self.device_batches,
            "device_decisions": self.device_decisions,
            "host_evals": self.host_evals,
            "filtered": self.filtered,
            "deliveries": self.deliveries,
            "filtered_ratio": round(self.filtered_ratio(), 6),
            "agg_emits": self.agg_emits,
            "agg_windows": len(self._agg),
            "agg_device_reductions": self.agg_device_reductions,
            "oracle_checks": self.oracle_checks,
            "oracle_mismatches": self.oracle_mismatches,
            "stale_rows": self.stale_rows,
            "host_reasons": dict(self.host_reasons),
        }

    def _register_metrics(self, registry: MetricsRegistry) -> None:
        """The JAX engine's Prometheus families, without its device-error
        counter: here a failed launch raises."""
        registry.gauge(
            "mqtt_tpu_predicate_rules",
            "Live interned payload-predicate rules",
            fn=lambda: len(self._rules),
        )
        for name, attr in (
            ("mqtt_tpu_predicate_evals_total", "device_evals"),
            ("mqtt_tpu_predicate_host_evals_total", "host_evals"),
            ("mqtt_tpu_predicate_filtered_total", "filtered"),
            ("mqtt_tpu_predicate_deliveries_total", "deliveries"),
            ("mqtt_tpu_predicate_agg_emits_total", "agg_emits"),
            (
                "mqtt_tpu_predicate_agg_device_reductions_total",
                "agg_device_reductions",
            ),
            ("mqtt_tpu_predicate_oracle_checks_total", "oracle_checks"),
            ("mqtt_tpu_predicate_oracle_mismatches_total", "oracle_mismatches"),
        ):
            registry.counter(
                name,
                f"PredicateEngine.{attr}",
                fn=lambda a=attr: getattr(self, a),
            )
        registry.gauge(
            "mqtt_tpu_predicate_filtered_ratio",
            "Predicated deliveries suppressed / decided (selectivity)",
            fn=self.filtered_ratio,
        )
