"""Declarative SLO engine: multi-window burn rates over the broker's
own telemetry registry.

A copy of the JAX package's ``mqtt_tpu/slo.py``. Gauge objectives read
the port's device families: ``hbm ratio`` samples
``mqtt_tpu_device_hbm_ratio``, the caching allocator's live bytes over
the card's total (``ops.devicestats``).

Operators state objectives in a one-line grammar (``Options.
slo_objectives``)::

    p99 delivery < 50ms over 5m          # latency objective
    p99 delivery{tenant=acme} < 20ms over 5m/1h
    shed ratio < 0.1% over 5m            # event-ratio objective
    messages_dropped/messages_received ratio < 0.5%
    shard skew < 2.0 over 5m             # gauge objective
    hbm ratio < 0.9 over 5m              # device HBM watermark

and the engine evaluates each as a MULTI-WINDOW BURN RATE (the SRE
workbook shape): the burn rate is ``bad-event fraction / allowed
fraction`` over a window, and an objective breaches only when BOTH the
fast window (default 5m — catches the storm) and the slow window
(default 12x fast — proves it is sustained, not a blip) burn above
``Options.slo_burn_threshold``. Recovery needs only the fast window to
cool, so a breach clears as soon as the bleeding actually stops.

Sources are the registry's OWN metrics — no second bookkeeping path:

- latency objectives walk a histogram family's labeled children (by
  default ``mqtt_tpu_delivery_latency_seconds``, the per-tenant
  delivery SLI); "bad" = observations past the threshold, resolved at
  bucket granularity with the threshold snapped DOWN one bucket so the
  gate alarms early, never late (telemetry.Histogram.count_le);
- ratio objectives diff two counter families (numerator = bad events,
  denominator = total events), summed across their children;
- gauge objectives (the device plane) sample a gauge family each
  evaluation tick — the worst (max) child, so a per-device family
  breaches on its hottest chip — counting a tick as "bad" when the
  value exceeds the threshold. Events are TICKS: the burn windows then
  measure the fraction of recent time the gauge spent past the line
  against a ``GAUGE_BUDGET`` (10%) allowance, which plugs straight into
  the multi-window machinery below.

Each evaluation tick snapshots cumulative totals into a bounded ring;
window deltas come from the ring, so restarts/counter resets clamp to
zero instead of going negative. Breach transitions publish a retained
``$SYS/broker/slo/<name>`` message (both directions), entry fires the
flight-recorder dump path (traces + profile + flight in one bundle —
telemetry.trigger_dump), and every objective exports
``mqtt_tpu_slo_{burn_rate,budget_remaining,breached}`` gauges that ride
mesh metric federation to GET /cluster/slo at the tree root.

The engine is loop-affine: ``evaluate()`` runs on the server's
housekeeping tick (1s), walks a handful of histogram children, and
takes no locks beyond the registry's own family-map probe.
"""

from __future__ import annotations

import logging
import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

_log = logging.getLogger("mqtt_tpu_torch.slo")

# the default latency SLI family the bare word "delivery" resolves to
DELIVERY_FAMILY = "mqtt_tpu_delivery_latency_seconds"

# named latency SLIs: bare word -> histogram family
LATENCY_SLIS = {
    "delivery": DELIVERY_FAMILY,
    "stage": "mqtt_tpu_publish_stage_seconds",
    "queue_wait": "mqtt_tpu_outbound_queue_wait_seconds",
}

# named ratio SLIs: bare word -> (numerator family, denominator family)
RATIO_SLIS = {
    "shed": ("mqtt_tpu_messages_dropped_total", "mqtt_tpu_messages_received_total"),
    "fallback": ("mqtt_tpu_stage_fallback_total", "mqtt_tpu_matcher_topics_total"),
    # scenario-lab oracles (scenarios): the runner registers
    # these counters around each drill so the gate is the SLO engine,
    # not harness asserts
    "scenario_gap": (
        "mqtt_tpu_scenario_gaps_total",
        "mqtt_tpu_scenario_expected_total",
    ),
    "scenario_dup": (
        "mqtt_tpu_scenario_duplicates_total",
        "mqtt_tpu_scenario_expected_total",
    ),
    # live tenant re-key: deliveries sealed with a retired epoch key /
    # all sealed fan-outs (must hold at zero after retirement)
    "rekey_stale": (
        "mqtt_tpu_recrypt_epoch_stale_drops_total",
        "mqtt_tpu_recrypt_fanouts_total",
    ),
}

# named gauge SLIs: phrase -> gauge family; the
# engine samples the family's WORST (max) child each tick
GAUGE_SLIS = {
    "shard skew": "mqtt_tpu_device_skew_ratio",
    "hbm ratio": "mqtt_tpu_device_hbm_ratio",
}

# allowed fraction of evaluation ticks a gauge may spend past its
# threshold before the burn rate reads 1.0
GAUGE_BUDGET = 0.1

DEFAULT_FAST_S = 300.0  # 5m fast window
SLOW_FACTOR = 12.0  # slow window = 12x fast (5m -> 1h) unless spelled out

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)$")
_DUR_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}

_LATENCY_RE = re.compile(
    r"^p(?P<q>\d{1,2}(?:\.\d+)?)\s+(?P<sli>[a-z_][a-z0-9_]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s*<\s*(?P<num>\d+(?:\.\d+)?)(?P<unit>us|ms|s)"
    r"(?:\s+over\s+(?P<win>\S+))?$"
)
_RATIO_RE = re.compile(
    r"^(?P<sli>[a-z_][a-z0-9_/]*)\s+ratio"
    r"\s*<\s*(?P<num>\d+(?:\.\d+)?)%"
    r"(?:\s+over\s+(?P<win>\S+))?$"
)
# tried LAST: a bare unitless comparison ("shard skew < 2.0 over 5m",
# "hbm ratio < 0.9") — multi-word phrases resolve through GAUGE_SLIS,
# single words fall back to a gauge family name
_GAUGE_RE = re.compile(
    r"^(?P<sli>[a-z_][a-z0-9_]*(?: [a-z0-9_]+)*)"
    r"\s*<\s*(?P<num>\d+(?:\.\d+)?)"
    r"(?:\s+over\s+(?P<win>\S+))?$"
)


class ObjectiveError(ValueError):
    """A spec the grammar cannot parse (parse_objectives logs and skips
    these so a config typo degrades one objective, never the broker)."""


@dataclass
class Objective:
    """One parsed objective. ``budget`` is the allowed bad-event
    fraction (p99 -> 0.01; a 0.1% ratio -> 0.001)."""

    name: str
    spec: str
    kind: str  # "latency" | "ratio" | "gauge"
    budget: float
    fast_s: float = DEFAULT_FAST_S
    slow_s: float = DEFAULT_FAST_S * SLOW_FACTOR
    # latency objectives; gauge objectives reuse both fields (family =
    # the sampled gauge family, threshold_s = the UNITLESS threshold)
    family: str = ""
    threshold_s: float = 0.0
    labels: dict = field(default_factory=dict)
    # ratio objectives
    numerator: str = ""
    denominator: str = ""


def _parse_duration(tok: str) -> float:
    m = _DUR_RE.match(tok)
    if m is None:
        raise ObjectiveError(f"bad duration {tok!r} (want e.g. 30s, 5m, 1h)")
    return float(m.group(1)) * _DUR_UNITS[m.group(2)]


def _parse_windows(tok: Optional[str]) -> tuple[float, float]:
    """``5m`` or ``5m/1h`` -> (fast_s, slow_s); the slow window defaults
    to SLOW_FACTOR x fast and is floored at the fast window."""
    if not tok:
        return DEFAULT_FAST_S, DEFAULT_FAST_S * SLOW_FACTOR
    fast_tok, _, slow_tok = tok.partition("/")
    fast = _parse_duration(fast_tok)
    slow = _parse_duration(slow_tok) if slow_tok else fast * SLOW_FACTOR
    return fast, max(fast, slow)


def _parse_labels(tok: Optional[str]) -> dict:
    out: dict = {}
    if not tok:
        return out
    for part in tok.split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        if not eq:
            raise ObjectiveError(f"bad label filter {part!r} (want key=value)")
        out[k.strip()] = v.strip().strip('"')
    return out


def _slug(spec: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]+", "_", spec).strip("_")[:64]


def parse_objective(spec: str, name: str = "") -> Objective:
    """Parse one objective line; raises ObjectiveError on bad grammar."""
    s = " ".join(str(spec).split())
    m = _LATENCY_RE.match(s)
    if m is not None:
        q = float(m.group("q"))
        if not 0 < q < 100:
            raise ObjectiveError(f"quantile p{m.group('q')} out of range")
        sli = m.group("sli")
        family = LATENCY_SLIS.get(sli, sli)
        if not family.startswith("mqtt_tpu_"):
            family = "mqtt_tpu_" + family
        unit = {"us": 1e-6, "ms": 1e-3, "s": 1.0}[m.group("unit")]
        fast, slow = _parse_windows(m.group("win"))
        return Objective(
            name=name or _slug(s),
            spec=s,
            kind="latency",
            budget=round(1.0 - q / 100.0, 9),
            fast_s=fast,
            slow_s=slow,
            family=family,
            threshold_s=float(m.group("num")) * unit,
            labels=_parse_labels(m.group("labels")),
        )
    m = _RATIO_RE.match(s)
    if m is not None:
        sli = m.group("sli")
        if "/" in sli:
            num, _, den = sli.partition("/")
            if not (num and den):
                raise ObjectiveError(f"bad ratio sli {sli!r}")
        elif sli in RATIO_SLIS:
            num, den = RATIO_SLIS[sli]
        else:
            raise ObjectiveError(
                f"unknown ratio sli {sli!r} (known: {sorted(RATIO_SLIS)}, "
                "or spell numerator/denominator families)"
            )
        if not num.startswith("mqtt_tpu_"):
            num = "mqtt_tpu_" + num
        if not den.startswith("mqtt_tpu_"):
            den = "mqtt_tpu_" + den
        budget = float(m.group("num")) / 100.0
        if budget <= 0:
            raise ObjectiveError("ratio budget must be > 0%")
        fast, slow = _parse_windows(m.group("win"))
        return Objective(
            name=name or _slug(s),
            spec=s,
            kind="ratio",
            budget=budget,
            fast_s=fast,
            slow_s=slow,
            numerator=num,
            denominator=den,
        )
    m = _GAUGE_RE.match(s)
    if m is not None:
        sli = m.group("sli")
        family = GAUGE_SLIS.get(sli)
        if family is None:
            if " " in sli:
                raise ObjectiveError(
                    f"unknown gauge sli {sli!r} (known: {sorted(GAUGE_SLIS)})"
                )
            family = sli  # a single word names the gauge family itself
        if not family.startswith("mqtt_tpu_"):
            family = "mqtt_tpu_" + family
        fast, slow = _parse_windows(m.group("win"))
        return Objective(
            name=name or _slug(s),
            spec=s,
            kind="gauge",
            budget=GAUGE_BUDGET,
            fast_s=fast,
            slow_s=slow,
            family=family,
            threshold_s=float(m.group("num")),
        )
    raise ObjectiveError(
        f"unparseable objective {spec!r} (grammar: 'p99 delivery < 50ms "
        "over 5m', 'shed ratio < 0.1%', or 'shard skew < 2.0 over 5m')"
    )


def parse_objectives(specs) -> list[Objective]:
    """Parse a config list, SKIPPING (and logging) bad lines — an
    operator typo must degrade one objective, never abort the broker
    (the priority-class posture). Duplicate names get a suffix."""
    out: list[Objective] = []
    seen: set[str] = set()
    for spec in specs or ():
        try:
            obj = parse_objective(spec)
        except ObjectiveError as e:
            _log.warning("skipping SLO objective: %s", e)
            continue
        base, n = obj.name, 2
        while obj.name in seen:
            obj.name = f"{base}_{n}"
            n += 1
        seen.add(obj.name)
        out.append(obj)
    return out


class _Track:
    """One objective's evaluation state: the cumulative-snapshot ring
    and the current verdict."""

    __slots__ = (
        "obj", "ring", "breached", "burn_fast", "burn_slow",
        "budget_remaining", "breaches", "g_fast", "g_slow", "g_budget",
        "g_breached", "cum_total", "cum_bad", "last_value",
    )

    def __init__(self, obj: Objective) -> None:
        self.obj = obj
        # (monotonic, total_events, bad_events) cumulative snapshots
        self.ring: deque = deque()
        # gauge objectives accumulate here: every evaluation tick is an
        # event, a tick with the sampled value past the threshold is bad
        self.cum_total = 0
        self.cum_bad = 0
        self.last_value = 0.0
        self.breached = False
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.budget_remaining = 1.0
        self.breaches = 0
        self.g_fast: Any = None
        self.g_slow: Any = None
        self.g_budget: Any = None
        self.g_breached: Any = None


class SLOEngine:
    """Evaluates parsed objectives against the telemetry registry on
    the server's housekeeping tick; see the module docstring for the
    breach semantics. ``publish`` is the server's retained-$SYS
    publisher ``(topic_suffix: str, payload: dict) -> None`` — called
    only on transitions, from the evaluation (event-loop) context."""

    def __init__(
        self,
        telemetry: Any,
        objectives: list[Objective],
        burn_threshold: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        publish: Optional[Callable[[str, dict], None]] = None,
    ) -> None:
        self.telemetry = telemetry
        self.burn_threshold = max(1e-9, float(burn_threshold))
        self.clock = clock
        self.publish = publish
        self._tracks = [_Track(o) for o in objectives]
        r = telemetry.registry
        for tr in self._tracks:
            o = tr.obj
            tr.g_fast = r.gauge(
                "mqtt_tpu_slo_burn_rate",
                "Error-budget burn rate per objective and window "
                "(1.0 = burning exactly the allowed budget)",
                objective=o.name,
                window="fast",
            )
            tr.g_slow = r.gauge(
                "mqtt_tpu_slo_burn_rate",
                "",
                objective=o.name,
                window="slow",
            )
            tr.g_budget = r.gauge(
                "mqtt_tpu_slo_budget_remaining",
                "Fraction of the slow-window error budget still unspent "
                "(clamped at 0)",
                objective=o.name,
            )
            tr.g_breached = r.gauge(
                "mqtt_tpu_slo_breached",
                "1 while the objective is in breach (fast AND slow "
                "windows burning past the threshold)",
                objective=o.name,
            )
        self.breach_transitions = r.counter(
            "mqtt_tpu_slo_breaches_total",
            "Objective transitions INTO breach",
        )

    @property
    def objectives(self) -> list[Objective]:
        return [tr.obj for tr in self._tracks]

    # -- totals from the registry ------------------------------------------

    def _totals(self, tr: _Track) -> tuple[float, float]:
        """Cumulative (total events, bad events) for one objective, read
        from the registry's live children. Gauge objectives synthesize
        events from evaluation ticks: this tick is one event, bad when
        the family's worst (max) child value exceeds the threshold."""
        obj = tr.obj
        r = self.telemetry.registry
        if obj.kind == "gauge":
            worst = 0.0
            for _key, child in r.family_children(obj.family):
                value = getattr(child, "value", None)
                try:
                    v = value() if callable(value) else value
                except Exception:  # brokerlint: ok=R4 a failing gauge callback must degrade the objective sample, never the tick
                    continue
                if isinstance(v, (int, float)):
                    worst = max(worst, float(v))
            tr.last_value = worst
            tr.cum_total += 1
            if worst > obj.threshold_s:
                tr.cum_bad += 1
            return float(tr.cum_total), float(tr.cum_bad)
        if obj.kind == "latency":
            total = bad = 0.0
            want = obj.labels
            for key, child in r.family_children(obj.family):
                if want:
                    have = dict(key)
                    if any(have.get(k) != v for k, v in want.items()):
                        continue
                h = child.live() if hasattr(child, "live") else None
                if h is None:
                    continue
                total += h.count
                bad += h.count - h.count_le(obj.threshold_s)
            return total, bad
        num = den = 0.0
        for _key, child in r.family_children(obj.numerator):
            v = getattr(child, "value", None)
            if isinstance(v, (int, float)):
                num += v
        for _key, child in r.family_children(obj.denominator):
            v = getattr(child, "value", None)
            if isinstance(v, (int, float)):
                den += v
        return den, num

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _window_delta(
        ring: deque, now: float, window_s: float
    ) -> tuple[float, float]:
        """(d_total, d_bad) between the newest snapshot and the oldest
        one inside the window (a partial window uses whatever history
        exists — standard burn-rate behavior on a fresh broker).
        Deltas clamp at zero so a counter reset reads as silence, not a
        negative burn."""
        if len(ring) < 2:
            return 0.0, 0.0
        t_now, total_now, bad_now = ring[-1]
        base = None
        for t, total, bad in ring:
            if t >= now - window_s:
                base = (t, total, bad)
                break
        if base is None or base[0] >= t_now:
            return 0.0, 0.0
        return max(0.0, total_now - base[1]), max(0.0, bad_now - base[2])

    def evaluate(self, now: Optional[float] = None) -> None:
        """One evaluation tick: snapshot, compute both windows' burn,
        transition + publish + dump on edges, refresh the gauges."""
        now = self.clock() if now is None else now
        for tr in self._tracks:
            o = tr.obj
            total, bad = self._totals(tr)
            tr.ring.append((now, total, bad))
            horizon = now - o.slow_s - 2.0
            while len(tr.ring) > 2 and tr.ring[1][0] <= horizon:
                tr.ring.popleft()
            d_total_f, d_bad_f = self._window_delta(tr.ring, now, o.fast_s)
            d_total_s, d_bad_s = self._window_delta(tr.ring, now, o.slow_s)
            frac_f = d_bad_f / d_total_f if d_total_f > 0 else 0.0
            frac_s = d_bad_s / d_total_s if d_total_s > 0 else 0.0
            tr.burn_fast = frac_f / o.budget
            tr.burn_slow = frac_s / o.budget
            tr.budget_remaining = max(0.0, 1.0 - tr.burn_slow)
            was = tr.breached
            if not was:
                # entry needs BOTH windows burning: the fast window
                # catches the storm, the slow window proves it is
                # sustained spend, not one bad minute
                tr.breached = (
                    tr.burn_fast > self.burn_threshold
                    and tr.burn_slow > self.burn_threshold
                )
            else:
                # exit on the fast window alone: once the bleeding
                # stops, the slow window's memory must not pin the alert
                tr.breached = tr.burn_fast > self.burn_threshold
            tr.g_fast.set(round(tr.burn_fast, 6))
            tr.g_slow.set(round(tr.burn_slow, 6))
            tr.g_budget.set(round(tr.budget_remaining, 6))
            tr.g_breached.set(1.0 if tr.breached else 0.0)
            if tr.breached != was:
                self._transition(tr)

    def _transition(self, tr: _Track) -> None:
        o = tr.obj
        state = self._objective_state(tr)
        if tr.breached:
            tr.breaches += 1
            self.breach_transitions.inc()
            _log.warning(
                "SLO BREACH %s (%s): burn fast=%.2f slow=%.2f",
                o.name, o.spec, tr.burn_fast, tr.burn_slow,
            )
            # the one-bundle capture: flight records + trace ring +
            # profiler stacks land beside each other on disk
            self.telemetry.trigger_dump("slo_breach_" + o.name, state)
        else:
            _log.warning("SLO recovered %s (%s)", o.name, o.spec)
        if self.publish is not None:
            try:
                self.publish(o.name, state)
            except Exception:
                _log.exception("SLO transition publish failed (%s)", o.name)

    def _objective_state(self, tr: _Track) -> dict:
        o = tr.obj
        out = {
            "objective": o.name,
            "spec": o.spec,
            "kind": o.kind,
            "breached": tr.breached,
            "burn_rate_fast": round(tr.burn_fast, 6),
            "burn_rate_slow": round(tr.burn_slow, 6),
            "budget_remaining": round(tr.budget_remaining, 6),
            "budget": o.budget,
            "window_fast_s": o.fast_s,
            "window_slow_s": o.slow_s,
            "breaches": tr.breaches,
        }
        if o.kind == "gauge":
            out["value"] = round(tr.last_value, 6)
            out["threshold"] = o.threshold_s
            out["family"] = o.family
        return out

    def state(self) -> dict:
        """Objective name -> full state (GET /cluster/slo's local half
        and the transition payloads' shape)."""
        return {tr.obj.name: self._objective_state(tr) for tr in self._tracks}
