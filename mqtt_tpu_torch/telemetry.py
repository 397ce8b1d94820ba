"""The metrics core: counters, gauges and log-scale histograms in a
registry that renders the Prometheus text exposition format.

A copy of the JAX package's ``mqtt_tpu/telemetry.py`` metrics core, cut
to what the port's device plane uses: ``Histogram`` (with ``live``,
``merge`` and the percentile extraction), ``Counter``, ``Gauge`` and
``MetricsRegistry`` (children stored or backed by a scrape-time callback,
``exposition()`` and the flat ``sys_tree()``), with ``check_exposition``,
the text-format checker the tests use. Family names are the JAX
package's (``mqtt_tpu_*``), so one dashboard reads both packages; the
same observations render byte-identical text.

Not ported here: the stage clock, the flight recorder, the telemetry
facade, federation summaries and histogram exemplars (the JAX package's
``StageClock``, ``FlightRecorder``, ``Telemetry``, ``ClusterMetrics``).
"""

from __future__ import annotations

import logging
import math
import re
from bisect import bisect_left
from typing import Any, Callable, Optional

_log = logging.getLogger("mqtt_tpu_torch.telemetry")

# per-batch fill ratios (the sharded matcher's per-tile compact capacity)
FILL_BOUNDS = tuple(round(0.1 * i, 1) for i in range(1, 11))


def _fmt(v) -> str:
    """A Prometheus-compatible number: integral floats render without
    the trailing ``.0`` so counters read as counts."""
    if isinstance(v, float):
        if v == math.inf:
            return "+Inf"
        if v != v:  # NaN
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, and
    newline must be escaped inside the quoted value."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def escape_help(v: str) -> str:
    """# HELP escaping: backslash and newline only (quotes are legal)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class Histogram:
    """A fixed-bucket log-scale histogram.

    Bucket upper bounds are ``base * growth**i`` (defaults: 1us growing
    x2 for 36 buckets, topping out around 34s) plus a +Inf overflow
    bucket — Prometheus ``le`` semantics (a value equal to a boundary
    counts in that bucket). Log-scale keeps relative error bounded at
    every magnitude, which is what latency percentiles need.

    Single-writer per instance; cross-thread aggregation goes through
    ``merge`` — each thread owns a shard and the scrape merges them. A
    registry child may instead be backed by a scrape-time callback
    returning a merged snapshot (``fn``, see :meth:`live`): the sharded
    matcher's per-shard compile histograms render this way.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "fn")

    def __init__(
        self,
        base: float = 1e-6,
        growth: float = 2.0,
        n_buckets: int = 36,
        bounds: Optional[tuple] = None,
    ) -> None:
        if bounds is not None:
            self.bounds = tuple(float(b) for b in bounds)
        else:
            self.bounds = tuple(base * growth**i for i in range(n_buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # [-1] is +Inf
        self.count = 0
        self.sum = 0.0
        self.fn: Optional[Callable[[], "Histogram"]] = None

    def live(self) -> "Histogram":
        """The histogram to render at scrape time: the callback's merged
        snapshot when one is attached, else this instance. A failing
        callback renders the (empty) stored instance — a scrape must
        never take the broker down."""
        if self.fn is None:
            return self
        try:
            merged = self.fn()
        except Exception:
            _log.exception("histogram callback failed")
            return self
        return merged if isinstance(merged, Histogram) else self

    def observe(self, v: float) -> None:
        # bisect_left(bounds, v): first bound >= v — exactly `le`
        i = bisect_left(self.bounds, v)
        self.counts[i] += 1
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> float:
        """The q-quantile's bucket upper bound (0.0 when empty; the
        largest finite bound for observations past it). Rank uses the
        ceiling so a single observation answers every quantile with its
        own bucket."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]  # pragma: no cover - rank <= count

    def merge(self, other: "Histogram") -> None:
        """Fold another shard (identical bucket layout) into this one."""
        if other.bounds != self.bounds:
            raise ValueError("histogram bucket layouts differ; cannot merge")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class Counter:
    """A monotonic counter (single-writer; the GIL makes ``+=`` on the
    slot safe enough for telemetry from helper threads). Like Gauge it
    may instead be backed by a scrape-time callback — for mirroring
    counters another layer already maintains (an engine's own counts)
    without a second bookkeeping path."""

    __slots__ = ("_value", "fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._value = 0
        self.fn = fn

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self):
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:  # a scrape must not take the broker down
                _log.exception("counter callback failed")
                return 0
        return self._value


class Gauge:
    """A point-in-time value: either ``set()`` by the owner or backed by
    a zero-arg callable sampled at scrape time."""

    __slots__ = ("_value", "fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._value = v

    def value(self):
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:  # a scrape must not take the broker down
                _log.exception("gauge callback failed")
                return 0.0
        return self._value


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class _Family:
    __slots__ = ("name", "mtype", "help", "children", "maker")

    def __init__(self, name: str, mtype: str, help_: str, maker) -> None:
        self.name = name
        self.mtype = mtype
        self.help = help_
        # Counter | Gauge | Histogram, keyed on the sorted label tuple;
        # Any because the renderers isinstance-dispatch per child
        self.children: dict[tuple, Any] = {}
        self.maker = maker


class MetricsRegistry:
    """Named metric families with labeled children and two renderers:
    Prometheus text exposition and the flat ``$SYS`` topic map."""

    def __init__(self) -> None:
        # every scrape walks this lock against concurrent child
        # registration, so it is itself a measured contention point.
        # Imported here: utils/locked imports this module's Histogram
        from .utils.locked import InstrumentedLock

        self._lock = InstrumentedLock("metrics_registry")
        self._families: dict[str, _Family] = {}

    def _child(self, name: str, mtype: str, help_: str, labels: dict, maker):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, mtype, help_, maker)
            elif fam.mtype != mtype:
                raise ValueError(
                    f"metric {name!r} re-registered as {mtype} (was {fam.mtype})"
                )
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = maker()
            return child

    def counter(
        self, name: str, help: str = "", fn: Optional[Callable] = None, **labels
    ) -> Counter:
        c = self._child(name, "counter", help, labels, Counter)
        if fn is not None:
            c.fn = fn
        return c

    def gauge(
        self, name: str, help: str = "", fn: Optional[Callable] = None, **labels
    ) -> Gauge:
        g = self._child(name, "gauge", help, labels, Gauge)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(
        self,
        name: str,
        help: str = "",
        bounds: Optional[tuple] = None,
        fn: Optional[Callable] = None,
        **labels,
    ) -> Histogram:
        h = self._child(
            name, "histogram", help, labels, lambda: Histogram(bounds=bounds)
        )
        if fn is not None:
            # scrape-time snapshot callback (per-thread shard merging):
            # the renderers resolve through Histogram.live()
            h.fn = fn
        return h

    # -- rendering ---------------------------------------------------------

    @staticmethod
    def _labels_str(key: tuple, extra: str = "") -> str:
        parts = [f'{k}="{escape_label_value(v)}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def exposition(self) -> str:
        """The Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            families = sorted(self._families.items())
        out: list[str] = []
        for name, fam in families:
            if fam.help:
                out.append(f"# HELP {name} {escape_help(fam.help)}")
            out.append(f"# TYPE {name} {fam.mtype}")
            for key, child in sorted(fam.children.items()):
                if isinstance(child, Counter):
                    out.append(f"{name}{self._labels_str(key)} {_fmt(child.value)}")
                elif isinstance(child, Gauge):
                    out.append(
                        f"{name}{self._labels_str(key)} {_fmt(child.value())}"
                    )
                else:  # Histogram (callback-backed ones snapshot here)
                    child = child.live()
                    acc = 0
                    for i, bound in enumerate(child.bounds):
                        acc += child.counts[i]
                        le = self._labels_str(key, f'le="{_fmt(float(bound))}"')
                        out.append(f"{name}_bucket{le} {acc}")
                    le = self._labels_str(key, 'le="+Inf"')
                    out.append(f"{name}_bucket{le} {_fmt(child.count)}")
                    out.append(
                        f"{name}_sum{self._labels_str(key)} {_fmt(child.sum)}"
                    )
                    out.append(
                        f"{name}_count{self._labels_str(key)} {_fmt(child.count)}"
                    )
        return "\n".join(out) + "\n"

    def sys_tree(self) -> dict:
        """A flat ``topic-suffix -> value`` map for a retained
        ``$SYS/broker/telemetry/#`` tree. ``*_seconds`` histograms
        surface their percentile summary in milliseconds; dimensionless
        histograms (fill ratios) surface the raw quantile values."""
        with self._lock:
            families = sorted(self._families.items())
        out: dict[str, object] = {}
        for name, fam in families:
            short = name.removeprefix("mqtt_tpu_")
            in_seconds = name.endswith("_seconds")
            for key, child in sorted(fam.children.items()):
                suffix = "/".join(v for _, v in key)
                base = f"{short}/{suffix}" if suffix else short
                if isinstance(child, Counter):
                    out[base] = child.value
                elif isinstance(child, Gauge):
                    v = child.value()
                    out[base] = round(v, 6) if isinstance(v, float) else v
                else:
                    s = child.live().summary()
                    out[f"{base}/count"] = s["count"]
                    for q in ("p50", "p95", "p99"):
                        if in_seconds:
                            out[f"{base}/{q}_ms"] = round(s[q] * 1e3, 3)
                        else:
                            out[f"{base}/{q}"] = round(s[q], 6)
        return out


def check_exposition(text: str) -> int:
    """A minimal pure-Python Prometheus text-format checker: every
    non-comment line must be a well-formed sample, every # TYPE must name
    a known type, and at least one sample must exist. OpenMetrics-style
    bucket exemplars (``... 5 # {trace_id="..."} 0.003``) are accepted.
    Returns the sample count."""
    sample_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="
        r'"(\\.|[^"\\])*"(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*)?\})?'
        r" (NaN|[+-]?Inf|[+-]?[0-9.eE+-]+)( [0-9]+)?"
        r'( # \{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"\}'
        r" (NaN|[+-]?Inf|[+-]?[0-9.eE+-]+)( [0-9.eE+-]+)?)?$"
    )
    samples = 0
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped",
            ):
                raise ValueError(f"line {i}: bad # TYPE: {line!r}")
        elif line.startswith("#"):
            if not line.startswith("# HELP "):
                raise ValueError(f"line {i}: unknown comment: {line!r}")
        elif sample_re.match(line):
            samples += 1
        else:
            raise ValueError(f"line {i}: malformed sample: {line!r}")
    if samples == 0:
        raise ValueError("no samples in exposition")
    return samples
