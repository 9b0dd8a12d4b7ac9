"""Unified metrics: counters, gauges, and log2-sub-bucketed histograms.

One :class:`Registry` per process (usually — :func:`default_registry`) holds
every metric family the serving stack, the engine facade, the kernel
dispatcher and the roofline attachment emit.  Design constraints, in order:

* **Disabled is free.**  The registry starts disabled; every recording
  method's first action is one attribute load + branch on
  ``self._reg.enabled`` — there is no locking, no allocation and no clock
  read on the disabled path, so production code leaves the instrumentation
  calls inline (DESIGN.md §10 pins the budget).
* **No raw-sample retention.**  Latency/work distributions are histograms:
  log2 major buckets split into ``SUBBUCKETS`` linear sub-buckets
  (HdrHistogram's scheme).  Percentile reconstruction returns the lower
  bound of the covering bucket, which makes it **exact for integer-valued
  observations below ``2 * SUBBUCKETS``** (work counters, batch sizes, pops
  — bucket width is <= 1 there) and bounds the relative error by
  ``1/SUBBUCKETS`` (6.25%) everywhere else.  Memory is O(occupied buckets),
  independent of the observation count.
* **Observation never perturbs results.**  Metrics are written from host
  Python after device values exist; nothing here feeds back into a traced
  computation (the exactness argument of DESIGN.md §10).

Thread-safety: every mutation takes the metric's own lock (submit threads
race the dispatch thread); reads (``snapshot``) copy under the same locks,
so a scrape can never observe a mid-mutation bucket dict.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterable

SUBBUCKETS = 16     # linear sub-buckets per log2 octave (rel. error 1/16)


def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    """Shared shell: name/labels/help plus the registry whose ``enabled``
    flag gates every write."""

    __slots__ = ("name", "labels", "help", "_reg", "_lock")

    def __init__(self, reg: "Registry", name: str, labels: tuple, help: str):
        self.name = name
        self.labels = labels
        self.help = help
        self._reg = reg
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic event counter."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, reg, name, labels, help):
        super().__init__(reg, name, labels, help)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self.value += n

    def _snapshot(self):
        with self._lock:
            return self.value


class Gauge(_Metric):
    """Last-write-wins instantaneous value (may go up or down)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, reg, name, labels, help):
        super().__init__(reg, name, labels, help)
        self.value = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self.value = float(v)

    def _snapshot(self):
        with self._lock:
            return self.value


def bucket_index(v: float) -> int:
    """Index of the log2 sub-bucket covering ``v`` (> 0): octave ``e`` with
    ``v in [2^e, 2^(e+1))`` split into SUBBUCKETS linear slots."""
    m, e = math.frexp(v)                    # v = m * 2^e, m in [0.5, 1)
    sub = int((2.0 * m - 1.0) * SUBBUCKETS)  # 0 .. SUBBUCKETS-1
    if sub >= SUBBUCKETS:                    # fp edge: m == 1.0 - ulp
        sub = SUBBUCKETS - 1
    return (e - 1) * SUBBUCKETS + sub


def bucket_lo(idx: int) -> float:
    """Smallest value that lands in sub-bucket ``idx`` (its reconstruction
    representative — see the module docstring's exactness bound)."""
    e, sub = divmod(idx, SUBBUCKETS)
    return math.ldexp(1.0 + sub / SUBBUCKETS, e)


def bucket_hi(idx: int) -> float:
    """Exclusive upper bound of sub-bucket ``idx``."""
    e, sub = divmod(idx, SUBBUCKETS)
    return math.ldexp(1.0 + (sub + 1) / SUBBUCKETS, e)


class Histogram(_Metric):
    """Log2-sub-bucketed distribution with percentile reconstruction.

    Observations <= 0 land in a dedicated underflow bucket (reconstructed as
    0.0 — latencies and work counters are nonnegative, so the only mass there
    is genuine zeros).  ``quantile`` uses the nearest-rank definition over
    the bucket counts and returns the covering bucket's lower bound, except
    for the extremes where the tracked exact ``min``/``max`` are returned.
    """

    __slots__ = ("buckets", "n", "total", "vmin", "vmax", "n_zero")
    kind = "histogram"

    def __init__(self, reg, name, labels, help):
        super().__init__(reg, name, labels, help)
        self.buckets: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.n_zero = 0

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        with self._lock:
            self.n += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if v <= 0.0:
                self.n_zero += 1
            else:
                i = bucket_index(v)
                self.buckets[i] = self.buckets.get(i, 0) + 1

    def observe_many(self, vs: Iterable[float]) -> None:
        if not self._reg.enabled:
            return
        for v in vs:
            self.observe(v)

    # -- reconstruction ------------------------------------------------------

    def quantile(self, q: float) -> float:
        """Nearest-rank percentile (``q`` in [0, 100]) reconstructed from the
        buckets; NaN when empty.  p0/p100 are the exact tracked extremes."""
        with self._lock:
            if self.n == 0:
                return math.nan
            if q <= 0:
                return self.vmin
            if q >= 100:
                return self.vmax
            rank = max(1, math.ceil(q / 100.0 * self.n))
            cum = self.n_zero
            if rank <= cum:
                return 0.0
            for i in sorted(self.buckets):
                cum += self.buckets[i]
                if rank <= cum:
                    return bucket_lo(i)
            return self.vmax

    def percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        return {f"p{q:g}": self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.n if self.n else math.nan

    def _snapshot(self):
        with self._lock:
            return {"count": self.n, "sum": self.total,
                    "min": self.vmin if self.n else None,
                    "max": self.vmax if self.n else None,
                    "zeros": self.n_zero,
                    "buckets": dict(sorted(self.buckets.items()))}


class Registry:
    """Get-or-create metric families keyed on ``(name, labels)``.

    ``enabled`` gates every write (see module docstring); metric objects can
    be created and held while disabled — they only start counting once the
    registry is enabled, so components bind their metrics at construction
    with no conditional wiring."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict | None, help: str):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(self, name, _label_key(labels), help)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, labels: dict | None = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: dict | None = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, labels: dict | None = None,
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, labels, help)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def find(self, name: str) -> list[_Metric]:
        """Every series of one metric family (any labels)."""
        with self._lock:
            return [m for (n, _), m in self._metrics.items() if n == name]

    def snapshot(self) -> dict:
        """Plain-data copy of every series: ``{name{labels}: value-or-hist}``
        — the JSONL exporter's payload.  Values are copied under each
        metric's own lock, never read live."""
        out = {}
        for m in self.metrics():
            out[m.name + _label_str(m.labels)] = m._snapshot()
        return out

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# process default
# ---------------------------------------------------------------------------

# Disabled by default: instrumentation must cost nothing unless asked for
# (launch/serve.py --metrics-port / --metrics enables it; tests use use()).
_DEFAULT = Registry(enabled=False)


def default_registry() -> Registry:
    return _DEFAULT


def resolve(reg: Registry | None) -> Registry:
    """The registry a component should record into: an explicit one, else
    the process default."""
    return reg if reg is not None else _DEFAULT


def enable(on: bool = True) -> Registry:
    """Turn the process-default registry on (or off); returns it."""
    _DEFAULT.enabled = on
    return _DEFAULT


@contextlib.contextmanager
def use(reg: Registry):
    """Swap the process-default registry for the dynamic extent of the
    context (tests/benchmarks isolate their metrics this way)."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, reg
    try:
        yield reg
    finally:
        _DEFAULT = prev
