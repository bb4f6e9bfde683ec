"""Typed counters, gauges and histograms, keyed by span.

The port's copy of ``scconsensus_tpu/obs/metrics.py`` (stdlib only): a
``Counter`` accumulates, a ``Gauge`` keeps the last value, a
``Histogram`` buckets a distribution. ``MetricSet.to_dict()`` is the one
serialization of a span's metrics.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricSet"]


@dataclasses.dataclass
class Counter:
    """Monotone accumulator."""

    value: float = 0.0

    def add(self, n: float = 1.0) -> "Counter":
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Last-written value."""

    value: Optional[float] = None

    def set(self, v: float) -> "Gauge":
        self.value = v
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bound histogram with running sum/min/max.

    ``bounds`` are the inclusive upper edges of each bucket; one overflow
    bucket is implicit. Default bounds are powers of two — the natural grid
    for window widths, padded rows, and pad ratios in this codebase.
    """

    DEFAULT_BOUNDS = tuple(float(1 << i) for i in range(0, 21))

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        bs = tuple(float(b) for b in (bounds or self.DEFAULT_BOUNDS))
        if list(bs) != sorted(bs):
            raise ValueError("histogram bounds must be sorted ascending")
        self.bounds = bs
        self.counts: List[int] = [0] * (len(bs) + 1)
        self.n = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> "Histogram":
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.n += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        return self

    def to_dict(self) -> Dict[str, Any]:
        # sparse encoding: only occupied buckets ("le" edge -> count);
        # ladders at 1M shapes populate a handful of a 22-bucket grid
        occupied = {
            (str(self.bounds[i]) if i < len(self.bounds) else "+inf"): c
            for i, c in enumerate(self.counts) if c
        }
        return {
            "type": "histogram", "n": self.n, "sum": self.sum,
            "min": self.min, "max": self.max, "buckets": occupied,
        }


class MetricSet:
    """Named metrics of one span. Accessors create-on-first-use so
    instrumentation sites stay one-liners:
    ``span.metrics.counter("genes").add(g)``."""

    def __init__(self):
        self._m: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        m = self._m.get(name)
        if m is None:
            m = cls(*args)
            self._m[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, bounds)

    def empty(self) -> bool:
        return not self._m

    def to_dict(self) -> Dict[str, Any]:
        return {name: m.to_dict() for name, m in self._m.items()}
