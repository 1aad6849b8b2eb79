"""Process-local serving metrics: Counter / Gauge / Histogram + exposition.

Port of `repro/obs/metrics.py` (a copy: the port imports nothing of the
JAX package, though this module uses no JAX).  The serving-side signals:
ttft, inter-token latency, queue wait, occupancy.

Contracts:

  * Histograms use FIXED log-spaced bucket bounds shared by every
    instrument, so p50/p90/p99 are derivable from any SNAPSHOT (a
    scraped Prometheus exposition, a metrics JSON artifact) without the
    raw observations; two snapshots are always mergeable bucket-wise.
  * This module is the ONE home for percentile math in the port's
    serving stack: `Histogram.percentile` (bucketed) and `percentiles`
    (exact, for small in-memory sample lists).  The port's lint rule
    REPRO-L004 rejects ad-hoc `np.percentile` / `sorted(xs)[...]`
    arithmetic anywhere else under `serve/` or `obs/`, as REPRO-L001
    keeps clock reads inside `tune/timer.py`.
  * No clocks here: values are observed in seconds by callers that
    stamp via `repro_torch.tune.timer.now()` (obs/events.py).

Exposition: `MetricsRegistry.to_json()` for artifacts and
`MetricsRegistry.prometheus_text()` (text exposition format 0.0.4) for
scrapers; both are pure snapshots of host-side state.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, Iterable, List, Optional, Sequence, Union


def log_buckets(lo: float = 1e-5, hi: float = 100.0,
                per_decade: int = 8) -> List[float]:
    """Log-spaced bucket upper bounds covering [lo, hi] — default 10 us
    to 100 s at 8 buckets per decade (adjacent bounds differ by
    10^(1/8) ~= 1.33x, so a bucketed p99 is within ~33% of exact)."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (i / per_decade) for i in range(n + 1)]


#: the repo-wide latency bucket bounds (seconds) — every latency
#: histogram shares them so snapshots are mergeable across engines
LATENCY_BUCKETS = tuple(log_buckets())

#: ratio between adjacent LATENCY_BUCKETS bounds — the worst-case
#: multiplicative error of a bucketed percentile (tests pin this)
BUCKET_RATIO = 10 ** (1 / 8)


def percentiles(values: Sequence[float],
                ps: Iterable[float]) -> Dict[float, Optional[float]]:
    """Exact order-statistic percentiles (inverted-CDF: the smallest
    observation x with CDF(x) >= p/100, i.e. sorted[ceil(p/100*n)-1]).

    The serving stack's one exact implementation: `ServeTracer.summary`
    and the `repro_torch.obs report` table both call this, so a p99 in
    a summary means the same thing as one in the CLI table.
    Returns {p: None} for an empty sample.
    """
    ps = list(ps)
    if not values:
        return {p: None for p in ps}
    xs = sorted(values)
    n = len(xs)
    out = {}
    for p in ps:
        if not 0 <= p <= 100:
            raise ValueError(f"percentile {p} outside [0, 100]")
        rank = max(1, math.ceil(p / 100.0 * n))
        out[p] = xs[min(rank, n) - 1]
    return out


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class Counter:
    """Monotonically increasing count (events, tokens, rejections)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-written level (slots active, pages in use, queue depth)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Fixed-bound bucketed distribution; percentiles from the snapshot.

    `counts[i]` holds observations v with bounds[i-1] < v <= bounds[i]
    (bisect_left on the upper bounds); the final slot is the +Inf
    overflow.  `percentile(p)` returns the UPPER bound of the bucket
    holding the p-th-percentile observation — an upper estimate within
    one bucket ratio of the exact value.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        bounds = list(buckets)
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             f"strictly increasing")
        self.name = name
        self.help = help
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = +Inf overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    def percentile(self, p: float) -> Optional[float]:
        """Upper bucket bound covering the p-th percentile observation
        (inverted-CDF rank, like `percentiles`); None when empty; +inf
        when the rank lands in the overflow bucket."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile {p} outside [0, 100]")
        if self.total == 0:
            return None
        rank = max(1, math.ceil(p / 100.0 * self.total))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds[i] if i < len(self.bounds) else math.inf
        return math.inf  # unreachable: cum ends at self.total >= rank

    def snapshot(self) -> dict:
        nonzero = [[self.bounds[i] if i < len(self.bounds) else None, c]
                   for i, c in enumerate(self.counts) if c]
        return {"kind": self.kind, "count": self.total, "sum": self.sum,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99),
                "buckets": nonzero}   # [upper_bound_or_None(+Inf), count]


Metric = Union[Counter, Gauge, Histogram]


# ---------------------------------------------------------------------------
# Registry + exposition
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    Process-local: instruments are updated from host-side engine code
    between device steps.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def to_json(self) -> dict:
        """The metrics artifact (launch/serve.py --metrics-json)."""
        return {"version": 1, "metrics": self.snapshot()}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for i, c in enumerate(m.counts[:-1]):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{m.bounds[i]:.9g}"}}'
                                 f" {cum}")
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.total}')
                lines.append(f"{name}_sum {m.sum:.9g}")
                lines.append(f"{name}_count {m.total}")
            else:
                v = m.value
                lines.append(f"{name} "
                             f"{'NaN' if v is None else format(v, '.9g')}")
        return "\n".join(lines) + "\n"
