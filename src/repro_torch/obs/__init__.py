"""repro_torch.obs — request-lifecycle tracing + serving metrics.

Port of `repro/obs`:

  obs.events    Tracer protocol (nil-by-default engine hooks),
                ServeTracer recorder, RequestRecord derived spans,
                Chrome trace-event export (Perfetto-loadable)
  obs.metrics   Counter/Gauge/Histogram registry with fixed log-spaced
                latency buckets; JSON + Prometheus text exposition;
                the ONE home for percentile math in the serving stack
  python -m repro_torch.obs report trace.json
                per-request latency table from an exported trace

Wiring: `Engine(cfg, params, tracer=ServeTracer())`, or
`python -m repro_torch.launch.serve --trace-out trace.json
--metrics-json metrics.json`.
"""
from repro_torch.obs.events import RequestRecord, ServeTracer, Tracer
from repro_torch.obs.metrics import (BUCKET_RATIO, LATENCY_BUCKETS,
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry, log_buckets,
                                     percentiles)

__all__ = [
    "BUCKET_RATIO", "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS",
    "MetricsRegistry", "RequestRecord", "ServeTracer", "Tracer",
    "log_buckets", "percentiles",
]
