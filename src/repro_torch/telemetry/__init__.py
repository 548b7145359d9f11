# Unified telemetry of the PyTorch port (a copy of repro.telemetry, the
# same public names): three zero-dependency pieces shared by every
# runtime layer —
#
#   tracing   span("engine.submit", ...) context managers -> an
#             in-process ring buffer -> JSONL / Chrome-trace exporters
#             (off by default; the disabled path is one attribute check)
#   metrics   counters/gauges/histograms with label sets, published by
#             the scheduler/executor/run_resumable; snapshot() dict,
#             periodic JSONL flush, one-shot Prometheus text export
#   health    threshold checks over the existing StreamingChainStats /
#             SwapStats / latency_summary accumulators -> structured
#             HealthAlert records + SamplerHealthWarning warnings
#
# Instrumentation sites are host-side and per-chunk/per-segment — never
# per chain step — and never touch the sampled stream (bit-parity with
# telemetry on vs off is asserted in tests/test_torch_telemetry.py).  No
# span, counter or log synchronises the card or reads a device value: a
# span around a CUDA submit times the host's enqueue.

from repro_torch.telemetry.health import (
    HealthAlert,
    HealthMonitor,
    HealthThresholds,
    SamplerHealthWarning,
)
from repro_torch.telemetry.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    JsonlFlusher,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    snapshot,
)
from repro_torch.telemetry.tracing import (
    SCHEMA_VERSION,
    TRACER,
    TraceEvent,
    Tracer,
    clock,
    disable,
    enable,
    enabled,
    instant,
    log,
    span,
    validate_event,
    validate_jsonl,
)

__all__ = [
    # tracing
    "Tracer",
    "TraceEvent",
    "TRACER",
    "SCHEMA_VERSION",
    "enable",
    "disable",
    "enabled",
    "span",
    "instant",
    "log",
    "clock",
    "validate_event",
    "validate_jsonl",
    # metrics
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlFlusher",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    # health
    "HealthMonitor",
    "HealthThresholds",
    "HealthAlert",
    "SamplerHealthWarning",
]
