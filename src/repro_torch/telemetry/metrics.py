"""The metrics registry — the port of ``repro.telemetry.metrics``.

Counters, gauges and histograms with label sets — the workload-level
quantities the scheduler, executor and ``run_resumable`` publish between
chunks (requests admitted/retired, wait/service time, segments run,
checkpoint bytes).  Zero dependencies; three read surfaces:

  * ``snapshot()`` — a plain dict, the programmatic API and what the
    JSONL flusher serialises;
  * ``flush_jsonl(path)`` — append one timestamped snapshot line
    (periodic flushing = calling this between chunks via
    ``JsonlFlusher``, which rate-limits to ``interval_s``);
  * ``prometheus_text()`` — the one-shot Prometheus exposition-format
    dump (``# TYPE`` headers, ``name{k="v"} value`` samples,
    ``_bucket``/``_sum``/``_count`` histogram series) for scrape-style
    consumers without running a server.

Metrics are additive bookkeeping on host-side paths that already run
per-chunk; they are always live (no enable flag) because their cost is
one dict update per event — the tracing ring buffer is the part that
needs an off switch (tracing.py's overhead contract).
"""

from __future__ import annotations

import json
import threading
import time

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _prom_labels(key: tuple, extra: tuple = ()) -> str:
    pairs = [f'{k}="{v}"' for k, v in (*key, *extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter:
    """A monotonically increasing sum per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counters only go up, got {value}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        return {_label_str(k): v for k, v in sorted(self._values.items())}

    def prometheus(self) -> list[str]:
        lines = [f"# TYPE {self.name} counter"]
        if self.help:
            lines.insert(0, f"# HELP {self.name} {self.help}")
        for key, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_prom_labels(key)} {v:g}")
        return lines


class Gauge:
    """A point-in-time value per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        return {_label_str(k): v for k, v in sorted(self._values.items())}

    def prometheus(self) -> list[str]:
        lines = [f"# TYPE {self.name} gauge"]
        if self.help:
            lines.insert(0, f"# HELP {self.name} {self.help}")
        for key, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_prom_labels(key)} {v:g}")
        return lines


class Histogram:
    """Cumulative-bucket histogram per label set (Prometheus semantics:
    ``le`` buckets are cumulative counts, plus ``sum``/``count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be ascending, got {buckets}")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        # per label set: [per-bucket counts..., +Inf count], sum
        self._values: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            entry = self._values.get(key)
            if entry is None:
                entry = [[0] * (len(self.buckets) + 1), 0.0]
                self._values[key] = entry
            counts, _ = entry
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            entry[1] += float(value)

    def _stats(self, entry) -> dict:
        counts, total = entry
        n = sum(counts)
        return {
            "count": n,
            "sum": round(total, 9),
            "mean": round(total / n, 9) if n else 0.0,
            "buckets": {
                **{f"le_{b:g}": c for b, c in zip(self.buckets, counts)},
                "le_inf": counts[-1],
            },
        }

    def snapshot(self) -> dict:
        return {
            _label_str(k): self._stats(e)
            for k, e in sorted(self._values.items())
        }

    def prometheus(self) -> list[str]:
        lines = [f"# TYPE {self.name} histogram"]
        if self.help:
            lines.insert(0, f"# HELP {self.name} {self.help}")
        for key, (counts, total) in sorted(self._values.items()):
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_prom_labels(key, (('le', f'{b:g}'),))} {cum}"
                )
            cum += counts[-1]
            lines.append(
                f"{self.name}_bucket"
                f"{_prom_labels(key, (('le', '+Inf'),))} {cum}"
            )
            lines.append(f"{self.name}_sum{_prom_labels(key)} {total:g}")
            lines.append(f"{self.name}_count{_prom_labels(key)} {cum}")
        return lines


class MetricsRegistry:
    """Named metric instruments, created on first use and type-checked
    on every reuse (a name is one instrument forever)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {m.kind}, not a "
                    f"{cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """{name: {"type": ..., "values": {label_str: value}}} — the
        programmatic read surface and the JSONL flush payload."""
        with self._lock:
            metrics = dict(self._metrics)
        return {
            name: {"type": m.kind, "values": m.snapshot()}
            for name, m in sorted(metrics.items())
        }

    def flush_jsonl(self, path: str) -> None:
        """Append one timestamped snapshot line (the periodic-flush
        primitive; ``JsonlFlusher`` rate-limits calls to it)."""
        line = {"ts_unix": round(time.time(), 3), "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(line, sort_keys=True) + "\n")

    def prometheus_text(self) -> str:
        """One-shot Prometheus exposition-format dump."""
        with self._lock:
            metrics = dict(self._metrics)
        lines = []
        for _, m in sorted(metrics.items()):
            lines.extend(m.prometheus())
        return "\n".join(lines) + ("\n" if lines else "")


class JsonlFlusher:
    """Periodic JSONL flushing without threads: call ``maybe_flush()``
    wherever the host loop already runs between chunks; it writes at
    most once per ``interval_s``.  ``close()`` writes the final
    snapshot unconditionally."""

    def __init__(
        self, registry: MetricsRegistry, path: str, interval_s: float = 5.0
    ):
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        self.registry = registry
        self.path = path
        self.interval_s = float(interval_s)
        self._last = float("-inf")

    def maybe_flush(self) -> bool:
        now = time.perf_counter()
        if now - self._last < self.interval_s:
            return False
        self._last = now
        self.registry.flush_jsonl(self.path)
        return True

    def close(self) -> None:
        self.registry.flush_jsonl(self.path)


# the process-default registry — what the runtime layers publish into
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> dict:
    return REGISTRY.snapshot()
