"""The structured tracing core — the port of ``repro.telemetry.tracing``.

Zero-dependency, host-side-only tracing: a ``span("engine.segment",
step0=..., chunk=...)`` context manager measures wall time between the
host-side dispatch boundaries of the runtime layers (engine submit,
serving segments, tempering swaps, checkpoint saves) and records one
structured event per span into an in-process ring buffer.  The buffer
drains through two exporters:

  * **JSONL** — one event object per line (schema below), the format
    ``validate_jsonl`` checks;
  * **Chrome trace** — the ``chrome://tracing`` / Perfetto JSON object
    format (``ph="X"`` complete events in µs), so a ``--trace out.json``
    run drops straight into a flame view.

Clock discipline: every event timestamps against ONE ``perf_counter``
epoch captured when the tracer is created/reset (``ts_us`` = µs since
epoch, float).  Spans measure *host* wall time between submits — a CUDA
launch is asynchronous, so a span around a call that does not wait for
the card measures the host's enqueue, not device time.  Nothing here
synchronises the card: a site that wants device time waits itself,
outside the span's bookkeeping.  Events carry a process-unique ``seq``
so equal-timestamp events keep their emission order.

Overhead contract: telemetry is OFF by default and the disabled path is
one module-attribute check returning a shared no-op context manager —
no allocation, no clock read.  The enabled path is host-side and
per-chunk/per-segment (never per chain step).

Event schema (JSONL, one object per line; ``schema`` = 1):

  {"kind": "trace_meta", "schema": 1, "dropped": N, "events": N}   header
  {"kind": "span",    "name": str, "ts_us": float, "dur_us": float,
   "tid": int, "depth": int, "seq": int, "meta": {...}}
  {"kind": "instant", "name": str, "ts_us": float,
   "tid": int, "depth": int, "seq": int, "meta": {...}}

``kind``/``name``/``ts_us``/``seq`` are required on every event; spans
additionally require ``dur_us >= 0``.  ``meta`` values are JSON scalars
(non-scalars are repr()'d at record time, so exports never fail late).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque

SCHEMA_VERSION = 1
DEFAULT_CAPACITY = 65536

_LOG = logging.getLogger("repro_torch.telemetry")


def _clean_meta(meta: dict) -> dict:
    """JSON-scalar-only metadata: exporters must never fail on a value
    recorded deep inside a run."""
    out = {}
    for k, v in meta.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[str(k)] = v
        else:
            out[str(k)] = repr(v)
    return out


@dataclasses.dataclass
class TraceEvent:
    """One recorded event (span or instant)."""

    kind: str            # "span" | "instant"
    name: str
    ts_us: float         # µs since the tracer's epoch
    dur_us: float        # span duration (0.0 for instants)
    tid: int             # thread id (small per-tracer ordinal)
    depth: int           # span-nesting depth at record time
    seq: int             # process-wide emission order
    meta: dict

    def to_json(self) -> dict:
        obj = {
            "kind": self.kind,
            "name": self.name,
            "ts_us": round(self.ts_us, 3),
            "tid": self.tid,
            "depth": self.depth,
            "seq": self.seq,
        }
        if self.kind == "span":
            obj["dur_us"] = round(self.dur_us, 3)
        if self.meta:
            obj["meta"] = self.meta
        return obj


class _NullSpan:
    """The shared disabled-path context manager — no state, no clock."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **meta):  # parity with _Span: late metadata is a no-op
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records on exit so the buffer sees complete events."""

    __slots__ = ("_tracer", "_name", "_meta", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, meta: dict):
        self._tracer = tracer
        self._name = name
        self._meta = meta

    def set(self, **meta):
        """Attach metadata discovered mid-span (e.g. a byte count known
        only when the section ends)."""
        self._meta.update(meta)
        return self

    def __enter__(self):
        self._depth = self._tracer._push()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._pop()
        self._tracer._record(
            "span", self._name, self._t0, t1 - self._t0, self._depth,
            self._meta,
        )
        return False


class Tracer:
    """The in-process ring buffer of trace events.

    ``capacity`` bounds memory for arbitrarily long runs; on overflow the
    OLDEST event is dropped (a trace tail is worth more than its head —
    the live end is what post-mortems read) and ``dropped`` counts the
    evictions, surfaced in the export header so a truncated trace is
    never mistaken for a complete one.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = False
        self.dropped = 0
        self._events: deque[TraceEvent] = deque()
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._seq = 0
        self._tids: dict[int, int] = {}         # thread ident -> ordinal
        self._depths = threading.local()        # per-thread nesting depth

    # -- lifecycle ------------------------------------------------------
    def reset(self, capacity: int | None = None) -> None:
        """Drop all events and restart the clock epoch."""
        with self._lock:
            if capacity is not None:
                if capacity < 1:
                    raise ValueError(
                        f"capacity must be >= 1, got {capacity}"
                    )
                self.capacity = int(capacity)
            self._events.clear()
            self.dropped = 0
            self._epoch = time.perf_counter()
            self._seq = 0
            self._tids.clear()

    def clock(self) -> float:
        """Seconds since this tracer's epoch — the one timebase every
        event (and the serving tier's latency stamps) shares."""
        return time.perf_counter() - self._epoch

    # -- recording ------------------------------------------------------
    def _push(self) -> int:
        d = getattr(self._depths, "d", 0)
        self._depths.d = d + 1
        return d

    def _pop(self) -> None:
        self._depths.d = getattr(self._depths, "d", 1) - 1

    def _record(self, kind, name, t0, dur_s, depth, meta) -> None:
        ev_meta = _clean_meta(meta) if meta else {}
        with self._lock:
            tid = self._tids.setdefault(
                threading.get_ident(), len(self._tids)
            )
            if len(self._events) >= self.capacity:
                self._events.popleft()
                self.dropped += 1
            self._events.append(
                TraceEvent(
                    kind=kind,
                    name=str(name),
                    ts_us=(t0 - self._epoch) * 1e6,
                    dur_us=dur_s * 1e6,
                    tid=tid,
                    depth=depth,
                    seq=self._seq,
                    meta=ev_meta,
                )
            )
            self._seq += 1

    def span(self, name: str, **meta):
        """Context manager timing one host-side section.  Disabled-mode
        fast path: one attribute check, a shared no-op object back."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, meta)

    def instant(self, name: str, **meta) -> None:
        """A point event (zero duration)."""
        if not self.enabled:
            return
        self._record(
            "instant", name, time.perf_counter(), 0.0,
            getattr(self._depths, "d", 0), meta,
        )

    def log(self, name: str, **fields) -> None:
        """A structured log line: recorded as an instant event when
        tracing is enabled AND always offered to python logging at INFO
        (logger ``repro_torch.telemetry``) — killed-run forensics read these
        without a trace file (checkpoint/resume.py)."""
        if self.enabled:
            self._record(
                "instant", name, time.perf_counter(), 0.0,
                getattr(self._depths, "d", 0), fields,
            )
        if _LOG.isEnabledFor(logging.INFO):
            _LOG.info(
                "%s %s", name, json.dumps(_clean_meta(fields), sort_keys=True)
            )

    # -- reading / export ----------------------------------------------
    def events(self) -> list[TraceEvent]:
        """A snapshot of the buffer (oldest first)."""
        with self._lock:
            return list(self._events)

    def _header(self, n_events: int) -> dict:
        return {
            "kind": "trace_meta",
            "schema": SCHEMA_VERSION,
            "events": n_events,
            "dropped": self.dropped,
            "capacity": self.capacity,
        }

    def export_jsonl(self, path: str) -> int:
        """Write header + one event per line; returns the event count."""
        events = self.events()
        with open(path, "w") as f:
            f.write(json.dumps(self._header(len(events))) + "\n")
            for ev in events:
                f.write(json.dumps(ev.to_json()) + "\n")
        return len(events)

    def export_chrome_trace(self, path: str) -> int:
        """Write the Chrome-trace (chrome://tracing / Perfetto) JSON
        object format; returns the event count."""
        events = self.events()
        out = []
        for ev in events:
            obj = {
                "name": ev.name,
                "ts": round(ev.ts_us, 3),
                "pid": 0,
                "tid": ev.tid,
                "args": dict(ev.meta, seq=ev.seq),
            }
            if ev.kind == "span":
                obj["ph"] = "X"
                obj["dur"] = round(ev.dur_us, 3)
            else:
                obj["ph"] = "i"
                obj["s"] = "t"
            out.append(obj)
        with open(path, "w") as f:
            json.dump(
                {
                    "traceEvents": out,
                    "displayTimeUnit": "ms",
                    "otherData": self._header(len(events)),
                },
                f,
            )
        return len(events)

    def export(self, path: str) -> int:
        """Format by extension: ``.json``/``.trace`` -> Chrome trace,
        anything else (the ``.trace.jsonl`` convention) -> JSONL."""
        if path.endswith((".json", ".trace")):
            return self.export_chrome_trace(path)
        return self.export_jsonl(path)


# --- the process-default tracer --------------------------------------------
#
# One tracer per process is the common case; tests build private Tracer
# instances.

TRACER = Tracer()


def enable(capacity: int | None = None) -> Tracer:
    """Reset and switch on the default tracer."""
    TRACER.reset(capacity=capacity)
    TRACER.enabled = True
    return TRACER


def disable() -> None:
    TRACER.enabled = False


def enabled() -> bool:
    return TRACER.enabled


def span(name: str, **meta):
    return TRACER.span(name, **meta)


def instant(name: str, **meta) -> None:
    TRACER.instant(name, **meta)


def log(name: str, **fields) -> None:
    TRACER.log(name, **fields)


def clock() -> float:
    return TRACER.clock()


# --- JSONL schema validation ------------------------------------------------
#
# The checker of an exported trace: every line must parse and carry the
# schema's required fields.  Kept here so exporter and checker can never drift apart.

_REQUIRED = {"kind", "name", "ts_us", "seq"}
_KINDS = {"span", "instant"}


def validate_event(obj: dict) -> str | None:
    """None if ``obj`` is a valid trace event/header, else the problem."""
    if not isinstance(obj, dict):
        return f"event is not an object: {type(obj).__name__}"
    kind = obj.get("kind")
    if kind == "trace_meta":
        if obj.get("schema") != SCHEMA_VERSION:
            return f"unsupported schema {obj.get('schema')!r}"
        return None
    if kind not in _KINDS:
        return f"unknown kind {kind!r}"
    missing = _REQUIRED - obj.keys()
    if missing:
        return f"missing fields {sorted(missing)}"
    if not isinstance(obj["name"], str) or not obj["name"]:
        return f"bad name {obj.get('name')!r}"
    if not isinstance(obj["ts_us"], (int, float)):
        return f"bad ts_us {obj.get('ts_us')!r}"
    if kind == "span":
        dur = obj.get("dur_us")
        if not isinstance(dur, (int, float)) or dur < 0:
            return f"span needs dur_us >= 0, got {dur!r}"
    meta = obj.get("meta", {})
    if not isinstance(meta, dict):
        return f"meta must be an object, got {type(meta).__name__}"
    return None


def validate_jsonl(path: str) -> list[str]:
    """All schema problems in a JSONL trace file (empty = valid).
    Problems are ``line N: <what>`` strings."""
    problems = []
    n_lines = 0
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n_lines += 1
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                problems.append(f"line {i}: not JSON ({e})")
                continue
            err = validate_event(obj)
            if err:
                problems.append(f"line {i}: {err}")
    if n_lines == 0:
        problems.append("empty trace file")
    return problems
