"""Tail, summarize, or validate a telemetry trace file — the PyTorch
port of ``repro.launch.monitor`` (standard library and the port's
``telemetry`` only).

The read-side companion of ``--trace``: point it at a JSONL trace
written by ``repro_torch.launch.sample`` or
``repro_torch.launch.serve_engine`` and get a per-span-name aggregation
(count, total / mean / max duration, share of traced time) plus the
instant/log events.  ``--check`` validates every line against the trace
event schema and exits non-zero on a malformed file.  ``--follow`` tails
a live file, printing events as a run appends them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sample --workload ising \
      --smoke --device cpu --trace out.trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.monitor out.trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.monitor --check out.trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.monitor --follow live.trace.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch import telemetry


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.monitor",
        description="Tail/summarize/validate a telemetry JSONL trace.",
    )
    p.add_argument("trace", help="JSONL trace file (--trace output)")
    p.add_argument(
        "--check", action="store_true",
        help="validate against the event schema; exit 1 on any problem",
    )
    p.add_argument(
        "--follow", action="store_true",
        help="tail the file, printing events as they are appended",
    )
    p.add_argument(
        "--top", type=int, default=20,
        help="span names shown in the summary (by total duration)",
    )
    return p


def read_events(path: str) -> tuple[dict | None, list[dict]]:
    """(header, events) from a JSONL trace; malformed lines are skipped
    (use --check for strict validation)."""
    header = None
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if obj.get("kind") == "trace_meta":
                header = obj
            else:
                events.append(obj)
    return header, events


def summarize_events(events: list[dict], top: int = 20) -> list[dict]:
    """Per-span-name aggregate rows, sorted by total duration."""
    agg: dict[str, dict] = {}
    for ev in events:
        if ev.get("kind") != "span":
            continue
        row = agg.setdefault(
            ev["name"], {"count": 0, "total_us": 0.0, "max_us": 0.0}
        )
        dur = float(ev.get("dur_us", 0.0))
        row["count"] += 1
        row["total_us"] += dur
        row["max_us"] = max(row["max_us"], dur)
    total = sum(r["total_us"] for r in agg.values()) or 1.0
    rows = []
    for name, r in sorted(
        agg.items(), key=lambda kv: -kv[1]["total_us"]
    )[: max(1, top)]:
        rows.append(
            {
                "span": name,
                "count": r["count"],
                "total_ms": round(r["total_us"] / 1e3, 3),
                "mean_us": round(r["total_us"] / r["count"], 1),
                "max_us": round(r["max_us"], 1),
                "share": round(r["total_us"] / total, 3),
            }
        )
    return rows


def _print_summary(path: str, top: int) -> int:
    header, events = read_events(path)
    spans = [e for e in events if e.get("kind") == "span"]
    instants = [e for e in events if e.get("kind") == "instant"]
    print(
        f"[monitor] {path}: {len(spans)} spans, {len(instants)} instants"
        + (
            f", {header.get('dropped', 0)} dropped (ring overflow)"
            if header
            else ", no header (partial file?)"
        )
    )
    for row in summarize_events(events, top=top):
        print("  " + "  ".join(f"{k}={v}" for k, v in row.items()))
    if instants:
        print("[monitor] last instants:")
        for ev in instants[-min(10, len(instants)):]:
            meta = ev.get("meta", {})
            print(
                f"  {ev['name']} @ {float(ev['ts_us']) / 1e6:.3f}s  "
                + "  ".join(f"{k}={v}" for k, v in meta.items())
            )
    return 0


def _check(path: str) -> int:
    problems = telemetry.validate_jsonl(path)
    if problems:
        print(f"[monitor] {path}: INVALID ({len(problems)} problems)")
        for msg in problems[:20]:
            print(f"  {msg}")
        return 1
    header, events = read_events(path)
    print(
        f"[monitor] {path}: valid trace (schema "
        f"{header.get('schema') if header else '?'}, {len(events)} events)"
    )
    return 0


def _follow(path: str) -> int:  # pragma: no cover - interactive loop
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                time.sleep(0.2)
                continue
            line = line.strip()
            if line:
                print(line)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.check:
        return _check(args.trace)
    if args.follow:
        return _follow(args.trace)
    return _print_summary(args.trace, args.top)


if __name__ == "__main__":
    raise SystemExit(main())
