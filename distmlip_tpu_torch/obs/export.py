"""Trace export + offline analysis: Perfetto JSON, completeness, critical
paths (``distmlip_tpu/obs/export.py``).

- :func:`to_trace_events` / :func:`write_trace` — Chrome/Perfetto
  ``trace_event`` JSON (complete "X" events, one lane per trace, span
  identity + links riding ``args``). Drop the file on ``ui.perfetto.dev``.
- :func:`load_trace` — round-trips an exported file back into the span
  dicts every function here consumes.
- :func:`request_trace_summary` — the ``trace_complete`` gate: every
  request trace (root named in ``REQUEST_ROOT_NAMES``) must be CLOSED and
  contain exactly one terminal ``future.resolve`` span, whatever path the
  request took (dispatch, cache hit, coalesce, failover re-dispatch,
  shed); a root that was rejected at the door closes without a terminal.
- :func:`critical_paths` / :func:`critical_path_summary` — per-request
  breakdown (queue vs pack vs compile vs device vs resolve), following
  the span links from batch-dispatch traces back to their member
  requests, plus an interval-union COVERAGE measure (what fraction of
  the request's wall time the spans explain — the 10%-accounting
  acceptance check) and the ``queue_dominant`` flag (median queue wait
  exceeding median device time: add capacity, not kernels).
"""

from __future__ import annotations

import json
import os

from .tracing import REQUEST_ROOT_NAMES, TERMINAL_SPAN_NAME, Span

# batch-level trace roots: their links point at member request contexts
BATCH_ROOT_NAMES = ("serve.batch", "serve.fallback")

# component classification for the critical-path table
_COMPONENT_OF = {
    "engine.queue": "queue",
    "router.queue": "queue",
    "router.route": "queue",
    "tenancy.admit": "queue",
    "router.requeue": "queue",
    "scheduler.plan_batch": "plan",
    "batched.pack": "pack",
    "device.compile": "compile",
    "device.dispatch": "device",
    "cache.hit": "cache",
    "coalesce": "coalesce",
    TERMINAL_SPAN_NAME: "resolve",
}
COMPONENTS = ("queue", "plan", "pack", "compile", "device", "cache",
              "coalesce", "resolve")


def _as_dict(span) -> dict:
    return span.to_dict() if isinstance(span, Span) else dict(span)


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace_event JSON
# ---------------------------------------------------------------------------


def to_trace_events(spans, t_wall0: float = 0.0) -> dict:
    """Chrome ``trace_event`` JSON object: one ``tid`` lane per trace,
    complete ("X") events in microseconds, span identity in ``args``."""
    spans = [_as_dict(s) for s in spans]
    tids: dict[str, int] = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s["trace_id"], len(tids) + 1)
        if s["t_end"] is None:
            continue   # open spans have no duration to draw
        events.append({
            "name": s["name"],
            "cat": "distmlip",
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "ts": round(1e6 * s["t_start"], 3),
            "dur": round(1e6 * (s["t_end"] - s["t_start"]), 3),
            "args": {
                "trace_id": s["trace_id"],
                "span_id": s["span_id"],
                "parent_id": s["parent_id"],
                "status": s["status"],
                "links": [list(l) for l in s["links"]],
                **{k: v for k, v in (s.get("attrs") or {}).items()},
            },
        })
    # name each lane after its trace so Perfetto's track list is readable
    for trace_id, tid in tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": f"trace {trace_id}"},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"t_wall0": t_wall0, "producer": "distmlip_tpu_torch.obs"},
    }


def write_trace(path: str, spans, t_wall0: float = 0.0) -> str:
    obj = to_trace_events(spans, t_wall0=t_wall0)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)
    return path


def load_trace(path: str) -> list[dict]:
    """Read an exported trace file back into span dicts (events without
    span identity — foreign trace files — are skipped)."""
    with open(path) as f:
        obj = json.load(f)
    events = obj.get("traceEvents", obj if isinstance(obj, list) else [])
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        if "trace_id" not in args or "span_id" not in args:
            continue
        t0 = ev["ts"] / 1e6
        attrs = {k: v for k, v in args.items()
                 if k not in ("trace_id", "span_id", "parent_id",
                              "status", "links")}
        spans.append({
            "trace_id": args["trace_id"], "span_id": args["span_id"],
            "parent_id": args.get("parent_id", ""),
            "name": ev.get("name", ""),
            "t_start": t0, "t_end": t0 + ev.get("dur", 0.0) / 1e6,
            "status": args.get("status", "ok"),
            "attrs": attrs,
            "links": [tuple(l) for l in args.get("links", [])],
        })
    return spans


def load_trace_dir(path: str) -> list[dict]:
    """Load every ``*.json`` trace artifact under a directory (or a
    single file path) into one span list."""
    if os.path.isfile(path):
        return load_trace(path)
    spans: list[dict] = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".json"):
            try:
                spans.extend(load_trace(os.path.join(path, name)))
            except (OSError, json.JSONDecodeError, KeyError):
                continue
    return spans


# ---------------------------------------------------------------------------
# completeness (the trace_complete gate)
# ---------------------------------------------------------------------------


def _group_by_trace(spans) -> dict[str, list[dict]]:
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        d = _as_dict(s)
        by_trace.setdefault(d["trace_id"], []).append(d)
    return by_trace


def _root_of(trace_spans) -> dict | None:
    for s in trace_spans:
        if not s["parent_id"]:
            return s
    return None


def request_trace_summary(spans) -> dict:
    """Span-tree conservation over every REQUEST trace.

    A request trace is complete when every span in it is closed and it
    contains exactly one ``future.resolve`` terminal — including the
    cache-hit and coalesce short-circuits and failover re-dispatch paths
    (span-COUNT conservation: N submissions in, N terminals out). A root
    with status ``rejected`` (quota/admission door) closes with zero
    terminals by contract.
    """
    requests = complete = 0
    incomplete: list[str] = []
    terminal_violations: list[str] = []
    n_terminals = 0
    for trace_id, ss in _group_by_trace(spans).items():
        root = _root_of(ss)
        if root is None or root["name"] not in REQUEST_ROOT_NAMES:
            continue
        requests += 1
        closed = all(s["t_end"] is not None for s in ss)
        terminals = sum(s["name"] == TERMINAL_SPAN_NAME for s in ss)
        n_terminals += terminals
        rejected = root["status"] == "rejected"
        ok_terminals = (terminals == 1) or (rejected and terminals == 0)
        if not ok_terminals:
            terminal_violations.append(trace_id)
        if closed and ok_terminals:
            complete += 1
        else:
            incomplete.append(trace_id)
    return {
        "requests": requests,
        "complete": complete,
        "terminals": n_terminals,
        "incomplete": incomplete[:16],
        "incomplete_count": len(incomplete),
        "terminal_violations": terminal_violations[:16],
        "terminal_violation_count": len(terminal_violations),
    }


# ---------------------------------------------------------------------------
# critical paths
# ---------------------------------------------------------------------------


def _union_len(intervals) -> float:
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def critical_paths(spans) -> list[dict]:
    """Per-request breakdown: seconds per component, total latency, and
    interval-union coverage (fraction of the request window explained by
    its own spans plus the batch-trace windows linked to it)."""
    spans = [_as_dict(s) for s in spans]
    by_trace = _group_by_trace(spans)
    # batch traces attribute their phase children to every linked request
    linked: dict[str, list[dict]] = {}   # request trace_id -> batch spans
    for ss in by_trace.values():
        root = _root_of(ss)
        if root is None or root["name"] not in BATCH_ROOT_NAMES:
            continue
        for link in root.get("links", ()):
            linked.setdefault(link[0], []).append(root)
            for s in ss:
                if s is not root:
                    linked.setdefault(link[0], []).append(s)
    out = []
    for trace_id, ss in by_trace.items():
        root = _root_of(ss)
        if root is None or root["name"] not in REQUEST_ROOT_NAMES:
            continue
        if root["t_end"] is None:
            continue
        w0, w1 = root["t_start"], root["t_end"]
        total = max(w1 - w0, 0.0)
        comps = dict.fromkeys(COMPONENTS, 0.0)
        intervals = []
        own = [s for s in ss if s is not root and s["t_end"] is not None]
        batch = [s for s in linked.get(trace_id, ())
                 if s["t_end"] is not None]
        for s in own + batch:
            comp = _COMPONENT_OF.get(s["name"])
            if comp is not None:
                comps[comp] += s["t_end"] - s["t_start"]
            # clip to the request window before counting coverage: a
            # batch span also serving other requests may start before
            # this request existed (it cannot — links point forward —
            # but clipping keeps the measure sound regardless)
            a, b = max(s["t_start"], w0), min(s["t_end"], w1)
            if b > a:
                intervals.append((a, b))
        covered = _union_len(intervals)
        out.append({
            "trace_id": trace_id,
            "root": root["name"],
            "status": root["status"],
            "total_s": total,
            "coverage": (covered / total) if total > 0 else 1.0,
            **{k: comps[k] for k in COMPONENTS},
        })
    return out


def _pct(sorted_xs, q):
    if not sorted_xs:
        return 0.0
    n = len(sorted_xs)
    return sorted_xs[min(n - 1, int(q * (n - 1) + 0.5))]


def critical_path_summary(spans) -> dict:
    """Percentiles per component + the queue_dominant flag.

    ``queue_dominant`` is true when the median queue wait exceeds the
    median device time (compile included): the fleet is capacity-bound —
    more replicas / bigger batches move the p99, faster kernels do not.
    This is the MACE case-study failure mode (arXiv:2504.10700) made
    visible per request instead of per run.
    """
    paths = critical_paths(spans)
    summary: dict = {"requests": len(paths)}
    if not paths:
        summary.update(components={}, queue_dominant=False,
                       coverage_p50=0.0)
        return summary
    comps = {}
    for key in (*COMPONENTS, "total_s", "coverage"):
        xs = sorted(p[key] for p in paths)
        comps[key] = {"p50": _pct(xs, 0.50), "p90": _pct(xs, 0.90),
                      "p99": _pct(xs, 0.99), "max": xs[-1]}
    device_median = comps["device"]["p50"] + comps["compile"]["p50"]
    summary["components"] = {k: comps[k] for k in COMPONENTS}
    summary["total"] = comps["total_s"]
    summary["coverage_p50"] = comps["coverage"]["p50"]
    summary["queue_dominant"] = bool(
        comps["queue"]["p50"] > 0.0
        and comps["queue"]["p50"] > device_median)
    return summary


def format_critical_path(summary: dict) -> str:
    """Render the per-request critical-path percentile table."""
    lines = [f"trace critical path ({summary.get('requests', 0)} "
             f"request(s)):"]
    comps = summary.get("components") or {}
    rows = [(k, comps[k]) for k in COMPONENTS
            if k in comps and comps[k]["max"] > 0.0]
    if "total" in summary:
        rows.append(("total", summary["total"]))
    if rows:
        lines.append("  component       p50_ms     p90_ms     p99_ms"
                     "     max_ms")
        for name, s in rows:
            lines.append(
                f"  {name:<12} {1e3 * s['p50']:9.2f} {1e3 * s['p90']:10.2f}"
                f" {1e3 * s['p99']:10.2f} {1e3 * s['max']:10.2f}")
    if "coverage_p50" in summary:
        lines.append(f"  span coverage p50={summary['coverage_p50']:.2f} "
                     f"queue_dominant={summary.get('queue_dominant')}")
    return "\n".join(lines)
