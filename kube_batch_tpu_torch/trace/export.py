"""Chrome trace-event export + phase summaries for session traces.

``to_chrome_trace`` renders one SessionTrace as Chrome trace-event JSON
(the JSON Array Format with a ``traceEvents`` wrapper) loadable directly
in Perfetto / chrome://tracing: one named track (tid) per top-level phase
— open_session, each action, close_session for scheduler cycles;
tensorize/ship/dispatch/... for bench sessions — nested spans as complete
("X") events inside their phase's track, and counter samples (e.g. bytes
shipped) as counter ("C") events.  Timestamps are microseconds from
session start.

``summarize_phases`` / ``phase_percentiles`` are the aggregation used by
/debug/sessions and bench.py's per-round span summaries.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

_PID = 1


def _track_order(trace) -> List[str]:
    """Tracks in first-appearance order (phase execution order)."""
    seen: Dict[str, None] = {}
    for sp in trace.spans:
        seen.setdefault(sp.track, None)
    for name, _ts, _v in trace.counters:
        seen.setdefault(name, None)
    return list(seen)


def to_chrome_trace(trace) -> dict:
    """Trace-event JSON for one session (loadable in Perfetto)."""
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": f"kube-batch-tpu session {trace.sid}"},
    }]
    tids: Dict[str, int] = {}
    for i, track in enumerate(_track_order(trace)):
        tid = tids[track] = i + 1
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": track}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"sort_index": i}})
    # The whole-session envelope rides tid 0 so phase tracks stay clean.
    events.append({
        "name": f"session {trace.sid}", "ph": "X", "ts": 0.0,
        "dur": trace.duration_ms * 1e3, "pid": _PID, "tid": 0,
        "args": {"uid": trace.uid, **trace.meta,
                 "verdicts": len(trace.verdicts),
                 "tallies": len(trace.tallies)},
    })
    for sp in trace.spans:
        events.append({
            "name": sp.name, "ph": "X", "ts": sp.ts, "dur": sp.dur,
            "pid": _PID, "tid": tids[sp.track],
            "args": dict(sp.args) if sp.args else {},
        })
    for name, ts, value in trace.counters:
        events.append({
            "name": name, "ph": "C", "ts": ts, "pid": _PID,
            "tid": tids[name],
            "args": {name: value},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"session": trace.sid, "uid": trace.uid,
                          "start_time": trace.start_time}}


def summarize_phases(trace) -> Dict[str, float]:
    """Total milliseconds per top-level phase (depth-0 spans only — nested
    spans are contained in their parent and would double-count)."""
    out: Dict[str, float] = {}
    for sp in trace.spans:
        if sp.depth == 0:
            out[sp.name] = out.get(sp.name, 0.0) + sp.dur / 1e3
    return {k: round(v, 3) for k, v in out.items()}


def span_totals(trace) -> Dict[str, float]:
    """Total milliseconds per span NAME at any depth (nested phases like
    device_wait sum across occurrences)."""
    out: Dict[str, float] = {}
    for sp in trace.spans:
        out[sp.name] = out.get(sp.name, 0.0) + sp.dur / 1e3
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    import math
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


def phase_percentiles(traces: Iterable,
                      names: Optional[Iterable[str]] = None) -> dict:
    """{span name: {"p50": ms, "p95": ms, "n": count}} across traces.

    Per trace, a span name contributes its total duration (sum over
    occurrences); percentiles are then taken across traces — the shape
    bench.py embeds so a BENCH_*.json trajectory shows WHERE time went."""
    per_name: Dict[str, List[float]] = {}
    for tr in traces:
        for name, ms in span_totals(tr).items():
            per_name.setdefault(name, []).append(ms)
    if names is not None:
        wanted = set(names)
        per_name = {k: v for k, v in per_name.items() if k in wanted}
    out = {}
    for name, vals in sorted(per_name.items()):
        vals.sort()
        out[name] = {"p50": round(_percentile(vals, 0.5), 3),
                     "p95": round(_percentile(vals, 0.95), 3),
                     "n": len(vals)}
    return out
