"""Chrome/Perfetto trace export of a session's spans.

The port's copy of the span half of ray_tpu's ``util/timeline.py``: one
JSON file in the Trace Event Format, which ``ui.perfetto.dev`` or
``chrome://tracing`` loads, with one track (pid) a process that recorded
spans and an "X" complete event a span, its args the span's attributes and
ids (``build_chrome_trace``), and the view of one served sequence
(``build_sequence_trace``): the spans of its trace and an instant a token,
from the serve-LLM sequence records (``serve/llm/observability.py``).

Timestamps are unix-epoch microseconds (spans record unix nanoseconds).

Left out until the controller half is ported (ROADMAP Queue A items 14b-ii-b
and 14d): the controller's task-event log as per-node events and the counter
snapshots of its gauges. ``build_chrome_trace`` raises for
``task_events`` and renders no counters.
"""

from __future__ import annotations

from ray_tpu_torch.util import tracing

# Span names that identify a process's role when naming its track.
_ROLE_HINTS = (
    ("lease_wait", "controller"),
    ("worker_start", "node_agent"),
    ("execute", "worker"),
    ("serve.replica", "worker"),
    ("submit", "driver"),
    ("serve.request", "serve_proxy"),
)


def _track_names(spans: list[dict]) -> dict[int, str]:
    """Human track name per recording pid, from the span mix it wrote."""
    by_pid: dict[int, list[dict]] = {}
    for span in spans:
        by_pid.setdefault(span.get("pid") or 0, []).append(span)
    names: dict[int, str] = {}
    for pid, recs in by_pid.items():
        role = None
        for hint, candidate in _ROLE_HINTS:
            if any(r.get("name", "").startswith(hint) for r in recs):
                role = candidate
                break
        worker_ids = {
            (r.get("attributes") or {}).get("worker_id")
            for r in recs
            if (r.get("attributes") or {}).get("worker_id")
        }
        if role in (None, "worker") and len(worker_ids) == 1:
            names[pid] = f"worker {next(iter(worker_ids))}"
        else:
            names[pid] = f"{role or 'process'} (pid {pid})"
    return names


def _span_events(spans: list[dict]) -> list[dict]:
    events: list[dict] = []
    for pid, label in _track_names(spans).items():
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": label},
            }
        )
    for span in spans:
        start_ns = span.get("start_ns") or 0
        end_ns = span.get("end_ns") or start_ns
        attrs = dict(span.get("attributes") or {})
        attrs["trace_id"] = span.get("trace_id")
        attrs["span_id"] = span.get("span_id")
        if span.get("parent_id"):
            attrs["parent_id"] = span["parent_id"]
        if span.get("status") not in (None, "ok"):
            attrs["status"] = span["status"]
        events.append(
            {
                "name": span.get("name", "span"),
                "cat": "span",
                "ph": "X",
                "ts": start_ns / 1e3,
                "dur": max(0.0, (end_ns - start_ns) / 1e3),
                "pid": span.get("pid") or 0,
                "tid": 0,
                "args": attrs,
            }
        )
    return events


def build_chrome_trace(
    session_dir: str,
    task_events: list[dict] | None = None,
    include_counters: bool = True,
) -> dict:
    """The Trace Event Format dict for one session's span files.

    ``task_events`` (the controller's event log) and the counter snapshots
    need the runtime's controller, which the port does not have yet
    (ROADMAP Queue A items 14b-ii-b and 14d): a non-empty ``task_events``
    raises, and ``include_counters`` adds nothing, as the reference's
    export does when it is not connected."""
    if task_events:
        raise NotImplementedError(
            "task events come from the runtime's controller (ROADMAP Queue A items 14b-ii-b and 14d)")
    spans = tracing.read_spans(session_dir)
    return {"traceEvents": _span_events(spans), "displayTimeUnit": "ms"}


def build_sequence_trace(session_dir: str, request_id: str) -> dict:
    """Perfetto view of ONE served sequence: every span that shares the
    sequence's trace id — proxy request, replica handling, prefill, KV
    transfer/wire hops, channel push/pop, decode iterations — plus an
    instant event per emitted token, so TTFT and inter-token gaps are
    readable off the ruler.

    Raises KeyError when no terminal timeline record exists for
    ``request_id`` (not served, not sampled, or sampling disabled)."""
    from ray_tpu_torch.serve.llm import observability as seq_obs

    seq_rec = None
    for rec in seq_obs.read_sequences(session_dir):
        if rec.get("kind") == "seq" and rec.get("request_id") == request_id:
            seq_rec = rec  # keep the LAST record (replays re-export)
    if seq_rec is None:
        raise KeyError(
            f"no sequence timeline record for request_id={request_id!r} "
            "(was the sequence sampled? see LLMConfig.seq_trace_sample)"
        )
    trace_id = seq_rec.get("trace_id") or ""
    spans = [
        s for s in tracing.read_spans(session_dir)
        if trace_id and s.get("trace_id") == trace_id
    ]
    events = _span_events(spans)
    # Token instants ride the ingress track (the earliest span's pid,
    # else a synthetic one): ts anchors on the trace's first span so
    # the relative emission offsets land on the same axis.
    starts = [s.get("start_ns") or 0 for s in spans if s.get("start_ns")]
    rels = seq_rec.get("token_rel_s") or []
    if starts:
        anchor_us = min(starts) / 1e3
    elif rels:
        # No spans (tracing off, sampled timeline only): reconstruct
        # the enqueue wall time from the terminal record's timestamp.
        anchor_us = (float(seq_rec.get("ts", 0.0)) - rels[-1]) * 1e6
    else:
        anchor_us = 0.0
    pid = spans[0].get("pid", 0) if spans else 0
    for i, rel_s in enumerate(rels):
        events.append({
            "name": f"token[{i}]",
            "cat": "token",
            "ph": "i",
            "s": "p",
            "ts": anchor_us + rel_s * 1e6,
            "pid": pid,
            "tid": 0,
            "args": {"request_id": request_id, "index": i},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"sequence": seq_rec},
    }
