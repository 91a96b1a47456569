"""Merge per-rank profile captures into ONE Perfetto trace.

Copy of ray_tpu's ``_private/profile_merge.py``: pure functions over the
payloads ``ProfilePlane.collect`` returns (no I/O, no cluster state), so
the same capture payloads give byte-identical JSON in either package.

Output layout (Trace Event Format, loads in ui.perfetto.dev):

  * one pid (track group) per rank, named ``rank R (worker …)``; a capture
    with no rank gets pid ``9000 + i``;
  * tid 0 "steps": one "X" slice per captured step, args carrying the step
    index and the trace ids the boundary observed;
  * tid 1 "phases": the ``step_annotation()`` slices (fwd/bwd/opt,
    per-bucket fence waits), each stamped with the step whose window
    contains it;
  * metadata: capture id and reason, per-rank device-trace dirs (the
    ``torch.profiler`` Chrome trace stays in the worker's
    ``rank<r>-device/trace.json``; this file points at it), host-sample
    counts, phase totals.

Folded host stacks merge separately (:func:`merge_folded`) into the
collapsed-stack format flamegraph tools eat, plus a hierarchical JSON tree
(:func:`flamegraph_tree`).
"""

from __future__ import annotations


def _rank_key(cap: dict):
    rank = cap.get("rank")
    return (rank is None, rank if rank is not None else 0)


def _step_of(ts_us: float, step_windows: list[tuple[float, float, int]]) -> int | None:
    for start, end, step in step_windows:
        if start <= ts_us < end:
            return step
    return None


def merge_captures(
    captures: list[dict],
    capture_id: str,
    meta: dict | None = None,
) -> dict:
    """Per-rank capture payloads → one Chrome/Perfetto trace dict."""
    caps = sorted(
        (c for c in captures if isinstance(c, dict)), key=_rank_key
    )
    events: list[dict] = []
    trace_ids: set[str] = set()
    device_dirs: dict[str, str] = {}
    host_samples: dict[str, int] = {}
    phase_totals: dict[str, dict[str, float]] = {}
    for i, cap in enumerate(caps):
        rank = cap.get("rank")
        pid = rank if rank is not None else 9000 + i
        rank_label = f"rank {rank}" if rank is not None else f"worker[{i}]"
        wid = str(cap.get("worker_id") or "")
        label = f"{rank_label} ({wid[-12:]})" if wid else rank_label
        events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": label}}
        )
        events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "steps"}}
        )
        events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
             "args": {"name": "phases"}}
        )
        # Step slices: boundaries are END-of-step marks; the slice for
        # step b[k+1].step spans b[k].ts → b[k+1].ts.
        bounds = [
            b for b in (cap.get("boundaries") or [])
            if isinstance(b, dict) and "ts" in b and "step" in b
        ]
        step_windows: list[tuple[float, float, int]] = []
        for prev, cur in zip(bounds, bounds[1:]):
            start_us = float(prev["ts"]) * 1e6
            end_us = float(cur["ts"]) * 1e6
            step = int(cur["step"])
            step_windows.append((start_us, end_us, step))
            args: dict = {"step": step, "capture_id": capture_id}
            if cur.get("trace_id"):
                args["trace_id"] = cur["trace_id"]
                trace_ids.add(str(cur["trace_id"]))
            if cur.get("span_id"):
                args["span_id"] = cur["span_id"]
            events.append(
                {
                    "name": f"step {step}",
                    "cat": "step",
                    "ph": "X",
                    "ts": start_us,
                    "dur": max(0.0, end_us - start_us),
                    "pid": pid,
                    "tid": 0,
                    "args": args,
                }
            )
        for prev in bounds:
            if prev.get("trace_id"):
                trace_ids.add(str(prev["trace_id"]))
        # Annotation slices (fwd/bwd/opt, fence buckets), sorted for
        # byte-stable output regardless of buffer interleaving.
        anns = sorted(
            (
                a for a in (cap.get("annotations") or [])
                if isinstance(a, dict) and "ts" in a
            ),
            key=lambda a: (float(a["ts"]), str(a.get("name", ""))),
        )
        for ann in anns:
            ts_us = float(ann["ts"]) * 1e6
            args = {"capture_id": capture_id}
            step = _step_of(ts_us, step_windows)
            if step is not None:
                args["step"] = step
            events.append(
                {
                    "name": str(ann.get("name", "annotation")),
                    "cat": "phase",
                    "ph": "X",
                    "ts": ts_us,
                    "dur": max(0.0, float(ann.get("dur_s") or 0.0) * 1e6),
                    "pid": pid,
                    "tid": 1,
                    "args": args,
                }
            )
        key = str(rank) if rank is not None else f"worker[{i}]"
        if cap.get("device_trace_dir"):
            device_dirs[key] = cap["device_trace_dir"]
        host = cap.get("host") or {}
        if host.get("samples"):
            host_samples[key] = int(host["samples"])
        if cap.get("phase_totals"):
            phase_totals[key] = {
                k: float(v)
                for k, v in sorted(cap["phase_totals"].items())
            }
    metadata = {
        "capture_id": capture_id,
        "ranks": sorted(
            c.get("rank") for c in caps if c.get("rank") is not None
        ),
        "trace_ids": sorted(trace_ids),
        "device_trace_dirs": device_dirs,
        "host_samples": host_samples,
        "phase_totals": phase_totals,
    }
    if meta:
        metadata.update(meta)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": metadata,
    }


# -- folded host stacks ---------------------------------------------------
def merge_folded(captures: list[dict]) -> dict[str, int]:
    """Sum per-rank folded stacks, prefixing each with its rank so the
    flamegraph keeps ranks separable. Deterministic: sorted keys."""
    merged: dict[str, int] = {}
    for cap in sorted(
        (c for c in captures if isinstance(c, dict)), key=_rank_key
    ):
        host = cap.get("host") or {}
        rank = cap.get("rank")
        prefix = f"rank{rank}" if rank is not None else "worker"
        for stack, count in (host.get("folded") or {}).items():
            key = f"{prefix};{stack}"
            merged[key] = merged.get(key, 0) + int(count)
    return dict(sorted(merged.items()))


def folded_text(folded: dict[str, int]) -> str:
    """Collapsed-stack text (``stack count`` per line) — the format
    flamegraph.pl / speedscope / inferno consume directly."""
    return "".join(
        f"{stack} {count}\n" for stack, count in sorted(folded.items())
    )


def flamegraph_tree(folded: dict[str, int]) -> dict:
    """Hierarchical {name, value, children} tree for the dashboard's
    flamegraph JSON route. Children sorted by name: deterministic."""
    root: dict = {"name": "all", "value": 0, "children": {}}
    for stack, count in folded.items():
        root["value"] += count
        node = root
        for frame in stack.split(";"):
            child = node["children"].get(frame)
            if child is None:
                child = {"name": frame, "value": 0, "children": {}}
                node["children"][frame] = child
            child["value"] += count
            node = child

    def _freeze(node: dict) -> dict:
        out = {"name": node["name"], "value": node["value"]}
        kids = [
            _freeze(c)
            for _, c in sorted(node["children"].items())
        ]
        if kids:
            out["children"] = kids
        return out

    return _freeze(root)


# -- hot-phase attribution ------------------------------------------------
def hot_phase(phase_totals: dict[str, float]) -> tuple[str | None, float]:
    """(hot phase name, fraction of attributed time) from one rank's
    captured phase totals. ``comm_exposed`` shadows ``collective`` when
    both fired (the overlap path records the total op time under
    collective AND the blocked slice under comm_exposed — only the
    exposed slice stole step time)."""
    totals = {
        k: float(v) for k, v in (phase_totals or {}).items() if v and v > 0
    }
    if "comm_exposed" in totals:
        totals.pop("collective", None)
    if not totals:
        return None, 0.0
    total = sum(totals.values())
    # Sort by (-value, name): deterministic winner on ties.
    phase, value = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[0]
    return phase, value / total if total > 0 else 0.0
