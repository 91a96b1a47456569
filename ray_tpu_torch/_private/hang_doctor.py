"""The hang report: the ranks' flight evidence merged into one verdict.

Port of ray_tpu's ``_private/hang_doctor.py``. The comm watchdog
(``util.collective.flight``) only knows its own process: "my recv on
``g:recv:__ar/rs`` has aged past the channel's deadline". Blame needs the
other side of each wire, so the evidence of every rank (its last ring
records and in-flight summary) is merged by :func:`build_report`:

    for each stalled channel, which ranks are *waiting* at the sequence
    frontier, which ranks are *missing* from it (no in-flight record and a
    completed-sequence high-water mark behind the others'), and which
    ranks the waiters' wire records point at.

The missing set is the laggard signal: a rank wedged before its op
reaches the recorder has no record at the frontier ``(group, tag, seq)``
while every peer's record ages there.

Where the reference harvests through its controller and node agents, the
port asks each ring member's listener directly (:func:`harvest`, the
``comm_flight`` query the reference's workers answer), so a member
blocked in a collective still answers. Left out until the runtime core
(ROADMAP Queue A item 14): reconciling channels against the static comm
graph. :func:`static_comm_sites` returns no sites and
:func:`channel_in_static_graph` answers None ("unknown"), as the
reference's do without its devtools, so no channel is flagged as protocol
drift.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Optional

INFLIGHT_STATES = ("enqueued", "launched")


def static_comm_sites() -> list[dict]:
    """The static comm sites: none here (no comm-graph extractor yet)."""
    return []


def channel_in_static_graph(
    kind: str, tag_skeleton: str, sites: Iterable[dict]
) -> Optional[bool]:
    """None: the static graph cannot answer without sites."""
    return None


def harvest(addresses: dict, node_id: str = "local", timeout: float = 10.0) -> tuple:
    """Asks each ring listener in ``addresses`` ({rank: (host, port)}) for
    its flight evidence. Returns ``(stalls, evidence)``: every rank's stall
    events, and the evidence shaped as the reference's harvest,
    ``{node_id: {"workers": {"rank<r>": payload}}}``; a rank that does not
    answer is ``{"status": "error", "error": ...}``."""
    from ray_tpu_torch.util.collective import comm_flight

    workers, stalls = {}, []
    for rank, address in sorted(addresses.items()):
        try:
            reply = comm_flight(address, timeout=timeout)
        except OSError as exc:
            workers[f"rank{rank}"] = {"status": "error", "error": repr(exc)}
            continue
        stalls.extend(reply.get("stalls") or [])
        workers[f"rank{rank}"] = reply
    return stalls, {node_id: {"workers": workers}}


# ---------------------------------------------------------------------------
# evidence merge
# ---------------------------------------------------------------------------

def _iter_worker_evidence(evidence: dict) -> Iterable[tuple[str, str, dict]]:
    """Yield (node_id, worker_id, worker payload) over a harvest result
    shaped {node_id: {"workers": {worker_id: payload}}}."""
    for node_id, node_res in (evidence or {}).items():
        if not isinstance(node_res, dict):
            continue
        for wid, wres in (node_res.get("workers") or {}).items():
            if isinstance(wres, dict) and wres.get("status") == "ok":
                yield node_id, wid, wres


def _merge_channel(channel: str, records: list[dict]) -> dict:
    """Fold every rank's records on one channel into the who-is-missing
    verdict. ``records`` carry a ``_worker``/``_node`` annotation."""
    world = max((int(r.get("world_size") or 1) for r in records), default=1)
    inflight = [r for r in records if r.get("state") in INFLIGHT_STATES]
    done_seq: dict[int, int] = {}
    rank_worker: dict[int, str] = {}
    for r in records:
        rank = int(r.get("rank", 0))
        rank_worker.setdefault(rank, r.get("_worker", "?"))
        if r.get("state") == "completed":
            seq = int(r.get("seq") or 0)
            if seq > done_seq.get(rank, -1):
                done_seq[rank] = seq
    frontier = max(
        (int(r.get("seq") or 0) for r in inflight),
        default=max(done_seq.values(), default=0),
    )
    waiting = []
    waited_on: set[int] = set()
    for r in sorted(inflight, key=lambda r: -float(r.get("age_s") or 0.0)):
        rank = int(r.get("rank", 0))
        peer = int(r.get("peer", -1))
        if peer >= 0:
            waited_on.add(peer)
        waiting.append({
            "rank": rank,
            "seq": int(r.get("seq") or 0),
            "age_s": float(r.get("age_s") or 0.0),
            "peer": peer,
            "state": r.get("state"),
            "site": r.get("site"),
            "trace_id": r.get("trace_id"),
            "worker": r.get("_worker"),
            "node": r.get("_node"),
        })
    waiting_ranks = {w["rank"] for w in waiting}
    missing = sorted(
        rank for rank in range(world)
        if rank not in waiting_ranks
        and done_seq.get(rank, -1) < frontier
    )
    # A rank a waiter's wire record explicitly points at is a suspect
    # even if its own evidence never arrived (dead process, lost node).
    suspects = sorted(set(missing) | (waited_on - waiting_ranks))
    sample = records[-1]
    return {
        "channel": channel,
        "group": sample.get("group"),
        "kind": sample.get("kind"),
        "tag_skeleton": channel.rsplit(":", 1)[-1],
        "world_size": world,
        "frontier_seq": frontier,
        "waiting_ranks": waiting,
        "missing_ranks": missing,
        "suspect_ranks": suspects,
        "last_completed_seq_by_rank": {
            str(k): v for k, v in sorted(done_seq.items())
        },
        "rank_worker": {str(k): v for k, v in sorted(rank_worker.items())},
    }


def build_report(
    stalls: list[dict],
    evidence: dict,
    static_sites: Optional[list[dict]] = None,
    include_stacks: bool = True,
) -> dict:
    """Merge watchdog stall events + the cluster evidence harvest into
    one hang report. Pure on its inputs (deterministic, unit-testable);
    ``static_sites=None`` means "harvest them yourself, best-effort"."""
    if static_sites is None:
        static_sites = static_comm_sites()

    records: list[dict] = []
    stacks: dict[str, Any] = {}
    nodes: set[str] = set()
    for node_id, wid, wres in _iter_worker_evidence(evidence):
        nodes.add(node_id)
        for r in wres.get("records") or []:
            r = dict(r)
            r["_worker"] = wid
            r["_node"] = node_id
            records.append(r)
        if include_stacks and wres.get("stacks"):
            stacks[wid] = {
                "node": node_id,
                "pid": wres.get("pid"),
                "current_task": wres.get("current_task"),
                "stacks": wres.get("stacks"),
                "asyncio_tasks": wres.get("asyncio_tasks", {}),
            }

    # Channels to diagnose: every channel a watchdog flagged, plus any
    # channel whose harvested records are themselves marked stalled.
    flagged = {s.get("channel") for s in stalls if s.get("channel")}
    flagged |= {
        r.get("channel") for r in records
        if r.get("stalled") and r.get("channel")
    }
    by_channel: dict[str, list[dict]] = {}
    for r in records:
        ch = r.get("channel")
        if ch in flagged:
            by_channel.setdefault(ch, []).append(r)

    channels = []
    for ch in sorted(flagged):
        recs = by_channel.get(ch)
        if not recs:
            continue
        merged = _merge_channel(ch, recs)
        merged["in_static_graph"] = channel_in_static_graph(
            merged["kind"], merged["tag_skeleton"], static_sites
        )
        merged["protocol_drift"] = merged["in_static_graph"] is False
        channels.append(merged)
    # Most suspects first: the channel pinning the most blame leads.
    channels.sort(key=lambda c: -len(c["suspect_ranks"]))

    lines = []
    for c in channels:
        who = ", ".join(f"rank {r}" for r in c["suspect_ranks"]) or "nobody"
        lines.append(
            f"{c['channel']} seq {c['frontier_seq']}: "
            f"{len(c['waiting_ranks'])}/{c['world_size']} ranks waiting, "
            f"suspect {who}"
            + (" [PROTOCOL DRIFT: channel absent from static commgraph]"
               if c["protocol_drift"] else "")
        )
    return {
        "generated_at": time.time(),
        "stall_events": list(stalls),
        "channels": channels,
        "nodes": sorted(nodes),
        "workers_reporting": len(stacks) or len({
            wid for _, wid, _ in _iter_worker_evidence(evidence)
        }),
        "stacks": stacks,
        "summary": lines,
    }


def blamed_ranks(report: dict) -> set:
    """Every rank a merged hang report points a finger at: the union of
    suspect and missing ranks across all diagnosed channels."""
    blamed: set = set()
    for ch in (report or {}).get("channels") or []:
        blamed.update(ch.get("suspect_ranks") or [])
        blamed.update(ch.get("missing_ranks") or [])
    return blamed
