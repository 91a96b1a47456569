"""The cluster controller — control plane of the framework.

Role-equivalent of the reference GCS server
(src/ray/gcs/gcs_server/gcs_server.cc [N1]) and its managers:
  * NodeManager      — gcs_node_manager.cc / gcs_health_check_manager.cc [N4]
  * Scheduler        — node selection for leases (HybridSchedulingPolicy,
                       src/ray/raylet/scheduling/scheduling_policy.cc [N10];
                       centralized here rather than per-raylet for v0)
  * ActorManager     — gcs_actor_manager.cc / gcs_actor_scheduler.cc [N2]
  * PlacementGroups  — gcs_placement_group_manager.cc (2-phase commit) [N3]
  * KV               — gcs_kv_manager.cc :: GcsInternalKVManager [N6]
  * PubSub           — src/ray/pubsub/ + gcs_publisher.cc [N8]
  * JobManager       — gcs_job_manager.cc [N5]
  * TaskEvents       — gcs_task_manager.cc (state API feed) [N5]

Runs as its own process (``python -m ray_tpu_torch._private.controller``).
State is in-memory with periodic JSON snapshot persistence to the session
dir and restore-on-restart (the reference's redis_store_client-backed GCS
fault tolerance [N7]/§5.3): agents and workers reconnect with backoff and
re-register, so named/detached actors, PGs, KV and jobs survive a
controller crash.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import itertools
import json
import os
import sys
import time
from typing import Any

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import global_config
from ray_tpu_torch._private.event_export import EventExporter
from ray_tpu_torch._private.ids import ActorID, PlacementGroupID
from ray_tpu_torch._private.rpc import RpcClient, RpcServer, ServerConnection, spawn_task
from ray_tpu_torch.util import tracing

# Bounded dedup window for mutation idempotency tokens: big enough that a
# client exhausting its chaos/reconnect retry budget is always still inside
# the window, small enough to never matter for memory.
MUTATION_CACHE_SIZE = 4096

ACTOR_STATES = ("PENDING", "ALIVE", "RESTARTING", "DEAD")
PG_STATES = ("PENDING", "CREATED", "REMOVED", "RESCHEDULING")


class _PendingLease:
    """One queued request_lease waiting for capacity, parked in the
    shape-indexed pending queue instead of polling _pick_node."""

    __slots__ = ("future", "resources", "submitter", "strategy", "demand_id")

    def __init__(self, future, resources, submitter, strategy, demand_id):
        self.future = future
        self.resources = resources
        self.submitter = submitter
        self.strategy = strategy
        self.demand_id = demand_id


def _jsonify(obj):
    """JSON-compatible deep copy; bytes become {"__b64__": ...} (actor
    specs carry pickled creation args, KV values are bytes)."""
    import base64

    if isinstance(obj, bytes):
        return {"__b64__": base64.b64encode(obj).decode()}
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj


def _dejsonify(obj):
    import base64

    if isinstance(obj, dict):
        if set(obj) == {"__b64__"}:
            return base64.b64decode(obj["__b64__"])
        return {k: _dejsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dejsonify(v) for v in obj]
    return obj


class NodeInfo:
    def __init__(self, payload: dict):
        self.node_id: str = payload["node_id"]
        self.agent_addr: tuple = tuple(payload["agent_addr"])
        self.resources_total: dict = dict(payload["resources"])
        self.resources_available: dict = dict(payload["resources"])
        self.store_info: dict = payload["store_info"]
        self.labels: dict = payload.get("labels", {})
        self.last_heartbeat = time.monotonic()
        self.alive = True
        self.client: RpcClient | None = None
        self.stats: dict = {}  # piggybacked heartbeat stats (queue depths)

    def snapshot(self) -> dict:
        return {
            "node_id": self.node_id,
            "agent_addr": list(self.agent_addr),
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "labels": self.labels,
            "alive": self.alive,
            "store_info": self.store_info,
        }


class ActorInfo:
    def __init__(self, spec: dict):
        self.actor_id: str = spec["actor_id"]
        self.spec = spec
        self.state = "PENDING"
        self.address: tuple | None = None
        self.node_id: str | None = None
        self.worker_id: str | None = None
        self.restarts_remaining: int = spec.get("max_restarts", 0)
        self.name: str | None = spec.get("name") or None
        self.detached: bool = spec.get("lifetime") == "detached"
        self.job_id: str = spec.get("job_id", "")
        self.death_cause: str | None = None
        self.ready_event = asyncio.Event()

    def snapshot(self) -> dict:
        return {
            "actor_id": self.actor_id,
            "state": self.state,
            "name": self.name,
            "node_id": self.node_id,
            "pid": self.spec.get("pid"),
            "class_name": self.spec.get("class_name"),
            "job_id": self.job_id,
            "detached": self.detached,
            "restarts_remaining": self.restarts_remaining,
            "death_cause": self.death_cause,
        }


class PlacementGroupInfo:
    def __init__(self, pg_id: str, bundles: list[dict], strategy: str, name: str, job_id: str):
        self.pg_id = pg_id
        self.bundles = bundles              # list of resource dicts
        self.strategy = strategy
        self.name = name
        self.job_id = job_id
        self.state = "PENDING"
        self.bundle_nodes: list[str | None] = [None] * len(bundles)
        self.ready_event = asyncio.Event()

    def snapshot(self) -> dict:
        return {
            "pg_id": self.pg_id,
            "state": self.state,
            "strategy": self.strategy,
            "name": self.name,
            "bundles": self.bundles,
            "bundle_nodes": self.bundle_nodes,
            "job_id": self.job_id,
        }


class Controller:
    def __init__(self, session_dir: str):
        self.session_dir = session_dir
        tracing.configure(session_dir)
        self.server = RpcServer(name="controller")
        self.server.on_disconnect = self._on_disconnect
        self.nodes: dict[str, NodeInfo] = {}
        self.actors: dict[str, ActorInfo] = {}
        self.named_actors: dict[tuple, str] = {}  # (namespace, name) -> actor_id
        self.pgs: dict[str, PlacementGroupInfo] = {}
        self.kv: dict[str, dict[str, bytes]] = collections.defaultdict(dict)
        self.jobs: dict[str, dict] = {}
        self.clients: dict[str, dict] = {}  # worker/driver registry
        self.subscribers: dict[str, set[ServerConnection]] = collections.defaultdict(set)
        self.task_events: collections.deque = collections.deque(
            maxlen=global_config().task_events_max_buffer
        )
        # Queued-but-unplaceable resource demands, for the autoscaler [N4].
        self.pending_demands: dict[str, dict] = {}
        self.events = EventExporter(session_dir)
        # Resource-telemetry time-series store: node samples
        # arrive piggybacked on heartbeats and land in bounded, tiered
        # rings (raw → 10s → 60s) — multi-hour runs stay O(MB).
        from ray_tpu_torch._private.telemetry import TelemetryStore

        _cfg = global_config()
        self.telemetry = TelemetryStore(
            raw_capacity=_cfg.telemetry_raw_capacity,
            cap_10s=_cfg.telemetry_10s_capacity,
            cap_60s=_cfg.telemetry_60s_capacity,
        )
        self._rr = itertools.count()
        # --- control-plane scale-out machinery ---
        # Capacity pulse: schedulers park on the CURRENT event; a capacity
        # gain swaps in a fresh event and sets the old one, so waiters wake
        # exactly once per gain with no clear() races.
        self._capacity_event = asyncio.Event()
        # request_lease queue indexed by (resource shape, strategy key):
        # infeasibility is decided once per SHAPE per capacity change, not
        # once per queued request per 200 ms poll. O(1) pop on grant.
        self._pending_leases: dict[tuple, collections.deque] = {}
        self._lease_drain_scheduled = False
        self._demand_seq = itertools.count()
        # Pubsub outbox: events queue per subscriber connection and flush
        # as ONE batched push frame per connection per loop tick instead
        # of one awaited frame per (event x subscriber).
        self._pub_outbox: dict[ServerConnection, list] = {}
        self._pub_flush_scheduled = False
        # Counters the scale suite and /metrics read via controller_stats.
        self.stats_counters = collections.Counter()
        # Comm hang doctor: recent watchdog stall events and
        # the merged cluster-wide hang reports built from the evidence
        # harvests they trigger. Bounded: stalls are small dicts, reports
        # carry stacks.
        self._comm_stalls: collections.deque = collections.deque(maxlen=256)
        self._hang_reports: collections.deque = collections.deque(maxlen=8)
        self._hang_harvest_task: asyncio.Task | None = None
        self._last_hang_harvest = 0.0
        # Cluster step profiler: completed capture records
        # (small dicts pointing at session-dir artifacts) + the single
        # in-flight capture task. Auto-captures (straggler / comm-stall
        # triggered) are cooldown-guarded here — the controller is the
        # authority, whatever the trigger side rate-limits.
        self._profiles: collections.deque = collections.deque(maxlen=32)
        self._profile_task: asyncio.Task | None = None
        self._last_auto_profile = 0.0
        self._profile_seq = itertools.count()
        # Idempotency-token reply cache for mutation RPCs: a client that
        # retried after a dropped/duplicated reply (or a controller
        # restart) gets the ORIGINAL reply back instead of re-applying
        # the mutation (exactly-once effect over at-least-once delivery).
        # Persisted in the snapshot so dedup survives a restart.
        self._mutation_replies: collections.OrderedDict[str, dict] = (
            collections.OrderedDict()
        )
        chaos.set_identity("controller")
        # Persistence (role-equivalent of the reference's
        # redis_store_client-backed GCS tables [N7]: restart the control
        # plane and the cluster survives). Snapshots are JSON (bytes
        # base64-wrapped) written by _snapshot_loop through a PLUGGABLE
        # store: file (default), memory, or an external wire-v1 KV
        # service (kv://host:port — head-disk loss no longer loses the
        # cluster). Selected via RAY_TPU_controller_store.
        from ray_tpu_torch._private.snapshot_store import make_store

        self.store = make_store(
            global_config().controller_store, session_dir
        )
        print(
            f"[controller] persistence: {self.store.describe()}",
            file=sys.stderr, flush=True,
        )
        self._dirty = False
        # Incremental snapshot state: per-entry serialized JSON fragments
        # for the big tables (actors/pgs/kv) are cached and only dirty
        # keys re-serialize — a 2k-actor table no longer re-encodes in
        # full every snapshot tick (see _build_snapshot_blob).
        self._snap_frag: dict[str, dict] = {"actors": {}, "pgs": {}, "kv": {}}
        self._snap_dirty: dict[str, set] = {
            "actors": set(), "pgs": set(), "kv": set()
        }
        self._snap_all_dirty = True
        self._snap_stats = {
            "saves": 0, "last_bytes": 0, "last_build_ms": 0.0,
            "frags_rebuilt": 0,
        }
        self._restored = self._load_snapshot()

    # ------------------------------------------------------------------
    async def start(self, host: str, port: int) -> int:
        self.server.route_object(self)
        bound = await self.server.start(host, port)
        spawn_task(self._health_check_loop())
        spawn_task(self._snapshot_loop())
        if self._restored:
            spawn_task(self._post_restore_reconcile())
        else:
            for actor in self.actors.values():
                if actor.state in ("PENDING", "RESTARTING"):
                    spawn_task(self._schedule_actor(actor))
            for pg in self.pgs.values():
                if pg.state in ("PENDING", "RESCHEDULING"):
                    spawn_task(self._schedule_pg(pg))
        return bound

    async def _post_restore_reconcile(self) -> None:
        """After a restart: give agents a grace period to re-register (they
        re-attach still-live actors and report their bundle reservations),
        THEN resume interrupted scheduling and fail actors stranded on
        nodes that never came back."""
        cfg = global_config()
        grace = max(
            2.0,
            2 * cfg.health_check_period_ms / 1000.0,
        )
        await asyncio.sleep(grace)
        for actor in list(self.actors.values()):
            if actor.state in ("PENDING", "RESTARTING"):
                spawn_task(self._schedule_actor(actor))
            elif actor.state == "ALIVE" and actor.node_id not in self.nodes:
                # Node never re-registered after the restart window.
                await self._handle_actor_failure(
                    actor, f"node {actor.node_id} lost across controller restart"
                )
        for pg in self.pgs.values():
            if pg.state in ("PENDING", "RESCHEDULING"):
                spawn_task(self._schedule_pg(pg))
            elif pg.state == "CREATED" and any(
                n is not None and n not in self.nodes for n in pg.bundle_nodes
            ):
                pg.state = "RESCHEDULING"
                pg.ready_event.clear()
                for i, nid in enumerate(pg.bundle_nodes):
                    if nid is not None and nid not in self.nodes:
                        pg.bundle_nodes[i] = None
                self._mark_dirty("pgs", pg.pg_id)
                spawn_task(self._schedule_pg(pg))

    # ------------------------------------------------------------------
    # mutation idempotency tokens
    # ------------------------------------------------------------------
    def _mutation_cached(self, payload) -> dict | None:
        token = payload.get("mutation_token") if isinstance(payload, dict) else None
        if token is None:
            return None
        reply = self._mutation_replies.get(token)
        if reply is not None:
            self._mutation_replies.move_to_end(token)
        return reply

    def _mutation_record(self, payload, reply: dict) -> dict:
        token = payload.get("mutation_token") if isinstance(payload, dict) else None
        if token is not None:
            self._mutation_replies[token] = reply
            self._mutation_replies.move_to_end(token)
            while len(self._mutation_replies) > MUTATION_CACHE_SIZE:
                self._mutation_replies.popitem(last=False)
            self._mark_dirty()
        return reply

    # ------------------------------------------------------------------
    # persistence [N7]
    # ------------------------------------------------------------------
    def _mark_dirty(self, section: str | None = None, key=None) -> None:
        """Flag state changed. ``section``/``key`` scope the change to one
        entry of an incrementally-snapshotted table ("actors"/"pgs"/"kv");
        section=None means only the always-fresh small sections (jobs,
        named_actors, mutation cache) moved."""
        self._dirty = True
        if section is not None:
            self._snap_dirty[section].add(key)

    @staticmethod
    def _actor_frag(a: ActorInfo) -> str:
        return json.dumps(_jsonify({
            "spec": a.spec,
            "state": a.state,
            "address": list(a.address) if a.address else None,
            "node_id": a.node_id,
            "worker_id": a.worker_id,
            "restarts_remaining": a.restarts_remaining,
            "death_cause": a.death_cause,
        }))

    @staticmethod
    def _pg_frag(p: PlacementGroupInfo) -> str:
        return json.dumps(_jsonify({
            "bundles": p.bundles,
            "strategy": p.strategy,
            "name": p.name,
            "job_id": p.job_id,
            "state": p.state,
            "bundle_nodes": p.bundle_nodes,
        }))

    def _refresh_snapshot_frags(self) -> int:
        """Bring the cached per-entry fragments up to date; returns how
        many fragments were re-serialized this pass."""
        frags = self._snap_frag
        dirty = self._snap_dirty
        rebuilt = 0
        if self._snap_all_dirty:
            self._snap_all_dirty = False
            for s in dirty.values():
                s.clear()
            frags["actors"] = {
                aid: self._actor_frag(a) for aid, a in self.actors.items()
            }
            frags["pgs"] = {
                pid: self._pg_frag(p) for pid, p in self.pgs.items()
            }
            frags["kv"] = {
                (ns, k): json.dumps(_jsonify([ns, k, v]))
                for ns, kvs in self.kv.items()
                for k, v in kvs.items()
            }
            return (
                len(frags["actors"]) + len(frags["pgs"]) + len(frags["kv"])
            )
        for aid in dirty["actors"]:
            a = self.actors.get(aid)
            if a is None:
                frags["actors"].pop(aid, None)
            else:
                frags["actors"][aid] = self._actor_frag(a)
                rebuilt += 1
        for pid in dirty["pgs"]:
            p = self.pgs.get(pid)
            if p is None:
                frags["pgs"].pop(pid, None)
            else:
                frags["pgs"][pid] = self._pg_frag(p)
                rebuilt += 1
        for ns_key in dirty["kv"]:
            ns, k = ns_key
            v = self.kv.get(ns, {}).get(k)
            if v is None:
                frags["kv"].pop(ns_key, None)
            else:
                frags["kv"][ns_key] = json.dumps(_jsonify([ns, k, v]))
                rebuilt += 1
        for s in dirty.values():
            s.clear()
        return rebuilt

    def _build_snapshot_blob(self) -> bytes:
        """Runs ON the event loop: the state walk must be atomic w.r.t.
        handlers mutating actors/pgs/kv — only the (pure) store write is
        pushed to a worker thread. Incremental: the big tables assemble
        from cached per-entry fragments (only dirty keys re-serialize);
        the small sections (jobs, named actors, mutation-token cache) are
        serialized fresh each build."""
        start = time.perf_counter()
        rebuilt = self._refresh_snapshot_frags()
        frags = self._snap_frag
        parts = [
            '"actors":{'
            + ",".join(
                f"{json.dumps(aid)}:{frag}"
                for aid, frag in frags["actors"].items()
            )
            + "}",
            '"pgs":{'
            + ",".join(
                f"{json.dumps(pid)}:{frag}"
                for pid, frag in frags["pgs"].items()
            )
            + "}",
            '"kv_flat":[' + ",".join(frags["kv"].values()) + "]",
            '"named_actors":'
            + json.dumps([
                [ns, name, aid]
                for (ns, name), aid in self.named_actors.items()
            ]),
            '"jobs":' + json.dumps(_jsonify(self.jobs)),
            # Token cache rides along so mutation dedup spans restarts: a
            # client retrying across a controller crash still gets its
            # original reply, not a re-application.
            '"mutations":'
            + json.dumps(_jsonify(list(self._mutation_replies.items()))),
        ]
        blob = ("{" + ",".join(parts) + "}").encode()
        self._snap_stats["last_bytes"] = len(blob)
        self._snap_stats["last_build_ms"] = (
            (time.perf_counter() - start) * 1000.0
        )
        self._snap_stats["frags_rebuilt"] = rebuilt
        self._snap_stats["saves"] += 1
        return blob

    def _load_snapshot(self) -> bool:
        blob = None
        last_exc = None
        for attempt in range(5):
            try:
                blob = self.store.load()
                last_exc = None
                break
            except Exception as exc:
                last_exc = exc
                time.sleep(0.5 * (attempt + 1))
        if last_exc is not None:
            # An UNREACHABLE store is not the same as an EMPTY one:
            # booting fresh would later overwrite the good external
            # snapshot with empty state. Fail the boot; the operator (or
            # supervisor restart loop) retries once the store is back.
            raise RuntimeError(
                f"snapshot store {self.store.describe()} unreachable at "
                f"boot: {last_exc}"
            )
        if blob is None:
            return False
        try:
            state = _dejsonify(json.loads(blob))
        except Exception as exc:
            print(
                f"[controller] snapshot load failed: {exc}",
                file=sys.stderr, flush=True,
            )
            return False
        for aid, rec in state.get("actors", {}).items():
            actor = ActorInfo(rec["spec"])
            actor.state = rec["state"]
            actor.address = tuple(rec["address"]) if rec["address"] else None
            actor.node_id = rec["node_id"]
            actor.worker_id = rec["worker_id"]
            actor.restarts_remaining = rec["restarts_remaining"]
            actor.death_cause = rec["death_cause"]
            if actor.state in ("ALIVE", "DEAD"):
                actor.ready_event.set()
            self.actors[aid] = actor
        for ns, name, aid in state.get("named_actors", []):
            self.named_actors[(ns, name)] = aid
        for pid, rec in state.get("pgs", {}).items():
            pg = PlacementGroupInfo(
                pid, rec["bundles"], rec["strategy"], rec["name"], rec["job_id"]
            )
            pg.state = rec["state"]
            pg.bundle_nodes = rec["bundle_nodes"]
            if pg.state == "CREATED":
                pg.ready_event.set()
            self.pgs[pid] = pg
        for ns, kvs in state.get("kv", {}).items():  # legacy nested format
            self.kv[ns].update(kvs)
        for ns, k, v in state.get("kv_flat", []):
            self.kv[ns][k] = v
        self.jobs.update(state.get("jobs", {}))
        for token, reply in state.get("mutations", []):
            self._mutation_replies[token] = reply
        print(
            f"[controller] restored snapshot: {len(self.actors)} actors, "
            f"{len(self.pgs)} pgs, {sum(len(v) for v in self.kv.values())} kv keys",
            file=sys.stderr, flush=True,
        )
        return True

    async def _snapshot_loop(self) -> None:
        period = global_config().controller_snapshot_period_s
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(period)
            if not self._dirty:
                continue
            self._dirty = False
            try:
                # Chaos probe for the dirty-bit retry path below: an armed
                # "controller.snapshot_save" fail-point loses the write
                # exactly like a store outage between write and ack would.
                chaos.failpoint("controller.snapshot_save")
                blob = self._build_snapshot_blob()  # on-loop: consistent
                # executor: an external store's socket write must not
                # stall the control plane's event loop.
                await loop.run_in_executor(None, self.store.timed_save, blob)
            except Exception as exc:
                self._dirty = True  # retry next tick; don't lose the state
                print(
                    f"[controller] snapshot write failed: {exc}",
                    file=sys.stderr, flush=True,
                )

    async def _node_client(self, node: NodeInfo) -> RpcClient:
        if node.client is None or not node.client.connected:
            node.client = RpcClient(node.agent_addr, name=f"to-agent-{node.node_id[:10]}")
            node.client.chaos_peer = f"node:{node.node_id}"
            await node.client.connect()
        return node.client

    # ------------------------------------------------------------------
    # pubsub [N8]
    # ------------------------------------------------------------------
    async def rpc_subscribe(self, conn: ServerConnection, payload) -> dict:
        for channel in payload["channels"]:
            self.subscribers[channel].add(conn)
        conn.context.setdefault("subscriptions", set()).update(payload["channels"])
        return {"status": "ok"}

    async def publish(self, channel: str, message: Any) -> None:
        # Every lifecycle broadcast also lands in the structured export
        # files (event.cc/N28 role): pubsub reaches connected subscribers,
        # the export reaches external consumers after the fact.
        self.events.emit(channel, message)
        subs = self.subscribers.get(channel)
        if not subs:
            return
        # Queue per connection; one batched push frame per connection per
        # loop tick (a 2k-event burst costs each subscriber one frame, not
        # 2k awaited sends serialized through the handler).
        dead = []
        for conn in subs:
            if conn.closed.is_set():
                dead.append(conn)
                continue
            self._pub_outbox.setdefault(conn, []).append((channel, message))
        for conn in dead:
            subs.discard(conn)
        if self._pub_outbox and not self._pub_flush_scheduled:
            self._pub_flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._spawn_pub_flush)

    def _spawn_pub_flush(self) -> None:
        spawn_task(self._flush_pubsub())

    async def _flush_pubsub(self) -> None:
        self._pub_flush_scheduled = False
        outbox = self._pub_outbox
        if not outbox:
            return
        self._pub_outbox = {}
        for conn, items in outbox.items():
            if conn.closed.is_set():
                continue
            self.stats_counters["pubsub_frames"] += 1
            self.stats_counters["pubsub_events"] += len(items)
            try:
                if len(items) == 1:
                    await conn.push(items[0][0], items[0][1])
                else:
                    # Client-side demux in rpc._ClientCallMixin._handle_push.
                    await conn.push(
                        "__pub_batch__", [[c, m] for c, m in items]
                    )
            except Exception:  # rtlint: disable=swallowed-exception - dead subscriber conn; pruned on disconnect
                pass

    async def rpc_publish(self, conn, payload) -> dict:
        await self.publish(payload["channel"], payload["message"])
        return {"status": "ok"}

    # ------------------------------------------------------------------
    # capacity wakeups (event-driven scheduling, no poll loops)
    # ------------------------------------------------------------------
    def _notify_capacity(self) -> None:
        """Cluster capacity may have grown (node registered, heartbeat
        reported freed resources, PG became placeable). Pulse the parked
        schedulers and drain the shape-indexed pending-lease queue —
        coalesced to one drain per loop tick however many notifications
        land in a burst."""
        event = self._capacity_event
        self._capacity_event = asyncio.Event()
        event.set()
        if self._pending_leases and not self._lease_drain_scheduled:
            self._lease_drain_scheduled = True
            asyncio.get_running_loop().call_soon(self._drain_pending_leases)

    async def _wait_for_capacity(self, timeout: float) -> None:
        """Park until the next capacity pulse (or timeout as a safety
        net). Grab the event BEFORE awaiting: a pulse between the check
        and the wait must not be lost."""
        event = self._capacity_event
        try:
            await asyncio.wait_for(event.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    # ------------------------------------------------------------------
    # node management [N4] + health checks
    # ------------------------------------------------------------------
    async def rpc_register_node(self, conn: ServerConnection, payload) -> dict:
        node = NodeInfo(payload)
        self.nodes[node.node_id] = node
        conn.context["node_id"] = node.node_id
        # Post-restart reconciliation: the agent reports the actors it
        # still hosts. Restored ALIVE actors missing from the report died
        # while the controller was down; reported actors whose snapshot
        # predates their ALIVE transition are re-attached in place (never
        # double-scheduled).
        live_entries = payload.get("live_actors") or []
        live = {e["actor_id"] if isinstance(e, dict) else e for e in live_entries}
        # Ghost workers: a partitioned-then-healed node re-registers still
        # hosting actors the controller failed over in the meantime (DEAD,
        # or ALIVE again on a DIFFERENT node). Tell the agent so it kills
        # them instead of serving two incarnations of one actor.
        stale_actors: list[dict] = []
        for entry in live_entries:
            if not isinstance(entry, dict):
                continue
            actor = self.actors.get(entry["actor_id"])
            if actor is not None and actor.state in ("PENDING", "RESTARTING"):
                actor.node_id = node.node_id
                actor.worker_id = entry.get("worker_id")
                if entry.get("addr"):
                    actor.address = tuple(entry["addr"])
                actor.state = "ALIVE"
                actor.ready_event.set()
                self._mark_dirty("actors", actor.actor_id)
            elif actor is None or actor.state == "DEAD" or (
                actor.state == "ALIVE" and actor.node_id != node.node_id
            ):
                stale_actors.append(
                    {"actor_id": entry["actor_id"],
                     "worker_id": entry.get("worker_id")}
                )
        for actor in list(self.actors.values()):
            if (
                actor.node_id == node.node_id
                and actor.state == "ALIVE"
                and actor.actor_id not in live
            ):
                await self._handle_actor_failure(
                    actor, "worker died during controller restart"
                )
        # Release phase-1 bundle reservations the agent still holds for
        # placement groups this incarnation no longer accounts to it
        # (2PC prepare leaked across a controller crash).
        stale: list[int | str] = []
        for entry in payload.get("held_bundles") or []:
            pg_id, index = entry["pg_id"], entry["index"]
            pg = self.pgs.get(pg_id)
            if (
                pg is None
                or pg.state == "REMOVED"
                or index >= len(pg.bundle_nodes)
                or pg.bundle_nodes[index] != node.node_id
            ):
                stale.append(entry)
        if stale:
            spawn_task(self._release_stale_bundles(node, stale))
        await self.publish("node_added", node.snapshot())
        self._notify_capacity()
        await self._retry_pending()
        return {"status": "ok", "stale_actors": stale_actors}

    async def _release_stale_bundles(self, node: NodeInfo, stale: list) -> None:
        try:
            client = await self._node_client(node)
            for entry in stale:
                await client.call(
                    "release_bundle",
                    {"pg_id": entry["pg_id"], "bundle_index": entry["index"]},
                )
        except Exception:  # rtlint: disable=swallowed-exception - node unreachable: its death frees the bundles anyway
            pass

    async def rpc_heartbeat(self, conn, payload) -> dict:
        node = self.nodes.get(payload["node_id"])
        if node is None:
            return {"status": "unknown_node"}
        if not node.alive:
            # The node was declared dead (partition outlasted the health
            # timeout): its actors were failed over and its PG bundles
            # rescheduled. Silently flipping alive=True here would leave
            # it half-dead — carrying workers the controller no longer
            # accounts to it and missing everything scheduled since.
            # Make it re-register: the register path reconciles live
            # actors/bundles and tells the agent which workers are stale.
            return {"status": "reregister"}
        node.last_heartbeat = time.monotonic()
        prev = node.resources_available
        fresh = payload["resources_available"]
        node.resources_available = fresh
        if payload.get("stats") is not None:
            # Agents piggyback queue-depth/engine counters on the
            # heartbeat they already send — no extra stats RPC fan-in.
            node.stats = payload["stats"]
        if payload.get("telemetry"):
            # Resource samples ride the same beat; the store's monotonic
            # guard drops chaos-duplicated/replayed samples.
            self.telemetry.add_many(node.node_id, payload["telemetry"])
        self.stats_counters["heartbeats"] += 1
        # Wake parked schedulers only on a capacity GAIN: a steady-state
        # heartbeat from each of N nodes per tick must not trigger N
        # rescheduling sweeps.
        for key, value in fresh.items():
            if value > prev.get(key, 0.0) + 1e-9:
                self._notify_capacity()
                break
        return {"status": "ok"}

    async def _health_check_loop(self) -> None:
        cfg = global_config()
        period = cfg.health_check_period_ms / 1000.0
        timeout = (
            cfg.health_check_timeout_ms * cfg.health_check_failure_threshold / 1000.0
        )
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for node in list(self.nodes.values()):
                if node.alive and now - node.last_heartbeat > timeout:
                    await self._on_node_death(node)
            # Safety-net drain: pending leases are normally woken by
            # capacity pulses; this sweep bounds the wait if a pulse was
            # missed (e.g. a heartbeat-less test mutates node state).
            if self._pending_leases and not self._lease_drain_scheduled:
                self._lease_drain_scheduled = True
                asyncio.get_running_loop().call_soon(
                    self._drain_pending_leases
                )

    async def _on_node_death(self, node: NodeInfo) -> None:
        node.alive = False
        await self.publish("node_removed", {"node_id": node.node_id})
        # Fail actors on the node; restart the restartable ones.
        for actor in list(self.actors.values()):
            if actor.node_id == node.node_id and actor.state in ("ALIVE", "PENDING"):
                await self._handle_actor_failure(actor, f"node {node.node_id} died")
        # Reschedule placement-group bundles that lived there.
        for pg in self.pgs.values():
            if pg.state == "CREATED" and node.node_id in pg.bundle_nodes:
                pg.state = "RESCHEDULING"
                pg.ready_event.clear()
                for i, nid in enumerate(pg.bundle_nodes):
                    if nid == node.node_id:
                        pg.bundle_nodes[i] = None
                self._mark_dirty("pgs", pg.pg_id)
                spawn_task(self._schedule_pg(pg))

    async def _on_disconnect(self, conn: ServerConnection) -> None:
        node_id = conn.context.get("node_id")
        if node_id and node_id in self.nodes:
            node = self.nodes[node_id]
            if node.alive:
                await self._on_node_death(node)
        client_id = conn.context.get("client_id")
        if client_id:
            info = self.clients.pop(client_id, None)
            if info and info.get("is_driver"):
                await self._on_driver_exit(info["job_id"])
        for channel in conn.context.get("subscriptions", ()):
            self.subscribers[channel].discard(conn)

    # ------------------------------------------------------------------
    # clients / jobs [N5]
    # ------------------------------------------------------------------
    async def rpc_register_client(self, conn: ServerConnection, payload) -> dict:
        self.clients[payload["worker_id"]] = payload
        conn.context["client_id"] = payload["worker_id"]
        if payload.get("is_driver"):
            job_id = payload["job_id"]
            self.jobs.setdefault(
                job_id,
                {
                    "job_id": job_id,
                    "driver_id": payload["worker_id"],
                    "start_time": time.time(),
                    "state": "RUNNING",
                },
            )
            self.events.emit("job_started", {"job_id": job_id})
            self._mark_dirty()
        return {"status": "ok"}

    async def _on_driver_exit(self, job_id: str) -> None:
        job = self.jobs.get(job_id)
        if job:
            job["state"] = "FINISHED"
            job["end_time"] = time.time()
            self._mark_dirty()
        # Kill non-detached actors of the job.
        for actor in list(self.actors.values()):
            if actor.job_id == job_id and not actor.detached and actor.state != "DEAD":
                await self._kill_actor(actor, "driver exited", no_restart=True)
        # Remove the job's placement groups.
        for pg in list(self.pgs.values()):
            if pg.job_id == job_id and pg.state != "REMOVED":
                await self._remove_pg(pg)
        await self.publish("job_finished", {"job_id": job_id})

    async def rpc_list_jobs(self, conn, payload) -> list:
        return list(self.jobs.values())

    # ------------------------------------------------------------------
    # KV [N6]
    # ------------------------------------------------------------------
    async def rpc_kv_put(self, conn, payload) -> dict:
        # Without a token, a retried overwrite=False put whose first reply
        # was dropped comes back "exists" — the caller can't tell its own
        # earlier write from a genuine conflict. The cache returns the
        # original "ok" instead.
        cached = self._mutation_cached(payload)
        if cached is not None:
            return cached
        ns = payload.get("namespace", "default")
        overwrite = payload.get("overwrite", True)
        if not overwrite and payload["key"] in self.kv[ns]:
            return self._mutation_record(payload, {"status": "exists"})
        self.kv[ns][payload["key"]] = payload["value"]
        self._mark_dirty("kv", (ns, payload["key"]))
        return self._mutation_record(payload, {"status": "ok"})

    async def rpc_kv_multi_put(self, conn, payload) -> dict:
        """Batched kv_put: one RPC carries many entries (the metrics
        flusher sends its whole tick in one call). Idempotent as a unit
        via the same mutation-token cache as kv_put."""
        cached = self._mutation_cached(payload)
        if cached is not None:
            return cached
        ns = payload.get("namespace", "default")
        overwrite = payload.get("overwrite", True)
        statuses = []
        for entry in payload.get("entries", ()):
            key = entry["key"]
            if not overwrite and key in self.kv[ns]:
                statuses.append("exists")
                continue
            self.kv[ns][key] = entry["value"]
            self._mark_dirty("kv", (ns, key))
            statuses.append("ok")
        return self._mutation_record(
            payload, {"status": "ok", "statuses": statuses}
        )

    async def rpc_kv_get(self, conn, payload) -> dict:
        ns = payload.get("namespace", "default")
        value = self.kv[ns].get(payload["key"])
        return {"status": "ok" if value is not None else "missing", "value": value}

    async def rpc_kv_del(self, conn, payload) -> dict:
        cached = self._mutation_cached(payload)
        if cached is not None:
            return cached
        ns = payload.get("namespace", "default")
        existed = self.kv[ns].pop(payload["key"], None) is not None
        if existed:
            self._mark_dirty("kv", (ns, payload["key"]))
        return self._mutation_record(
            payload, {"status": "ok", "existed": existed}
        )

    async def rpc_kv_keys(self, conn, payload) -> list:
        ns = payload.get("namespace", "default")
        prefix = payload.get("prefix", "")
        return [k for k in self.kv[ns] if k.startswith(prefix)]

    # ------------------------------------------------------------------
    # lease scheduling (HybridSchedulingPolicy-flavored) [N10]
    # ------------------------------------------------------------------
    def _fits(self, node: NodeInfo, resources: dict) -> bool:
        for key, need in resources.items():
            if need <= 0:
                continue
            if node.resources_available.get(key, 0.0) + 1e-9 < need:
                return False
        return True

    def _fits_total(self, node: NodeInfo, resources: dict) -> bool:
        return all(
            node.resources_total.get(k, 0.0) + 1e-9 >= v
            for k, v in resources.items()
            if v > 0
        )

    def _utilization(self, node: NodeInfo) -> float:
        # Allocation-free max: this runs per (node x scheduling decision)
        # and shows up first in 32-node profiles.
        best = 0.0
        available = node.resources_available
        for key, total in node.resources_total.items():
            if total > 0:
                frac = (total - available.get(key, 0.0)) / total
                if frac > best:
                    best = frac
        return best

    def _pick_node(self, resources: dict, submitter_node: str | None, strategy: dict) -> NodeInfo | None:
        alive = [n for n in self.nodes.values() if n.alive]
        if not alive:
            return None
        kind = strategy.get("kind", "")
        if kind == "pg":
            pg = self.pgs.get(strategy["pg_id"])
            if pg is None or pg.state != "CREATED":
                return None
            index = strategy.get("bundle_index", -1)
            candidates = (
                [pg.bundle_nodes[index]]
                if index >= 0
                else [n for n in pg.bundle_nodes]
            )
            for node_id in candidates:
                node = self.nodes.get(node_id or "")
                if node and node.alive:
                    return node
            return None
        if kind == "node_affinity":
            node = self.nodes.get(strategy["node_id"])
            if node and node.alive and self._fits(node, resources):
                return node
            if strategy.get("soft"):
                pass  # fall through to default policy
            else:
                return None
        if kind == "SPREAD":
            feasible = [n for n in alive if self._fits(n, resources)]
            if not feasible:
                feasible = [n for n in alive if self._fits_total(n, resources)]
            if not feasible:
                return None
            return feasible[next(self._rr) % len(feasible)]
        # Hybrid policy: prefer the submitter's node while its utilization is
        # below the spread threshold, else best-fit across the cluster
        # (scheduling_policy.cc :: HybridSchedulingPolicy).
        threshold = global_config().scheduler_spread_threshold
        local = self.nodes.get(submitter_node or "")
        if (
            local is not None
            and local.alive
            and self._fits(local, resources)
            and self._utilization(local) < threshold
        ):
            return local
        feasible = [n for n in alive if self._fits(n, resources)]
        if feasible:
            return min(feasible, key=self._utilization)
        feasible_total = [n for n in alive if self._fits_total(n, resources)]
        if feasible_total:
            return min(feasible_total, key=self._utilization)
        return None

    async def rpc_get_load(self, conn, payload) -> dict:
        """Aggregated resource load for the autoscaler (reference:
        gcs_resource_manager.cc resource load reports → autoscaler)."""
        return {
            "pending_demands": list(self.pending_demands.values()),
            # Unplaced placement groups (autoscaler v2 input: a pending
            # pod-slice PG is THE TPU-native scale-up signal — slices are
            # allocated whole, not host by host).
            "pending_pgs": [
                {
                    "pg_id": pid,
                    "strategy": pg.strategy,
                    "bundles": pg.bundles,
                }
                for pid, pg in self.pgs.items()
                if pg.state in ("PENDING", "RESCHEDULING")
            ],
            "nodes": [
                {
                    "node_id": n.node_id,
                    "alive": n.alive,
                    "resources_total": n.resources_total,
                    "resources_available": n.resources_available,
                }
                for n in self.nodes.values()
            ],
        }

    @staticmethod
    def _lease_shape(resources: dict, strategy: dict) -> tuple:
        """Canonical queue key: requests with equal shape+strategy are
        feasibility-equivalent, so one _pick_node probe decides for the
        whole bucket."""
        kind = strategy.get("kind", "")
        if kind == "pg":
            extra = ("pg", strategy["pg_id"], strategy.get("bundle_index", -1))
        elif kind == "node_affinity":
            extra = ("node", strategy["node_id"], bool(strategy.get("soft")))
        elif kind:
            extra = (kind,)
        else:
            extra = ()
        return (
            tuple(sorted(
                (k, float(v)) for k, v in resources.items() if v > 0
            )),
            extra,
        )

    def _drain_pending_leases(self) -> None:
        """One pass over the pending-lease queue, run as a loop callback
        after a capacity gain. Per SHAPE: one infeasibility probe rejects
        the whole bucket in O(1); feasible buckets pop waiters until the
        shape stops fitting."""
        self._lease_drain_scheduled = False
        if not self._pending_leases:
            return
        for shape in list(self._pending_leases):
            waiters = self._pending_leases.get(shape)
            while waiters:
                req = waiters[0]
                if req.future.done():  # timed out / disconnected
                    waiters.popleft()
                    continue
                node = self._pick_node(req.resources, req.submitter,
                                       req.strategy)
                if node is None:
                    break  # shape still infeasible: bucket stays parked
                waiters.popleft()
                self.pending_demands.pop(req.demand_id, None)
                self.stats_counters["lease_queue_grants"] += 1
                req.future.set_result(node)
            if not waiters:
                self._pending_leases.pop(shape, None)

    async def _queue_lease_request(
        self, resources: dict, submitter: str | None, strategy: dict,
        timeout: float,
    ) -> NodeInfo | None:
        """Park an unplaceable lease request until capacity shows up (the
        reference queues in raylets; we queue here). Queued demand stays
        visible to the autoscaler via pending_demands."""
        demand_id = f"lease-{next(self._demand_seq)}"
        future = asyncio.get_running_loop().create_future()
        req = _PendingLease(future, resources, submitter, strategy, demand_id)
        shape = self._lease_shape(resources, strategy)
        self._pending_leases.setdefault(shape, collections.deque()).append(req)
        self.pending_demands[demand_id] = dict(resources)
        self.stats_counters["lease_queue_enqueued"] += 1
        try:
            return await asyncio.wait_for(future, timeout)
        except asyncio.TimeoutError:
            return None
        finally:
            self.pending_demands.pop(demand_id, None)

    async def rpc_request_lease(self, conn, payload) -> dict:
        resources = payload["resources"]
        strategy = payload.get("scheduling_strategy") or {}
        self.stats_counters["lease_requests"] += 1
        trace_ctx = payload.get("trace_ctx") if tracing.enabled() else None
        wait_start_ns = time.time_ns() if trace_ctx else 0
        parked = False
        node = self._pick_node(
            resources, payload.get("submitter_node"), strategy
        )
        if node is None:
            parked = True
            node = await self._queue_lease_request(
                resources, payload.get("submitter_node"), strategy,
                timeout=60.0,
            )
        if trace_ctx:
            # Parked-queue time as seen by the scheduler: ~0 when capacity
            # was immediately available, the full park otherwise.
            tracing.emit(
                "lease_wait", trace_ctx, start_ns=wait_start_ns,
                status="ok" if node is not None else "error",
                parked=parked,
                resources={k: v for k, v in resources.items() if v},
            )
        if node is None:
            return {"status": "infeasible"}
        bundle = None
        if strategy.get("kind") == "pg":
            bundle = {
                "pg_id": strategy["pg_id"],
                "bundle_index": strategy.get("bundle_index", -1),
            }
        return {
            "status": "ok",
            "node_id": node.node_id,
            "agent_addr": list(node.agent_addr),
            "bundle": bundle,
        }

    async def _retry_pending(self) -> None:
        for pg in list(self.pgs.values()):
            if pg.state in ("PENDING", "RESCHEDULING"):
                spawn_task(self._schedule_pg(pg))

    # ------------------------------------------------------------------
    # actors [N2]
    # ------------------------------------------------------------------
    async def rpc_create_actor(self, conn, payload) -> dict:
        spec = payload
        # Idempotent twice over: the mutation token catches any re-send
        # (dropped/duplicated reply, reconnect replay) without touching
        # state, and the actor_id check backstops token-less callers —
        # either way a duplicate never double-schedules.
        cached = self._mutation_cached(payload)
        if cached is not None:
            return cached
        existing = self.actors.get(spec["actor_id"])
        if existing is not None:
            return self._mutation_record(
                payload, {"status": "ok", "actor_id": existing.actor_id}
            )
        actor = ActorInfo(spec)
        if actor.name:
            key = (spec.get("namespace", "default"), actor.name)
            if key in self.named_actors:
                return self._mutation_record(
                    payload,
                    {"status": "name_exists",
                     "actor_id": self.named_actors[key]},
                )
            self.named_actors[key] = actor.actor_id
        self.actors[actor.actor_id] = actor
        self._mark_dirty("actors", actor.actor_id)
        spawn_task(self._schedule_actor(actor))
        return self._mutation_record(
            payload, {"status": "ok", "actor_id": actor.actor_id}
        )

    @staticmethod
    def _debit(node: NodeInfo, resources: dict) -> None:
        """Optimistic local reservation: decrement the controller's VIEW of
        a node's availability the moment a placement is chosen, so a burst
        of concurrent _schedule_* coroutines spreads across the cluster
        instead of thundering onto the node the last heartbeat said was
        emptiest. The next heartbeat overwrites with the agent's
        authoritative value, so drift self-heals within one tick."""
        avail = node.resources_available
        for k, v in resources.items():
            if v > 0:
                avail[k] = avail.get(k, 0.0) - v

    @staticmethod
    def _credit(node: NodeInfo, resources: dict) -> None:
        avail = node.resources_available
        for k, v in resources.items():
            if v > 0:
                avail[k] = avail.get(k, 0.0) + v

    async def _schedule_actor(self, actor: ActorInfo) -> None:
        spec = actor.spec
        deadline = time.monotonic() + 120.0
        while True:
            resources = spec.get("resources", {"CPU": 1})
            node = self._pick_node(
                resources,
                spec.get("submitter_node"),
                spec.get("scheduling_strategy") or {},
            )
            if node is not None:
                self._debit(node, resources)
                started = False
                try:
                    client = await self._node_client(node)
                    resp = await client.call(
                        "start_actor",
                        {
                            "actor_id": actor.actor_id,
                            "spec": {
                                k: v
                                for k, v in spec.items()
                                if k not in ("creation_args",)
                            },
                            "creation_args": spec.get("creation_args"),
                        },
                    )
                    if resp["status"] == "ok":
                        started = True
                        actor.node_id = node.node_id
                        actor.worker_id = resp["worker_id"]
                        actor.spec["pid"] = resp.get("pid")
                        actor.address = tuple(resp["worker_addr"])
                        actor.state = "ALIVE"
                        actor.ready_event.set()
                        self._mark_dirty("actors", actor.actor_id)
                        await self.publish("actor_state", actor.snapshot())
                        return
                    print(
                        f"[controller] start_actor {actor.actor_id[:12]} on "
                        f"{node.node_id[:12]}: {resp}",
                        file=sys.stderr, flush=True,
                    )
                except Exception as exc:
                    print(
                        f"[controller] start_actor {actor.actor_id[:12]} "
                        f"error: {type(exc).__name__}: {exc}",
                        file=sys.stderr, flush=True,
                    )
                finally:
                    if not started:
                        self._credit(node, resources)
            if time.monotonic() > deadline:
                actor.state = "DEAD"
                actor.death_cause = "unschedulable: no feasible node"
                actor.ready_event.set()
                self._mark_dirty("actors", actor.actor_id)
                await self.publish("actor_state", actor.snapshot())
                return
            # Event-driven retry: woken by the next capacity gain (node
            # added, resources freed) instead of a fixed 200 ms poll.
            await self._wait_for_capacity(1.0)

    async def _handle_actor_failure(self, actor: ActorInfo, cause: str) -> None:
        if actor.state == "DEAD":
            return
        if actor.restarts_remaining != 0:
            if actor.restarts_remaining > 0:
                actor.restarts_remaining -= 1
            actor.state = "RESTARTING"
            actor.address = None
            actor.ready_event.clear()
            self._mark_dirty("actors", actor.actor_id)
            await self.publish("actor_state", actor.snapshot())
            spawn_task(self._schedule_actor(actor))
        else:
            actor.state = "DEAD"
            actor.death_cause = cause
            actor.ready_event.set()
            if actor.name:
                self.named_actors.pop(
                    (actor.spec.get("namespace", "default"), actor.name), None
                )
            self._mark_dirty("actors", actor.actor_id)
            await self.publish("actor_state", actor.snapshot())

    async def rpc_worker_died(self, conn, payload) -> dict:
        """Reported by a node agent when a worker process exits."""
        actor_id = payload.get("actor_id")
        if actor_id and actor_id in self.actors:
            actor = self.actors[actor_id]
            if payload.get("intended") or actor.state == "DEAD":
                pass
            else:
                if payload.get("reason") == "oom":
                    cause = (
                        "worker killed by the node memory monitor (OOM, "
                        f"exit={payload.get('exit_code')})"
                    )
                else:
                    cause = (
                        f"worker process died (exit={payload.get('exit_code')})"
                    )
                await self._handle_actor_failure(actor, cause)
        return {"status": "ok"}

    async def rpc_get_actor_info(self, conn, payload) -> dict:
        actor = self.actors.get(payload["actor_id"])
        if actor is None:
            return {"state": "UNKNOWN"}
        if payload.get("wait_ready"):
            await actor.ready_event.wait()
        return {
            "state": actor.state,
            "address": list(actor.address) if actor.address else None,
            "node_id": actor.node_id,
            "death_cause": actor.death_cause,
        }

    async def rpc_get_named_actor(self, conn, payload) -> dict:
        key = (payload.get("namespace", "default"), payload["name"])
        actor_id = self.named_actors.get(key)
        if actor_id is None:
            return {"status": "missing"}
        actor = self.actors[actor_id]
        return {
            "status": "ok",
            "actor_id": actor_id,
            "spec_meta": {
                "class_name": actor.spec.get("class_name"),
                "methods": actor.spec.get("methods", []),
                "max_task_retries": actor.spec.get("max_task_retries", 0),
            },
        }

    async def rpc_kill_actor(self, conn, payload) -> dict:
        actor = self.actors.get(payload["actor_id"])
        if actor is None:
            return {"status": "missing"}
        await self._kill_actor(
            actor, "ray_tpu_torch.kill", no_restart=payload.get("no_restart", True)
        )
        return {"status": "ok"}

    async def _kill_actor(self, actor: ActorInfo, cause: str, no_restart: bool) -> None:
        if no_restart:
            actor.restarts_remaining = 0
        node = self.nodes.get(actor.node_id or "")
        if node is not None and node.alive and actor.worker_id:
            try:
                client = await self._node_client(node)
                await client.call(
                    "kill_worker",
                    {"worker_id": actor.worker_id, "actor_id": actor.actor_id,
                     "intended": no_restart},
                )
            except Exception:  # rtlint: disable=swallowed-exception - best-effort kill; death reconciliation owns the state
                pass
        if no_restart:
            actor.state = "DEAD"
            actor.death_cause = cause
            actor.ready_event.set()
            if actor.name:
                self.named_actors.pop(
                    (actor.spec.get("namespace", "default"), actor.name), None
                )
            self._mark_dirty("actors", actor.actor_id)
            await self.publish("actor_state", actor.snapshot())

    async def rpc_restart_actor(self, conn, payload) -> dict:
        """Resurrect a DEAD actor through the normal lease path — the
        rtdag supervisor's recovery primitive. The replacement may land
        on any node with capacity (the supervisor re-derives channel
        families from the new placement). Idempotent twice over: the
        mutation token absorbs re-sends, and by state — an actor already
        PENDING/RESTARTING/ALIVE is where the caller wants it."""
        cached = self._mutation_cached(payload)
        if cached is not None:
            return cached
        actor = self.actors.get(payload["actor_id"])
        if actor is None:
            return self._mutation_record(payload, {"status": "missing"})
        if actor.state != "DEAD":
            return self._mutation_record(
                payload, {"status": "ok", "state": actor.state}
            )
        actor.state = "RESTARTING"
        actor.death_cause = None
        actor.address = None
        actor.worker_id = None
        actor.ready_event.clear()
        if actor.name:
            # Death evicted the name; the resurrected actor reclaims it
            # unless someone else took it in the meantime.
            self.named_actors.setdefault(
                (actor.spec.get("namespace", "default"), actor.name),
                actor.actor_id,
            )
        self._mark_dirty("actors", actor.actor_id)
        await self.publish("actor_state", actor.snapshot())
        spawn_task(self._schedule_actor(actor))
        return self._mutation_record(
            payload, {"status": "ok", "state": "RESTARTING"}
        )

    async def rpc_list_actors(self, conn, payload) -> list:
        return [a.snapshot() for a in self.actors.values()]

    # ------------------------------------------------------------------
    # placement groups (2-phase commit across agents) [N3]
    # ------------------------------------------------------------------
    async def rpc_create_placement_group(self, conn, payload) -> dict:
        cached = self._mutation_cached(payload)
        if cached is not None:
            return cached
        if payload["pg_id"] in self.pgs:  # idempotent re-send (see create_actor)
            return self._mutation_record(
                payload, {"status": "ok", "pg_id": payload["pg_id"]}
            )
        pg = PlacementGroupInfo(
            payload["pg_id"],
            payload["bundles"],
            payload.get("strategy", "PACK"),
            payload.get("name", ""),
            payload.get("job_id", ""),
        )
        self.pgs[pg.pg_id] = pg
        self._mark_dirty("pgs", pg.pg_id)
        spawn_task(self._schedule_pg(pg))
        return self._mutation_record(
            payload, {"status": "ok", "pg_id": pg.pg_id}
        )

    def _plan_bundles(self, pg: PlacementGroupInfo) -> list[NodeInfo] | None:
        """Pick a node per bundle honoring the strategy. Pure function of the
        current availability snapshot (gcs_placement_group_scheduler.cc)."""
        alive = [n for n in self.nodes.values() if n.alive]
        if not alive:
            return None
        needed = [
            (i, pg.bundles[i])
            for i in range(len(pg.bundles))
            if pg.bundle_nodes[i] is None
        ]
        avail = {n.node_id: dict(n.resources_available) for n in alive}

        def can_host(node_id: str, bundle: dict) -> bool:
            return all(
                avail[node_id].get(k, 0.0) + 1e-9 >= v for k, v in bundle.items() if v > 0
            )

        def consume(node_id: str, bundle: dict) -> None:
            for k, v in bundle.items():
                avail[node_id][k] = avail[node_id].get(k, 0.0) - v

        plan: dict[int, NodeInfo] = {}
        strategy = pg.strategy
        if strategy in ("STRICT_PACK", "PACK"):
            # Try to land everything on one node first.
            for node in sorted(alive, key=self._utilization):
                trial = {n.node_id: dict(n.resources_available) for n in alive}
                ok = True
                for _, bundle in needed:
                    if all(trial[node.node_id].get(k, 0) + 1e-9 >= v for k, v in bundle.items() if v > 0):
                        for k, v in bundle.items():
                            trial[node.node_id][k] = trial[node.node_id].get(k, 0) - v
                    else:
                        ok = False
                        break
                if ok:
                    return [
                        node if pg.bundle_nodes[i] is None else self.nodes[pg.bundle_nodes[i]]
                        for i in range(len(pg.bundles))
                    ]
            if strategy == "STRICT_PACK":
                return None
        if strategy in ("SPREAD", "STRICT_SPREAD"):
            used_nodes: set[str] = {n for n in pg.bundle_nodes if n}
            for index, bundle in needed:
                choice = None
                for node in sorted(alive, key=self._utilization):
                    if strategy == "STRICT_SPREAD" and (
                        node.node_id in used_nodes
                        or any(p.node_id == node.node_id for p in plan.values())
                    ):
                        continue
                    if can_host(node.node_id, bundle):
                        choice = node
                        break
                if choice is None:
                    return None
                plan[index] = choice
                consume(choice.node_id, bundle)
        else:  # PACK fallback / DEFAULT: bin-pack greedily
            for index, bundle in needed:
                choice = None
                for node in sorted(alive, key=lambda n: -self._utilization(n)):
                    if can_host(node.node_id, bundle):
                        choice = node
                        break
                if choice is None:
                    return None
                plan[index] = choice
                consume(choice.node_id, bundle)
        return [
            plan[i] if pg.bundle_nodes[i] is None else self.nodes[pg.bundle_nodes[i]]
            for i in range(len(pg.bundles))
        ]

    async def _schedule_pg(self, pg: PlacementGroupInfo) -> None:
        deadline = time.monotonic() + 120.0
        while pg.state in ("PENDING", "RESCHEDULING"):
            placement = self._plan_bundles(pg)
            if placement is not None:
                # Optimistic reservation at PLAN time (see _debit), before
                # any await: concurrent PG bursts each plan against the
                # post-debit view and spread across nodes. Debiting only
                # after the prepare reply lets every coroutine plan onto
                # the same emptiest node, partially reserve, collide, and
                # roll back in lockstep — a livelock under bursts.
                debited = [
                    (index, placement[index])
                    for index in range(len(pg.bundles))
                    if pg.bundle_nodes[index] is None
                ]
                for index, node in debited:
                    self._debit(node, pg.bundles[index])
                # Phase 1: prepare (reserve) every missing bundle.
                prepared: list[tuple[int, NodeInfo]] = []
                ok = True
                for index, node in debited:
                    try:
                        client = await self._node_client(node)
                        resp = await client.call(
                            "prepare_bundle",
                            {
                                "pg_id": pg.pg_id,
                                "bundle_index": index,
                                "resources": pg.bundles[index],
                            },
                        )
                        if resp["status"] != "ok":
                            ok = False
                            break
                        prepared.append((index, node))
                    except Exception:
                        ok = False
                        break
                if ok:
                    # Phase 2: commit. A node dying between prepare and
                    # commit aborts this round: roll back and retry.
                    committed: list[int] = []
                    try:
                        for index, node in prepared:
                            client = await self._node_client(node)
                            await client.call(
                                "commit_bundle",
                                {"pg_id": pg.pg_id, "bundle_index": index},
                            )
                            pg.bundle_nodes[index] = node.node_id
                            committed.append(index)
                    except Exception:
                        ok = False
                        for index in committed:
                            pg.bundle_nodes[index] = None
                if ok:
                    pg.state = "CREATED"
                    pg.ready_event.set()
                    self._mark_dirty("pgs", pg.pg_id)
                    await self.publish("pg_state", pg.snapshot())
                    # pg-strategy leases may be parked waiting for this.
                    self._notify_capacity()
                    return
                # Rollback: credit every plan-time debit, release the
                # bundles that actually got reserved (committed included).
                for index, node in debited:
                    self._credit(node, pg.bundles[index])
                for index, node in prepared:
                    try:
                        client = await self._node_client(node)
                        await client.call(
                            "release_bundle",
                            {"pg_id": pg.pg_id, "bundle_index": index},
                        )
                    except Exception:  # rtlint: disable=swallowed-exception - rollback of a failed placement; node death frees bundles
                        pass
            if time.monotonic() > deadline:
                await self.publish("pg_state", pg.snapshot())
                return  # stays PENDING (autoscaler hint); creator may time out
            await self._wait_for_capacity(1.0)

    async def rpc_pg_ready(self, conn, payload) -> dict:
        pg = self.pgs.get(payload["pg_id"])
        if pg is None:
            return {"status": "missing"}
        await pg.ready_event.wait()
        return {"status": "ok", "pg": pg.snapshot()}

    async def rpc_remove_placement_group(self, conn, payload) -> dict:
        pg = self.pgs.get(payload["pg_id"])
        if pg is None:
            return {"status": "missing"}
        await self._remove_pg(pg)
        return {"status": "ok"}

    async def _remove_pg(self, pg: PlacementGroupInfo) -> None:
        pg.state = "REMOVED"
        self._mark_dirty("pgs", pg.pg_id)
        for index, node_id in enumerate(pg.bundle_nodes):
            node = self.nodes.get(node_id or "")
            if node is None or not node.alive:
                continue
            try:
                client = await self._node_client(node)
                await client.call(
                    "release_bundle", {"pg_id": pg.pg_id, "bundle_index": index}
                )
            except Exception:  # rtlint: disable=swallowed-exception - node gone: nothing left to release
                pass
        await self.publish("pg_state", pg.snapshot())

    async def rpc_list_placement_groups(self, conn, payload) -> list:
        return [pg.snapshot() for pg in self.pgs.values()]

    # ------------------------------------------------------------------
    # task events / state API feed [N5]
    # ------------------------------------------------------------------
    async def rpc_report_task_events(self, conn, payload) -> dict:
        self.task_events.extend(payload["events"])
        self.events.emit("task_events", payload["events"])
        return {"status": "ok"}

    async def rpc_list_task_events(self, conn, payload) -> list:
        limit = payload.get("limit", 1000)
        events = list(self.task_events)[-limit:]
        return events

    async def rpc_list_tasks(self, conn, payload) -> list:
        """Latest state per task, reduced from the task-event log HERE —
        filters/limit are pushed down so the client never ships 100k raw
        events over the wire just to keep 1000 rows."""
        filters = payload.get("filters") or {}
        limit = payload.get("limit", 1000)
        latest: dict[str, dict] = {}
        for event in self.task_events:
            task_id = event.get("task_id")
            if not task_id:
                continue
            row = latest.setdefault(
                task_id,
                {
                    "task_id": task_id,
                    "name": event.get("name"),
                    "state": None,
                    "node_id": event.get("node_id"),
                    "start_time": None,
                    "end_time": None,
                },
            )
            state = event.get("state")
            row["state"] = state
            if event.get("name"):
                row["name"] = event["name"]
            ts = event.get("ts")
            if state in ("RUNNING",) and ts:
                row["start_time"] = ts
            if event.get("start_ts"):
                # terminal events carry the span start (single-event form)
                row["start_time"] = event["start_ts"]
            if state in ("FINISHED", "FAILED") and ts:
                row["end_time"] = ts
            # Per-task resource attribution: terminal events
            # carry the worker's peak RSS / RSS delta (and HBM delta on
            # TPU) across the execution.
            for key in ("peak_rss", "rss_delta", "hbm_delta"):
                if event.get(key) is not None:
                    row[key] = event[key]
        rows = list(latest.values())
        if filters:
            rows = [
                row for row in rows
                if all(row.get(k) == v for k, v in filters.items())
            ]
        return rows[:limit]

    # ------------------------------------------------------------------
    # cluster state queries
    # ------------------------------------------------------------------
    async def rpc_list_nodes(self, conn, payload) -> list:
        return [n.snapshot() for n in self.nodes.values()]

    async def rpc_cluster_resources(self, conn, payload) -> dict:
        total: dict[str, float] = {}
        for node in self.nodes.values():
            if node.alive:
                for k, v in node.resources_total.items():
                    total[k] = total.get(k, 0.0) + v
        return total

    async def rpc_available_resources(self, conn, payload) -> dict:
        total: dict[str, float] = {}
        for node in self.nodes.values():
            if node.alive:
                for k, v in node.resources_available.items():
                    total[k] = total.get(k, 0.0) + v
        return total

    async def rpc_list_workers(self, conn, payload) -> list:
        return list(self.clients.values())

    # ------------------------------------------------------------------
    # resource telemetry
    # ------------------------------------------------------------------
    async def rpc_resource_summary(self, conn, payload) -> dict:
        """Per-node latest sample + ring depths, plus node liveness — the
        payload behind util/state.summarize_resources() and `top`."""
        summary = self.telemetry.summary()
        for node_id, entry in summary["nodes"].items():
            node = self.nodes.get(node_id)
            entry["alive"] = bool(node and node.alive)
        summary["oom_risk_events"] = self.stats_counters.get(
            "oom_risk_events", 0
        )
        return summary

    async def rpc_resource_timeline(self, conn, payload) -> dict:
        return self.telemetry.timeline(
            payload.get("node_id", ""), payload.get("tier")
        )

    # ------------------------------------------------------------------
    # workload flight recorder
    # ------------------------------------------------------------------
    async def rpc_workload_ingest(self, conn, payload) -> dict:
        """Batched flight-recorder samples from a train driver or serve
        proxy: ``{"series": [{"key": ..., "samples": [...]}, ...]}``. The
        store's monotonic guard makes re-delivery (chaos dup/replay, or a
        driver retrying a push) idempotent."""
        ingested = 0
        for entry in payload.get("series", []) or []:
            if not isinstance(entry, dict):
                continue
            samples = entry.get("samples", [])
            if not isinstance(samples, list):
                continue
            ingested += self.telemetry.add_workload_many(
                entry.get("key", ""), samples
            )
        self.stats_counters["workload_ingests"] += 1
        return {"status": "ok", "ingested": ingested}

    async def rpc_workload_summary(self, conn, payload) -> dict:
        return self.telemetry.workload_summary()

    async def rpc_workload_timeline(self, conn, payload) -> dict:
        return self.telemetry.workload_timeline(
            payload.get("key", ""), payload.get("tier")
        )

    async def rpc_report_oom_risk(self, conn, payload) -> dict:
        """Trend-aware OOM early warning from a node agent: count it (the
        metric) and export/publish it (the structured event) so dashboards
        and subscribers see the risk before any kill fires."""
        self.stats_counters["oom_risk_events"] += 1
        await self.publish("oom_risk", payload)
        return {"status": "ok"}

    # ------------------------------------------------------------------
    # comm hang doctor
    # ------------------------------------------------------------------
    async def rpc_report_comm_stall(self, conn, payload) -> dict:
        """A rank's comm watchdog suspects a stall: record it, publish it
        on the event channel, and kick off (debounced) the cluster-wide
        evidence harvest that turns suspicion into a named hang report."""
        self.stats_counters["comm_stall_events"] += 1
        event = dict(payload or {})
        event.setdefault("received_at", time.time())
        self._comm_stalls.append(event)
        await self.publish("comm_stall", event)
        cooldown = float(
            os.environ.get("RAY_TPU_HANG_HARVEST_COOLDOWN_S", "10")
        )
        now = time.monotonic()
        if (
            self._hang_harvest_task is None
            or self._hang_harvest_task.done()
        ) and now - self._last_hang_harvest >= cooldown:
            self._last_hang_harvest = now
            self._hang_harvest_task = spawn_task(
                self._harvest_hang_evidence()
            )
        # A persistent comm stall is also a profiling trigger:
        # the hang report names WHO is stuck, the auto-capture names WHAT
        # the stuck rank is doing. Cooldown-guarded inside.
        self._maybe_auto_profile_capture(reason="comm_stall")
        return {"status": "ok"}

    async def _harvest_hang_evidence(self) -> dict:
        """Fan the ``comm_evidence`` RPC across every alive node agent
        and merge the pile into one hang report."""
        from ray_tpu_torch._private import hang_doctor

        alive = [n for n in self.nodes.values() if n.alive]
        evidence: dict[str, dict] = {}
        for node in alive:
            try:
                client = await self._node_client(node)
                evidence[node.node_id] = await client.call(
                    "comm_evidence", {"last_n": 256}, timeout=30.0
                )
            except Exception as exc:  # rtlint: disable=swallowed-exception - a dead/partitioned node IS evidence; the report names what it did reach
                evidence[node.node_id] = {
                    "status": "error", "error": str(exc)
                }
        # build_report's first call walks the package for the static
        # commgraph (file I/O + AST parse) — keep it off the event loop.
        report = await asyncio.to_thread(
            hang_doctor.build_report, list(self._comm_stalls), evidence
        )
        self._hang_reports.append(report)
        self.stats_counters["hang_reports"] += 1
        return report

    async def rpc_hang_report(self, conn, payload) -> dict:
        """Latest merged hang report (``fresh=True`` harvests now — the
        `ray_tpu_torch doctor --hang` path when no stall has auto-fired)."""
        if (payload or {}).get("fresh") or not self._hang_reports:
            report = await self._harvest_hang_evidence()
        else:
            report = self._hang_reports[-1]
        if not (payload or {}).get("stacks", True):
            report = dict(report, stacks={})
        return {"status": "ok", "report": report}

    async def rpc_cluster_stacks(self, conn, payload) -> dict:
        """Native stack dump of every worker on every alive node (the
        `ray_tpu_torch stacks` CLI) — one agent hop per node, no py-spy."""
        alive = [n for n in self.nodes.values() if n.alive]
        out: dict[str, dict] = {}
        for node in alive:
            try:
                client = await self._node_client(node)
                res = await client.call(
                    "comm_evidence", {"last_n": 0, "stacks": True},
                    timeout=30.0,
                )
                out[node.node_id] = res
            except Exception as exc:  # rtlint: disable=swallowed-exception - unreachable node still listed, with the error in its slot
                out[node.node_id] = {"status": "error", "error": str(exc)}
        return {"status": "ok", "nodes": out}

    async def rpc_comm_summary(self, conn, payload) -> dict:
        """Live comm-plane stall view for `ray_tpu_torch top` / the dashboard:
        recent stall events, per-worker in-flight gauges (read straight
        from the metrics KV mirror — snapshots, never drained), and the
        hang-report count."""
        inflight: dict[str, dict] = {}
        for key, raw in self.kv.get("metrics", {}).items():
            if not key.startswith(
                ("rt_comm_inflight{", "rt_comm_inflight_oldest_age_s{")
            ):
                continue
            try:
                point = json.loads(raw)
            except Exception:  # rtlint: disable=swallowed-exception - one corrupt KV point must not hide the rest
                continue
            worker = point.get("tags", {}).get("worker", "?")
            slot = inflight.setdefault(
                worker, {"inflight": 0.0, "oldest_age_s": 0.0, "ts": 0.0}
            )
            if point.get("name") == "rt_comm_inflight":
                slot["inflight"] = point.get("value", 0.0)
            else:
                slot["oldest_age_s"] = point.get("value", 0.0)
            slot["ts"] = max(slot["ts"], point.get("ts", 0.0))
        stalls = list(self._comm_stalls)
        last_stall = stalls[-1] if stalls else None
        return {
            "status": "ok",
            "stall_total": self.stats_counters.get("comm_stall_events", 0),
            "stalls": stalls[-32:],
            "last_stall_age_s": (
                max(0.0, time.time() - last_stall.get("received_at", 0.0))
                if last_stall else None
            ),
            "inflight": inflight,
            "hang_reports": len(self._hang_reports),
        }

    # ------------------------------------------------------------------
    # cluster step profiler
    # ------------------------------------------------------------------
    def _maybe_auto_profile_capture(
        self, reason: str, ranks: list | None = None, steps: int | None = None
    ) -> bool:
        """Debounced auto-capture entry: one capture at a time, one per
        RAY_TPU_PROFILE_AUTO_COOLDOWN_S, nothing when auto is off."""
        from ray_tpu_torch._private import profiler as profiler_mod

        if not profiler_mod.knob_bool("AUTO", True):
            return False
        if self._profile_task is not None and not self._profile_task.done():
            return False
        now = time.monotonic()
        cooldown = profiler_mod.knob_float("AUTO_COOLDOWN_S", 300.0)
        if self._last_auto_profile and now - self._last_auto_profile < cooldown:
            return False
        self._last_auto_profile = now
        capture_id = f"prof-{next(self._profile_seq):04d}-{reason}"
        self._active_capture_id = capture_id
        self._profile_task = spawn_task(
            self._run_profile_capture(
                capture_id,
                steps or profiler_mod.knob_int("AUTO_STEPS", 3),
                ranks,
                reason,
            )
        )
        return True

    async def rpc_profile_capture(self, conn, payload) -> dict:
        """Start one coordinated step-aligned capture (the `ray_tpu_torch
        profile` CLI and the straggler/comm-stall auto-triggers). Returns
        the capture id immediately; poll ``profile_status`` for the
        record (captures span N live train steps — longer than an RPC
        deadline should be)."""
        payload = payload or {}
        reason = str(payload.get("reason") or "manual")
        steps = max(1, int(payload.get("steps") or 3))
        ranks = payload.get("ranks")
        if ranks is not None:
            ranks = [int(r) for r in ranks]
        if reason != "manual":
            started = self._maybe_auto_profile_capture(
                reason=reason, ranks=ranks, steps=steps
            )
            if not started:
                return {"status": "skipped", "code": "cooldown_or_busy"}
            return {
                "status": "ok",
                "capture_id": getattr(self, "_active_capture_id", None),
            }
        if self._profile_task is not None and not self._profile_task.done():
            return {
                "status": "error",
                "code": "busy",
                "error": "a capture is already running",
            }
        capture_id = f"prof-{next(self._profile_seq):04d}-manual"
        self._active_capture_id = capture_id
        self._profile_task = spawn_task(
            self._run_profile_capture(capture_id, steps, ranks, reason)
        )
        return {"status": "ok", "capture_id": capture_id}

    async def rpc_profile_status(self, conn, payload) -> dict:
        """One capture's record (or its in-flight state) by capture id;
        no id → the most recent record."""
        capture_id = (payload or {}).get("capture_id")
        for rec in reversed(self._profiles):
            if capture_id in (None, rec.get("capture_id")):
                return {"status": "ok", "state": "done", "record": rec}
        if self._profile_task is not None and not self._profile_task.done():
            return {"status": "ok", "state": "running", "record": None}
        return {"status": "ok", "state": "unknown", "record": None}

    async def rpc_profile_list(self, conn, payload) -> dict:
        """Completed capture records, oldest first (``ray_tpu_torch diagnose``
        and the dashboard /api/profiles read this)."""
        return {"status": "ok", "profiles": list(self._profiles)}

    async def _profile_fanout(
        self, action: str, targets: dict | None, args: dict | None = None
    ) -> dict:
        """One profiler action across node agents in parallel.
        ``targets``: {node_id: [worker_ids]} to address specific workers,
        None for the all-workers status sweep. Returns {worker_id:
        result} merged across nodes."""
        alive = [n for n in self.nodes.values() if n.alive]
        if targets is not None:
            alive = [n for n in alive if n.node_id in targets]

        async def _one(node):
            try:
                client = await self._node_client(node)
                payload = {"action": action, "args": args or {}}
                if targets is not None:
                    payload["workers"] = list(targets.get(node.node_id) or [])
                return await client.call("profile_gang", payload, timeout=30.0)
            except Exception as exc:  # rtlint: disable=swallowed-exception - an unreachable node yields a partial capture, not a failed one
                return {"status": "error", "error": str(exc)}

        merged: dict[str, dict] = {}
        for node, res in zip(
            alive, await asyncio.gather(*(_one(n) for n in alive))
        ):
            for wid, wres in (res.get("workers") or {}).items():
                if isinstance(wres, dict):
                    wres.setdefault("node_id", node.node_id)
                    merged[wid] = wres
        return merged

    async def _run_profile_capture(
        self,
        capture_id: str,
        steps: int,
        ranks: list | None,
        reason: str,
    ) -> dict:
        """The coordinated capture: discover train ranks + their current
        steps, arm every selected rank at the same upcoming step
        boundary, wait the capture out, collect, merge into ONE Perfetto
        trace + merged folded stacks, record + publish."""
        from ray_tpu_torch._private import profile_merge, profiler as profiler_mod
        from ray_tpu_torch._private.atomic_io import atomic_write_json

        rec: dict = {
            "capture_id": capture_id,
            "ts": time.time(),
            "reason": reason,
            "steps": steps,
            "requested_ranks": ranks,
        }
        try:
            statuses = await self._profile_fanout("status", None)
            train = {
                wid: st
                for wid, st in statuses.items()
                if st.get("status") == "ok" and st.get("rank") is not None
            }
            if ranks is not None:
                train = {
                    wid: st
                    for wid, st in train.items()
                    if int(st["rank"]) in ranks
                }
            if not train:
                rec.update(status="error", code="no_train_workers")
                self._profiles.append(rec)
                await self.publish("profile", rec)
                return rec
            # The SAME upcoming boundary for every rank: past the fastest
            # rank's current step, plus slack for the arm RPC to land.
            known = [
                int(st["step"]) for st in train.values()
                if st.get("step") is not None
            ]
            start_step = (max(known) + 2) if known else 0
            max_s = profiler_mod.knob_float("MAX_S", 60.0)
            targets: dict[str, list[str]] = {}
            for wid, st in train.items():
                targets.setdefault(st.get("node_id") or "", []).append(wid)
            armed = await self._profile_fanout(
                "arm",
                targets,
                {
                    "capture_id": capture_id,
                    "start_step": start_step,
                    "steps": steps,
                    "max_s": max_s,
                    "session_dir": self.session_dir,
                },
            )
            arm_errors = {
                wid: res for wid, res in armed.items()
                if res.get("status") != "ok"
            }
            deadline = time.monotonic() + max_s + 15.0
            pending = set(wid for wid in train if wid not in arm_errors)
            while pending and time.monotonic() < deadline:
                await asyncio.sleep(0.25)
                polled = await self._profile_fanout("status", targets)
                pending = {
                    wid for wid in pending
                    if polled.get(wid, {}).get("state")
                    in ("armed", "capturing")
                }
            if pending:
                # Deadline elapsed with ranks still armed/capturing (step
                # stream stalled?): force-stop them so collect returns a
                # (partial) capture instead of `not_done`.
                stuck = {
                    nid: [w for w in wids if w in pending]
                    for nid, wids in targets.items()
                    if any(w in pending for w in wids)
                }
                await self._profile_fanout("abort", stuck)
            collected = await self._profile_fanout("collect", targets)
            captures = [
                res for res in collected.values()
                if res.get("status") == "ok"
            ]
            out_dir = os.path.join(self.session_dir, "profiles", capture_id)
            trace = profile_merge.merge_captures(
                captures,
                capture_id,
                meta={"reason": reason, "start_step": start_step},
            )
            folded = profile_merge.merge_folded(captures)
            trace_path = os.path.join(out_dir, "merged_trace.json")
            folded_path = os.path.join(out_dir, "merged_folded.json")
            await asyncio.to_thread(atomic_write_json, trace_path, trace)
            await asyncio.to_thread(atomic_write_json, folded_path, folded)
            hot = {}
            for cap in captures:
                if cap.get("rank") is None:
                    continue
                phase, frac = profile_merge.hot_phase(
                    cap.get("phase_totals") or {}
                )
                if phase is not None:
                    hot[str(cap["rank"])] = {
                        "phase": phase, "frac": round(frac, 4)
                    }
            rec.update(
                status="ok" if captures and not arm_errors else "partial",
                ranks=trace["metadata"]["ranks"],
                start_step=start_step,
                path=trace_path,
                folded_path=folded_path,
                hot_phases=hot,
                workers=len(captures),
                arm_errors={
                    wid: res.get("code") or res.get("error")
                    for wid, res in arm_errors.items()
                } or None,
                trace_ids=trace["metadata"]["trace_ids"],
            )
            if not captures:
                rec["status"] = "error"
                rec["code"] = "no_captures"
        except Exception as exc:
            print(
                f"[controller] profile capture {capture_id} failed: {exc}",
                file=sys.stderr, flush=True,
            )
            rec.update(status="error", code="exception", error=str(exc))
        self._profiles.append(rec)
        self.stats_counters["profile_captures"] += 1
        await self.publish("profile", rec)
        return rec

    async def rpc_controller_stats(self, conn, payload) -> dict:
        """Control-plane internals for the scale suite and /metrics: queue
        depths must drain to zero in a healthy cluster."""
        states = collections.Counter(a.state for a in self.actors.values())
        pg_states = collections.Counter(p.state for p in self.pgs.values())
        return {
            "counters": dict(self.stats_counters),
            "pending_lease_shapes": len(self._pending_leases),
            "pending_lease_depth": sum(
                len(q) for q in self._pending_leases.values()
            ),
            "pending_demands": len(self.pending_demands),
            "pub_outbox_depth": sum(
                len(v) for v in self._pub_outbox.values()
            ),
            "subscriber_conns": len(
                {c for s in self.subscribers.values() for c in s}
            ),
            "snapshot": dict(self._snap_stats),
            "snapshot_store": self.store.stats(),
            "mutation_cache_size": len(self._mutation_replies),
            "nodes_alive": sum(1 for n in self.nodes.values() if n.alive),
            "actor_states": dict(states),
            "pg_states": dict(pg_states),
            "node_stats": {
                n.node_id: n.stats for n in self.nodes.values() if n.stats
            },
            "telemetry": self.telemetry.stats(),
        }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--session-dir", required=True)
    args = parser.parse_args()

    async def run() -> None:
        controller = Controller(args.session_dir)
        port = await controller.start(args.host, args.port)
        # Write the bound port for the parent to discover. Atomic: the
        # parent polls for this file and must never read a torn half.
        from ray_tpu_torch._private.atomic_io import atomic_write_json

        atomic_write_json(
            os.path.join(args.session_dir, "controller.addr"),
            {"host": args.host, "port": port},
        )
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
