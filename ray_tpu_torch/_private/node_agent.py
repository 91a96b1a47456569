"""Per-node agent — worker pool, local scheduling, object plane host.

Role-equivalent of the reference raylet
(src/ray/raylet/main.cc + node_manager.cc :: NodeManager [N9]) including:
  * WorkerPool            — worker_pool.cc [N11]: spawn/cache/kill workers,
                            per-runtime-env pools, registration handshake
  * lease queue           — local_task_manager.cc-style grant queue [N10]
  * bundle reservations   — placement-group prepare/commit/release (the
                            raylet side of the GCS 2PC [N3])
  * object plane host     — owns the shared-memory store server [N17] and
                            serves chunked pulls (object_manager.cc [N16])
  * resource reporting    — heartbeats to the controller (ray_syncer [N33])
  * worker-death watch    — SIGCHLD-equivalent monitoring, reports to the
                            controller for actor restart decisions
  * log forwarding        — log_monitor.py-equivalent: worker stdout/stderr
                            to per-session files + pubsub to drivers
  * GPU detection         — enumerates the host's cards into the node's
                            resource vocabulary, and gives each worker
                            only its lease's cards (CUDA_VISIBLE_DEVICES)
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import itertools
import json
import math
import os
import signal
import sys
import time
from typing import Any

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import global_config
from ray_tpu_torch._private.ids import WorkerID
from ray_tpu_torch._private.object_store import ObjectStoreClient, ObjectStoreServer
from ray_tpu_torch._private.rpc import RpcClient, RpcServer, ServerConnection, spawn_task
from ray_tpu_torch._private.runtime_env import RuntimeEnvManager
from ray_tpu_torch.util import tracing


def visible_gpus() -> list[tuple[str, str]]:
    """(index, name) of each card this host lets the node use, by
    ``nvidia-smi``'s index (which ``CUDA_VISIBLE_DEVICES`` of a worker then
    names). Never initialises a device in this process: a CUDA context in
    the agent would hold memory on every card for its whole life, as a jax
    backend here would hold the TPU's chip lock. ``CUDA_VISIBLE_DEVICES``
    is honoured, by index or UUID; empty gives no cards (the counterpart of
    the reference's ``JAX_PLATFORMS=cpu``)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and not visible.strip():
        return []
    import shutil
    import subprocess as sp

    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    try:
        out = sp.run(
            [smi, "--query-gpu=index,name,uuid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, sp.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    cards = []
    for line in out.stdout.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) >= 3:
            cards.append((parts[0], parts[1], parts[2]))
    if visible is not None:
        wanted = [v.strip() for v in visible.split(",") if v.strip()]
        by_key = {c[0]: c for c in cards} | {c[2]: c for c in cards}
        cards = [by_key[w] for w in wanted if w in by_key]
    return [(index, name) for index, name, _ in cards]


def detect_gpu_resources(cards: list[tuple[str, str]]) -> dict:
    """``{"GPU": n, "GPU-<name>": n}`` for the host's visible cards
    (``visible_gpus()``), the name key made from the first card's name with
    spaces as ``-`` (the counterpart of the reference's ``TPU-{kind}``).
    ``init(num_gpus=, resources=)`` declares cards instead, as
    ``resources={"TPU": 8}`` does in the reference."""
    if not cards:
        return {}
    name = cards[0][1].replace(" ", "-")
    return {"GPU": float(len(cards)), f"GPU-{name}": float(len(cards))}


def _is_card_key(name: str) -> bool:
    return name == "GPU" or name.startswith("GPU-")


def _gc_stale_arenas() -> None:
    """Unlink arena files left by SIGKILLed agents (their Stop() never
    ran). A stale arena pins real tmpfs memory, and on this class of host
    growing resident shm measurably slows page supply for everyone.
    Filename layout: /dev/shm/raytpu_torch-<agent_pid>-<node_suffix>, apart
    from the reference's ``raytpu-``, so neither package unlinks the other's."""
    try:
        for name in os.listdir("/dev/shm"):
            if not name.startswith("raytpu_torch-"):
                continue
            parts = name.split("-")
            if len(parts) < 3 or not parts[1].isdigit():
                continue
            pid = int(parts[1])
            try:
                os.kill(pid, 0)  # alive? leave it
            except ProcessLookupError:
                try:
                    os.unlink(os.path.join("/dev/shm", name))
                except OSError:
                    pass
            except PermissionError:
                pass
    except OSError:
        pass


class WorkerProcess:
    def __init__(
        self,
        worker_id: str,
        proc: asyncio.subprocess.Process,
        env_hash: str,
        job_id: str = "",
    ):
        self.worker_id = worker_id
        self.proc = proc
        self.env_hash = env_hash
        self.job_id = job_id
        self.address: tuple | None = None
        self.registered = asyncio.Event()
        self.actor_id: str | None = None
        self.intended_exit = False
        self.resources: dict = {}
        self.bundle: dict | None = None
        # The cards this process sees: its CUDA_VISIBLE_DEVICES, fixed at
        # spawn ("" for none).
        self.cards = ""
        # Set by the memory monitor before the SIGKILL so _watch_worker
        # can attribute the death ("oom") instead of a generic crash.
        self.death_reason: str | None = None
        self.oom_rss: int | None = None


class Lease:
    _ids = itertools.count(1)

    def __init__(
        self, worker: WorkerProcess, resources: dict, bundle_key: tuple | None,
        cards: str = "",
    ):
        self.lease_id = f"lease-{next(Lease._ids)}"
        self.worker = worker
        self.resources = resources
        self.cards = cards
        # Resolved (pg_id, bundle_index) the resources were consumed from —
        # never the caller's raw request (whose index may be the -1 wildcard).
        self.bundle_key = bundle_key


class NodeAgent:
    def __init__(
        self,
        node_id: str,
        controller_addr: tuple,
        session_dir: str,
        resources: dict | None = None,
        store_capacity: int = 0,
        labels: dict | None = None,
    ):
        self.node_id = node_id
        self.controller_addr = controller_addr
        self.session_dir = session_dir
        self.labels = labels or {}
        self.server = RpcServer(name=f"agent-{node_id[:10]}")
        self.controller: RpcClient | None = None
        self.address: tuple | None = None

        if store_capacity <= 0:
            import psutil

            store_capacity = min(
                int(psutil.virtual_memory().total * 0.3), 16 * (1 << 30)
            )
        self.store_capacity = store_capacity
        suffix = node_id[-8:]
        self.store_socket = os.path.join(session_dir, f"store-{suffix}.sock")
        self.store_shm = f"/dev/shm/raytpu_torch-{os.getpid()}-{suffix}"
        _gc_stale_arenas()
        self.spill_dir = os.path.join(session_dir, f"spill-{suffix}")
        self.store_server: ObjectStoreServer | None = None
        self._store_client: ObjectStoreClient | None = None

        base = {"CPU": float(os.cpu_count() or 1), "memory": float(store_capacity)}
        gpus = visible_gpus()
        base.update(detect_gpu_resources(gpus))
        base[f"node:{node_id}"] = 1.0
        if resources:
            base.update({k: float(v) for k, v in resources.items()})
        self.resources_total = base
        self.resources_available = dict(base)
        # Free share of each card, by the id a worker's CUDA_VISIBLE_DEVICES
        # names: the detected cards, or 0..n-1 for cards declared on a host
        # that has fewer (a test's init(num_gpus=1) on a CPU box).
        n_cards = int(math.ceil(base.get("GPU", 0.0) - 1e-9))
        ids = [index for index, _ in gpus][:n_cards]
        ids += [str(i) for i in range(n_cards) if str(i) not in ids][: n_cards - len(ids)]
        self._card_free: dict[str, float] = {i: 1.0 for i in ids}

        self.workers: dict[str, WorkerProcess] = {}
        self.idle_workers: dict[str, list[WorkerProcess]] = {}
        # Tombstones for owners asking WHY a worker died (OOM vs crash);
        # bounded so long-lived agents don't accumulate forever.
        self.death_info: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        self.runtime_envs = RuntimeEnvManager(session_dir)
        self.leases: dict[str, Lease] = {}
        self.bundles: dict[tuple, dict] = {}  # (pg_id, idx) -> {resources, available, committed}
        # Parked lease requests indexed by resource shape (sorted names):
        # a freed resource wakes only the shapes it can satisfy instead of
        # thundering every waiter on every release. Key () = any shape.
        self._resource_waiters: dict[tuple, list[asyncio.Future]] = {}
        self.log_dir = os.path.join(session_dir, "logs")
        tracing.configure(session_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.spill_dir, exist_ok=True)
        # object-transfer plane (N16): agent→agent push clients + counters
        # (counters surface in store_stats so tests can assert "no pull")
        self._transfer_clients: dict[tuple, RpcClient] = {}
        self.pull_chunks_served = 0
        self.pushes_started = 0
        self.pushes_received = 0
        # native lease lane (N9/N10): engine handle when enabled; the C++
        # table is then the single source of truth for non-bundle node
        # resources; _native_leases mirrors grants via drained events.
        self._native_lease = None
        self._native_leases: dict[str, dict] = {}
        self._default_env_hash = self._env_hash({})
        # resource telemetry: the memory-monitor loop assembles
        # node samples here; the heartbeat loop ships them piggybacked on
        # the existing stats channel. Bounded: a controller outage drops
        # old samples instead of growing the agent.
        self._telemetry_buffer: collections.deque = collections.deque(maxlen=64)
        self._telemetry_last_sample = 0.0
        # per-worker (t, rss) history for the oom_risk trend projection
        self._rss_history: dict[str, collections.deque] = {}
        self._oom_risk_last: dict[str, float] = {}

    # ------------------------------------------------------------------
    async def start(self, port: int = 0) -> tuple:
        self.store_server = ObjectStoreServer(
            self.store_socket, self.store_shm, self.store_capacity, self.spill_dir
        )
        self.server.route_object(self)
        if hasattr(self.server, "route_push"):
            # C++ object-transfer plane: the engine reassembles obj_chunk
            # frames and posts ONE obj_complete per object (N16 push path).
            self.server.route_push("obj_complete", self._on_obj_complete)
            # native lease lane: resources freed in C++ wake Python's
            # blocked lease requests immediately
            self.server.route_push("lease_freed", self._on_lease_freed)
        bound = await self.server.start("127.0.0.1", port)
        if global_config().native_lease_lane:
            # Native lease lane (local_task_manager.cc grant role): the
            # engine grants simple leases on its own thread; Python keeps
            # the policy/slow paths and adjusts the same native counters.
            try:
                from ray_tpu_torch._private.rpc import _NativeEngine

                engine = _NativeEngine.for_running_loop()
                self._native_lease = engine
                self._lease_adjust_native(self.resources_available, +1)
                engine.lib.rt_lease_enable(engine.handle, 1)
            except Exception:
                self._native_lease = None
        self.address = ("127.0.0.1", bound)
        chaos.set_identity(f"node:{self.node_id}")
        self.controller = RpcClient(
            self.controller_addr, name="agent-to-controller", auto_reconnect=True
        )
        self.controller.chaos_peer = "controller"
        await self.controller.connect()
        # Survive controller restarts: replay registration on reconnect
        # (reference: raylet re-registers through gcs_client reconnect).
        self.controller.on_reconnect = self._register_with_controller
        await self._register_with_controller()
        spawn_task(self._heartbeat_loop())
        spawn_task(self._memory_monitor_loop())
        return self.address

    async def _memory_monitor_loop(self) -> None:
        """Per-worker RSS watchdog (reference: memory_monitor.cc + the
        raylet OOM-kill policy, N15). When node usage crosses
        memory_usage_threshold, the largest-RSS worker is killed; any
        worker above memory_worker_rss_limit_mb (absolute cap, also the
        testing knob) is killed outright. The owner of its tasks sees a
        retriable OutOfMemoryError (via worker_death_info), never a
        whole-node OOM.

        The same psutil sweep doubles as the node's resource-telemetry
        sampler: at most once per telemetry_sample_interval_s it
        assembles a node sample (CPU%, per-worker RSS, object-store bytes,
        HBM when available) into _telemetry_buffer for the heartbeat to
        ship, and feeds the per-worker RSS histories behind the
        trend-aware ``oom_risk`` early warning."""
        import psutil

        cfg = global_config()
        interval = cfg.memory_monitor_interval_s
        if interval <= 0:
            return
        self._last_pressure_kill = 0.0
        procs: dict[str, "psutil.Process"] = {}
        while True:
            await asyncio.sleep(interval)
            limit_bytes = cfg.memory_worker_rss_limit_mb * (1 << 20)
            try:
                vmem = psutil.virtual_memory()
                node_frac = vmem.percent / 100.0
            except Exception:  # rtlint: disable=swallowed-exception - psutil sampling hiccup; retry next interval
                continue
            over_node = node_frac >= cfg.memory_usage_threshold
            now = time.time()
            want_sample = (
                cfg.telemetry_enabled
                and now - self._telemetry_last_sample
                >= cfg.telemetry_sample_interval_s
            )
            want_risk = limit_bytes > 0 and cfg.oom_risk_horizon_s > 0
            if not over_node and limit_bytes <= 0 and not want_sample:
                continue
            samples = []
            live_ids = set()
            for worker in list(self.workers.values()):
                pid = getattr(worker.proc, "pid", None)
                if pid is None or worker.proc.returncode is not None:
                    continue
                live_ids.add(worker.worker_id)
                try:
                    proc = procs.get(worker.worker_id)
                    # Stale-handle guard: a respawned worker id carries a
                    # new pid, and a reused pid is a different process
                    # (is_running() compares create_time) — either way the
                    # cached handle would read a stranger's RSS.
                    if proc is not None and (
                        proc.pid != pid or not proc.is_running()
                    ):
                        procs.pop(worker.worker_id, None)
                        proc = None
                    if proc is None:
                        proc = procs[worker.worker_id] = psutil.Process(pid)
                    samples.append((proc.memory_info().rss, worker))
                except psutil.NoSuchProcess:
                    procs.pop(worker.worker_id, None)
                    continue
                except Exception:  # rtlint: disable=swallowed-exception - per-proc sampling race; skip this worker this tick
                    continue
            for worker_id in list(procs):
                if worker_id not in live_ids:
                    procs.pop(worker_id, None)
            if want_sample:
                self._telemetry_last_sample = now
                self._telemetry_sample(now, vmem, samples)
            if want_risk:
                self._check_oom_risk(now, samples, limit_bytes, cfg)
            if not over_node and limit_bytes <= 0:
                continue
            if not samples:
                continue
            # Kill preference (raylet policy analog): retriable task
            # workers before actors, largest RSS first.
            samples.sort(key=lambda item: (item[1].actor_id is not None,
                                           -item[0]))
            to_kill = []
            if limit_bytes > 0:
                to_kill = [s for s in samples if s[0] > limit_bytes]
            # Node-pressure kills need a grace period: freeing tens of GB
            # takes longer than one tick, and an unreaped victim still
            # counts in virtual_memory() — without the gate one spike
            # cascade-kills healthy workers (raylet waits for a kill to
            # take effect before choosing another victim).
            kill_pending = any(
                w.death_reason is not None for w in self.workers.values()
            )
            in_grace = (
                time.monotonic() - self._last_pressure_kill
                < max(1.0, 4 * interval)
            )
            if over_node and not to_kill and not kill_pending and not in_grace:
                to_kill = [samples[0]]  # preferred offender
                self._last_pressure_kill = time.monotonic()
            for rss, worker in to_kill:
                if worker.death_reason is not None:
                    continue
                worker.death_reason = "oom"
                worker.oom_rss = rss
                if self._native_lease is not None:
                    # never pool a dying worker: the engine's return path
                    # must bounce this worker's lease back to Python
                    self._native_lease.lib.rt_lease_worker_ban(
                        self._native_lease.handle, worker.worker_id.encode()
                    )
                print(
                    f"[raytpu-agent] memory monitor killing worker "
                    f"{worker.worker_id} (rss={rss >> 20} MiB, "
                    f"node={node_frac:.0%})",
                    file=sys.stderr,
                )
                self._kill_worker_tree(worker)

    @staticmethod
    def _kill_worker_tree(worker: WorkerProcess) -> None:
        """SIGKILL the worker AND any subprocesses the task spawned.
        Workers deliberately share the agent's session (node teardown
        kills the whole group), so a group kill is not available —
        psutil's recursive child walk reaches forked helpers instead."""
        try:
            import psutil

            for child in psutil.Process(worker.proc.pid).children(
                recursive=True
            ):
                try:
                    child.kill()
                except Exception:  # rtlint: disable=swallowed-exception - child already exited
                    pass
        except Exception:  # rtlint: disable=swallowed-exception - process tree gone mid-walk
            pass
        try:
            worker.proc.kill()
        except ProcessLookupError:
            pass

    # ------------------------------------------------------------------
    # resource telemetry
    # ------------------------------------------------------------------
    def _telemetry_sample(self, now: float, vmem, samples: list) -> None:
        """Assemble one node sample from the monitor sweep and buffer it
        for the next heartbeat (piggyback channel — no extra RPC)."""
        import psutil

        worker_rss = {w.worker_id: int(rss) for rss, w in samples}
        sample: dict[str, Any] = {
            "ts": now,
            "mem_used": int(vmem.total - vmem.available),
            "mem_total": int(vmem.total),
            "num_workers": len(self.workers),
            "workers_rss_total": sum(worker_rss.values()),
            "workers_rss_max": max(worker_rss.values(), default=0),
            "worker_rss": worker_rss,
        }
        try:
            # Non-blocking since-last-call percent; the first call of a
            # process returns 0.0 and primes the counter.
            sample["cpu_percent"] = psutil.cpu_percent(None)
        except Exception:  # rtlint: disable=swallowed-exception - cpu sampling is advisory telemetry
            pass
        try:
            store_stats = self.store.stats()
            sample["object_store_bytes"] = int(store_stats.get("used", 0))
            sample["object_store_capacity"] = int(
                store_stats.get("capacity", 0)
            )
        except Exception:  # rtlint: disable=swallowed-exception - store stats are advisory telemetry
            pass
        sample.update(self._hbm_stats())
        self._telemetry_buffer.append(sample)

    def _hbm_stats(self) -> dict:
        """Card memory used/total through the port's ``telemetry.hbm_stats``
        — only when torch is ALREADY imported in this process with CUDA
        initialised, which the agent never does itself: a context here would
        hold memory on the card for the agent's whole life (see
        ``visible_gpus``)."""
        if sys.modules.get("torch") is None:
            return {}
        try:
            from ray_tpu_torch._private.telemetry import hbm_stats

            return hbm_stats()
        except Exception:  # rtlint: disable=swallowed-exception - hbm stats are advisory telemetry
            return {}

    def _check_oom_risk(
        self, now: float, samples: list, limit_bytes: int, cfg
    ) -> None:
        """Trend-aware early warning: when a worker's RSS slope projects
        past the kill limit within oom_risk_horizon_s while its current
        RSS is still under it, report ``oom_risk`` to the controller
        (structured event + metric) BEFORE the point-in-time kill fires."""
        from ray_tpu_torch._private.telemetry import project_rss

        live = set()
        for rss, worker in samples:
            wid = worker.worker_id
            live.add(wid)
            hist = self._rss_history.get(wid)
            if hist is None:
                hist = self._rss_history[wid] = collections.deque(maxlen=8)
            hist.append((now, rss))
            if rss >= limit_bytes:
                continue  # the kill path owns this case
            projected = project_rss(hist, cfg.oom_risk_horizon_s)
            if projected is None or projected < limit_bytes:
                continue
            if now - self._oom_risk_last.get(wid, 0.0) < cfg.oom_risk_cooldown_s:
                continue
            self._oom_risk_last[wid] = now
            print(
                f"[raytpu-agent] oom_risk: worker {wid} rss={rss >> 20} MiB "
                f"projected={int(projected) >> 20} MiB crosses limit "
                f"{limit_bytes >> 20} MiB within {cfg.oom_risk_horizon_s:.0f}s",
                file=sys.stderr,
            )
            spawn_task(
                self._report_oom_risk(
                    {
                        "node_id": self.node_id,
                        "worker_id": wid,
                        "actor_id": worker.actor_id,
                        "rss": int(rss),
                        "projected_rss": int(projected),
                        "limit_bytes": int(limit_bytes),
                        "horizon_s": cfg.oom_risk_horizon_s,
                        "ts": now,
                    }
                )
            )
        for wid in list(self._rss_history):
            if wid not in live:
                self._rss_history.pop(wid, None)
                self._oom_risk_last.pop(wid, None)

    async def _report_oom_risk(self, payload: dict) -> None:
        try:
            await self.controller.call("report_oom_risk", payload)
        except Exception:  # rtlint: disable=swallowed-exception - advisory: never let a warning RPC hurt the agent
            pass  # advisory: never let a warning RPC hurt the agent

    async def _register_with_controller(self) -> None:
        resp = await self.controller.call(
            "register_node",
            {
                "node_id": self.node_id,
                "agent_addr": list(self.address),
                "resources": self.resources_total,
                "labels": self.labels,
                "store_info": self.store_info(),
                # For post-restart reconciliation: actors this node still
                # hosts (a restored ALIVE actor missing here is dead; one
                # the snapshot caught pre-ALIVE is re-attached from this).
                "live_actors": [
                    {
                        "actor_id": w.actor_id,
                        "worker_id": w.worker_id,
                        "addr": list(w.address) if w.address else None,
                    }
                    for w in self.workers.values()
                    if w.actor_id
                ],
                # 2PC reservations held here — lets a restarted controller
                # release prepares its dead predecessor never committed.
                "held_bundles": [
                    {"pg_id": key[0], "index": key[1]}
                    for key in self.bundles
                ],
            },
        )
        # Ghost-worker cleanup after a partition heal: the controller
        # failed these actors over (or they relocated) while we were cut
        # off — keeping their old incarnations alive here would answer
        # stale handles alongside the replacement.
        for entry in (resp or {}).get("stale_actors") or []:
            worker = self.workers.get(entry.get("worker_id") or "")
            if worker is None or worker.actor_id != entry.get("actor_id"):
                continue
            print(
                f"[raytpu-agent] killing ghost worker {worker.worker_id} "
                f"(actor {worker.actor_id} superseded during partition)",
                file=sys.stderr,
            )
            worker.intended_exit = True
            self._kill_worker_tree(worker)

    def store_info(self) -> dict:
        return {
            "socket": self.store_socket,
            "shm_path": self.store_shm,
            "capacity": self.store_capacity,
        }

    @property
    def store(self) -> ObjectStoreClient:
        if self._store_client is None:
            self._store_client = ObjectStoreClient(
                self.store_socket, self.store_shm, self.store_capacity
            )
        return self._store_client

    def _loop_engine(self):
        """The running loop's native RPC engine, or None (asyncio backend)."""
        try:
            from ray_tpu_torch._private.rpc import _NativeEngine

            loop = asyncio.get_event_loop()
            with _NativeEngine._lock:
                return _NativeEngine._by_loop.get(id(loop))
        except Exception:  # rtlint: disable=swallowed-exception - native engine optional; asyncio backend has none
            return None

    def _agent_stats(self) -> dict:
        """Cheap local counters piggybacked on each heartbeat so the
        controller aggregates cluster health without extra RPC fan-out."""
        stats = {
            "workers": len(self.workers),
            "idle_workers": sum(len(v) for v in self.idle_workers.values()),
            "leases": len(self.leases) + len(self._native_leases),
            "bundles": len(self.bundles),
            "resource_waiters": sum(
                len(v) for v in self._resource_waiters.values()
            ),
        }
        engine = self._loop_engine()
        if engine is not None and hasattr(engine, "stats"):
            try:
                stats["engine"] = engine.stats()
            except Exception:  # rtlint: disable=swallowed-exception - engine stats are advisory telemetry
                pass
        return stats

    async def _heartbeat_loop(self) -> None:
        cfg = global_config()
        while True:
            await asyncio.sleep(cfg.health_check_period_ms / 1000.0)
            try:
                self._refresh_available_mirror()
                self._drain_lease_events()
                payload = {
                    "node_id": self.node_id,
                    "resources_available": self.resources_available,
                    "stats": self._agent_stats(),
                }
                # Telemetry piggyback: snapshot (don't drain) the buffer so
                # a failed send retries the same samples next beat — the
                # controller's monotonic-ts guard dedups any replay.
                shipped = list(self._telemetry_buffer)
                if shipped:
                    payload["telemetry"] = shipped
                resp = await self.controller.call("heartbeat", payload)
                for _ in shipped:  # delivered: drop exactly what we sent
                    try:
                        self._telemetry_buffer.popleft()
                    except IndexError:
                        break
                if resp.get("status") in ("unknown_node", "reregister"):
                    # unknown_node: controller restarted without a snapshot
                    # of us. reregister: the controller declared us dead
                    # (partition outlasted the health timeout) and refuses
                    # to silently resurrect — a full re-registration
                    # reconciles live actors/bundles and has the reply name
                    # any ghost workers we must kill.
                    await self._register_with_controller()
            except Exception:
                # Controller unreachable: auto_reconnect redials on the
                # next call; brief pause avoids a hot loop.
                await asyncio.sleep(1.0)

    # ------------------------------------------------------------------
    # resource accounting (native lease table when enabled — one source
    # of truth shared with the engine's grant path)
    # ------------------------------------------------------------------
    def _lease_adjust_native(
        self, resources: dict, sign: int, check: bool = False
    ) -> bool:
        import ctypes

        engine = self._native_lease
        # Cards stay in Python's table: a GPU lease needs a worker whose
        # CUDA_VISIBLE_DEVICES names its cards, which the engine's
        # job-keyed idle pool cannot match, so the engine never grants one.
        items = [(k, float(v)) for k, v in resources.items() if v > 0 and not _is_card_key(k)]
        if not items:
            return True
        names = b"".join(k.encode() + b"\0" for k, _ in items)
        deltas = (ctypes.c_double * len(items))(
            *[sign * v for _, v in items]
        )
        return bool(
            engine.lib.rt_lease_adjust(
                engine.handle, names, deltas, len(items), 1 if check else 0
            )
        )

    def _refresh_available_mirror(self) -> None:
        """Pull the native table into self.resources_available (reporting
        paths only; accounting always goes through the native adjust)."""
        engine = self._native_lease
        if engine is None:
            return
        import ctypes

        buf = ctypes.create_string_buffer(16384)
        n = engine.lib.rt_lease_available_json(engine.handle, buf, 16384)
        if n > 0:
            try:
                native = json.loads(buf.value.decode())
            except ValueError:
                return
            merged = dict(self.resources_available)
            # The engine's table names a card key it was asked for (and
            # refused) at 0: the cards' counts are Python's.
            merged.update({k: v for k, v in native.items() if not _is_card_key(k)})
            self.resources_available = merged

    def _drain_lease_events(self) -> None:
        """Reconcile native grants/returns into _native_leases (needed by
        the bounced return path and worker-death cleanup)."""
        engine = self._native_lease
        if engine is None:
            return
        import ctypes

        buf = ctypes.create_string_buffer(8192)
        while True:
            n = engine.lib.rt_lease_next_event(engine.handle, buf, 8192)
            if n <= 0:
                return
            try:
                event = json.loads(buf.value.decode())
            except ValueError:
                continue
            if event.get("ev") == "grant":
                self._native_leases[event["lease_id"]] = event
            else:
                self._native_leases.pop(event.get("lease_id"), None)

    def _try_consume(self, resources: dict, bundle_key: tuple | None) -> bool:
        if bundle_key is None and self._native_lease is not None:
            pool = self.resources_available
            cards = {k: v for k, v in resources.items() if v > 0 and _is_card_key(k)}
            if any(pool.get(k, 0.0) + 1e-9 < v for k, v in cards.items()):
                return False
            if not self._lease_adjust_native(resources, -1, check=True):
                return False
            for k, v in cards.items():
                pool[k] = pool.get(k, 0.0) - v
            return True
        pool = (
            self.bundles[bundle_key]["available"]
            if bundle_key is not None and bundle_key in self.bundles
            else self.resources_available
        )
        for k, v in resources.items():
            if v > 0 and pool.get(k, 0.0) + 1e-9 < v:
                return False
        for k, v in resources.items():
            if v > 0:
                pool[k] = pool.get(k, 0.0) - v
        return True

    def _wake_waiters(self, freed: dict | None = None) -> None:
        """Wake parked lease requests whose resource shape overlaps the
        freed keys (all shapes when *freed* is None/unknown)."""
        if not self._resource_waiters:
            return
        if freed is None:
            shapes = list(self._resource_waiters)
        else:
            freed_keys = {k for k, v in freed.items() if v > 0}
            shapes = [
                s for s in self._resource_waiters
                if not s or not freed_keys.isdisjoint(s)
            ]
        for shape in shapes:
            for waiter in self._resource_waiters.pop(shape, ()):
                if not waiter.done():
                    waiter.set_result(None)

    def _take_cards(self, resources: dict) -> str | None:
        """Pick the cards of a lease of ``resources["GPU"]``: a share below
        one takes the busiest card that still fits it (two leases at 0.5
        share one card), a whole number n takes n free cards. Returns the
        ``CUDA_VISIBLE_DEVICES`` value ("" for no GPU), or None when no card
        fits now."""
        amount = float(resources.get("GPU", 0.0) or 0.0)
        if amount <= 0:
            return ""
        if amount < 1.0:
            fits = [c for c, free in self._card_free.items() if free + 1e-9 >= amount]
            if not fits:
                return None
            card = min(fits, key=lambda c: self._card_free[c])
            self._card_free[card] -= amount
            return card
        free = [c for c, f in self._card_free.items() if f >= 1.0 - 1e-9]
        count = int(math.ceil(amount - 1e-9))
        if len(free) < count:
            return None
        for card in free[:count]:
            self._card_free[card] -= 1.0
        return ",".join(free[:count])

    def _release_cards(self, cards: str, resources: dict) -> None:
        amount = float(resources.get("GPU", 0.0) or 0.0)
        if not cards or amount <= 0:
            return
        for card in cards.split(","):
            if card in self._card_free:
                self._card_free[card] = min(1.0, self._card_free[card] + min(amount, 1.0))

    def _give_back(self, resources: dict, bundle_key: tuple | None, cards: str = "") -> None:
        self._release_cards(cards, resources)
        if bundle_key is None and self._native_lease is not None:
            self._lease_adjust_native(resources, +1)
            pool = self.resources_available
            for k, v in resources.items():
                if v > 0 and _is_card_key(k):
                    pool[k] = pool.get(k, 0.0) + v
            self._wake_waiters(resources)
            return
        if bundle_key is not None:
            bundle = self.bundles.get(bundle_key)
            # Bundle already released (PG teardown raced this worker/lease
            # death): release_bundle returned the bundle's FULL allocation
            # to the node pool, so crediting the node again here would
            # double-count — two later bundles could then commit onto one
            # slot (observed as a 4-worker gang on 3 one-slot nodes).
            pool = None if bundle is None else bundle["available"]
        else:
            pool = self.resources_available
        if pool is not None:
            for k, v in resources.items():
                if v > 0:
                    pool[k] = pool.get(k, 0.0) + v
        self._wake_waiters(resources)

    async def _on_lease_freed(self, conn, raw) -> None:
        """The engine returned a native lease: its freed resources must
        wake any Python-path request parked in _wait_for_resources."""
        freed = None
        if isinstance(raw, dict):
            freed = raw.get("resources") or None
        self._wake_waiters(freed)

    async def _wait_for_resources(self, resources: dict | None = None) -> None:
        shape = tuple(sorted(k for k, v in (resources or {}).items() if v > 0))
        future = asyncio.get_running_loop().create_future()
        self._resource_waiters.setdefault(shape, []).append(future)
        try:
            await asyncio.wait_for(future, timeout=5.0)
        except asyncio.TimeoutError:
            pass
        finally:
            bucket = self._resource_waiters.get(shape)
            if bucket is not None:
                if future in bucket:
                    bucket.remove(future)
                if not bucket:
                    self._resource_waiters.pop(shape, None)

    # ------------------------------------------------------------------
    # worker pool [N11]
    # ------------------------------------------------------------------
    def _env_hash(self, runtime_env: dict) -> str:
        return repr(sorted((runtime_env or {}).items()))

    @staticmethod
    def _pool_key(env_hash: str, cards: str) -> str:
        # A worker's cards are part of its identity: a lease is never handed
        # a worker that sees other cards than the lease holds.
        return f"{env_hash}|cards={cards}"

    def _pop_idle_worker(self, env_hash: str, job_id: str, cards: str = ""):
        """Reuse a live idle worker only when it belongs to the SAME job —
        its log-forwarding tasks and RAYTPU_JOB_ID were bound at spawn, so
        a cross-job handout would misroute stdout/err to the old driver —
        and sees the same cards."""
        if (
            self._native_lease is not None
            and env_hash == self._default_env_hash
            and not cards
        ):
            # default-env idle workers live in the NATIVE pool (shared
            # with the engine's grant path — one pool, no double-grant)
            import ctypes

            engine = self._native_lease
            buf = ctypes.create_string_buffer(128)
            while engine.lib.rt_lease_pool_pop(
                engine.handle, job_id.encode(), buf, 128
            ):
                worker = self.workers.get(buf.value.decode())
                if (
                    worker is not None
                    and worker.proc.returncode is None
                    and worker.death_reason is None
                ):
                    return worker
            return None
        pool = self.idle_workers.get(self._pool_key(env_hash, cards)) or []
        for i in range(len(pool) - 1, -1, -1):
            candidate = pool[i]
            if (
                candidate.proc.returncode is not None
                or candidate.death_reason is not None
            ):
                pool.pop(i)
                continue
            if candidate.job_id == job_id:
                pool.pop(i)
                return candidate
        return None

    async def _spawn_worker(
        self, runtime_env: dict, job_id: str, actor_mode: bool = False,
        cards: str = "",
    ) -> WorkerProcess:
        worker_id = WorkerID.random()
        env = dict(os.environ)
        # Materialize pip/py_modules/working_dir through the runtime-env
        # manager (URI cache + per-job refcount, reference runtime_env
        # agent role) before the worker exists.
        env_ctx = await self.runtime_envs.setup(runtime_env, job_id)
        env.update(env_ctx.env_vars)
        if env_ctx.python_paths:
            existing_pp = env.get("PYTHONPATH", "")
            env["PYTHONPATH"] = os.pathsep.join(
                env_ctx.python_paths + ([existing_pp] if existing_pp else [])
            )
        env.update(
            {
                "RAYTPU_WORKER_ID": worker_id,
                "RAYTPU_NODE_ID": self.node_id,
                "RAYTPU_JOB_ID": job_id,
                "RAYTPU_CONTROLLER": json.dumps(list(self.controller_addr)),
                "RAYTPU_AGENT": json.dumps(list(self.address)),
                "RAYTPU_STORE": json.dumps(self.store_info()),
                "RAYTPU_SESSION_DIR": self.session_dir,
                # Only the lease's cards; none for a CPU lease, so a
                # worker's first `import torch` opens no context on a card.
                "CUDA_VISIBLE_DEVICES": cards,
            }
        )
        proc = await asyncio.create_subprocess_exec(
            sys.executable,
            "-u",
            "-m",
            "ray_tpu_torch._private.worker_proc",
            env=env,
            cwd=env_ctx.working_dir or None,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        worker = WorkerProcess(
            worker_id, proc, self._env_hash(runtime_env), job_id
        )
        worker.cards = cards
        self.workers[worker_id] = worker
        loop = asyncio.get_running_loop()
        spawn_task(self._forward_logs(worker, proc.stdout, "out", job_id))
        spawn_task(self._forward_logs(worker, proc.stderr, "err", job_id))
        spawn_task(self._watch_worker(worker))
        try:
            await asyncio.wait_for(
                worker.registered.wait(),
                timeout=global_config().worker_register_timeout_s,
            )
        except asyncio.TimeoutError:
            try:
                proc.kill()
            except ProcessLookupError:
                pass
            self.workers.pop(worker_id, None)
            raise RuntimeError("worker failed to register in time")
        return worker

    async def _forward_logs(self, worker, stream, kind: str, job_id: str) -> None:
        path = os.path.join(
            self.log_dir, f"worker-{worker.worker_id[-12:]}.{kind}"
        )
        # rtlint: disable=blocking-in-async - unbuffered append of single lines to a local log; a thread hop per line would cost more than the write
        with open(path, "ab", buffering=0) as sink:
            while True:
                try:
                    line = await stream.readline()
                except (ValueError, asyncio.LimitOverrunError):
                    continue
                if not line:
                    break
                sink.write(line)
                try:
                    await self.controller.call(
                        "publish",
                        {
                            "channel": "logs",
                            "message": {
                                "job_id": job_id,
                                "pid": worker.proc.pid,
                                "kind": kind,
                                "line": line.decode(errors="replace").rstrip("\n"),
                            },
                        },
                    )
                except Exception:  # rtlint: disable=swallowed-exception - log forwarding is best-effort during controller restart
                    pass

    async def _watch_worker(self, worker: WorkerProcess) -> None:
        code = await worker.proc.wait()
        self.workers.pop(worker.worker_id, None)
        engine = self._native_lease
        if engine is not None:
            # purge from the engine's idle pool and release any native
            # lease the dead worker still held; the ban (if any) can go —
            # this worker_id will never be pooled again
            engine.lib.rt_lease_pool_remove(
                engine.handle, worker.worker_id.encode()
            )
            engine.lib.rt_lease_worker_unban(
                engine.handle, worker.worker_id.encode()
            )
            self._drain_lease_events()
            for lease_id, event in list(self._native_leases.items()):
                if event.get("worker_id") == worker.worker_id:
                    self._native_leases.pop(lease_id, None)
                    engine.lib.rt_lease_forget(
                        engine.handle, lease_id.encode()
                    )
                    self._give_back(event.get("resources", {}), None)
        self.death_info[worker.worker_id] = {
            "reason": worker.death_reason
            or ("intended" if worker.intended_exit else "crash"),
            "exit_code": code,
            "rss": worker.oom_rss,
        }
        while len(self.death_info) > 256:
            self.death_info.popitem(last=False)
        pool = self.idle_workers.get(self._pool_key(worker.env_hash, worker.cards))
        if pool and worker in pool:
            pool.remove(worker)
        if worker.job_id and not any(
            w.job_id == worker.job_id for w in self.workers.values()
        ):
            # Last worker of the job on this node: drop its runtime-env
            # references so unreferenced envs become GC-eligible.
            self.runtime_envs.release_job(worker.job_id)
        # Release any lease resources still held.
        for lease in [l for l in self.leases.values() if l.worker is worker]:
            self.leases.pop(lease.lease_id, None)
            self._give_back(lease.resources, lease.bundle_key, lease.cards)
        if worker.actor_id and worker.resources:
            self._give_back(
                worker.resources,
                (worker.bundle["pg_id"], worker.bundle["bundle_index"])
                if worker.bundle
                else None,
                worker.cards,
            )
        try:
            await self.controller.call(
                "worker_died",
                {
                    "worker_id": worker.worker_id,
                    "node_id": self.node_id,
                    "actor_id": worker.actor_id,
                    "exit_code": code,
                    "intended": worker.intended_exit,
                    "reason": worker.death_reason,
                },
            )
        except Exception as exc:
            # The controller missing a death report delays actor restart
            # until its own liveness probe fires — worth a breadcrumb.
            print(
                f"[raytpu-agent] worker_died report for "
                f"{worker.worker_id} failed: {exc!r}",
                file=sys.stderr, flush=True,
            )

    async def rpc_worker_death_info(self, conn, payload) -> dict:
        """Why a worker died (owner-side OOM attribution, N15). `alive`
        lets callers stop polling: a live worker will never grow a
        tombstone."""
        worker_id = payload.get("worker_id", "")
        worker = self.workers.get(worker_id)
        # "alive" must be false while a kill is in flight (death mark set,
        # process not yet reaped) — the tombstone IS coming; callers that
        # stopped polling here would misattribute an OOM as a crash.
        alive = (
            worker is not None
            and worker.proc.returncode is None
            and worker.death_reason is None
        )
        return {
            "status": "ok",
            "info": self.death_info.get(worker_id),
            "alive": alive,
        }

    # ------------------------------------------------------------------
    # RPC: worker registration + leases
    # ------------------------------------------------------------------
    async def rpc_register_worker(self, conn: ServerConnection, payload) -> dict:
        worker = self.workers.get(payload["worker_id"])
        if worker is None:
            return {"status": "unknown_worker"}
        worker.address = tuple(payload["address"])
        worker.registered.set()
        return {"status": "ok"}

    async def rpc_lease_worker(self, conn, payload) -> dict:
        resources = payload["resources"]
        runtime_env = payload.get("runtime_env") or {}
        bundle = payload.get("bundle")
        bundle_key = (bundle["pg_id"], bundle["bundle_index"]) if bundle else None
        if bundle_key is not None and bundle_key not in self.bundles:
            # bundle_index -1: any bundle of the pg on this node
            if bundle and bundle["bundle_index"] == -1:
                match = next(
                    (k for k in self.bundles if k[0] == bundle["pg_id"]), None
                )
                bundle_key = match
            if bundle_key is None or bundle_key not in self.bundles:
                return {"status": "no_bundle"}
        deadline = time.monotonic() + 8.0
        while True:
            if self._try_consume(resources, bundle_key):
                cards = self._take_cards(resources)
                if cards is not None:
                    break
                self._give_back(resources, bundle_key)
            if time.monotonic() > deadline:
                return {"status": "busy"}
            await self._wait_for_resources(resources)
        env_hash = self._env_hash(runtime_env)
        worker = self._pop_idle_worker(env_hash, payload.get("job_id", ""), cards)
        if worker is None:
            trace_ctx = (
                payload.get("trace_ctx") if tracing.enabled() else None
            )
            spawn_start_ns = time.time_ns() if trace_ctx else 0
            try:
                worker = await self._spawn_worker(
                    runtime_env, payload.get("job_id", ""), cards=cards)
            except Exception as exc:
                if trace_ctx:
                    tracing.emit(
                        "worker_start", trace_ctx, start_ns=spawn_start_ns,
                        status="error", node_id=self.node_id,
                        error_type=type(exc).__name__,
                    )
                self._give_back(resources, bundle_key, cards)
                return {"status": "spawn_failed", "error": str(exc)}
            if trace_ctx:
                # Cold-start cost: only emitted when a lease actually
                # forced a spawn (idle-pool hits are free).
                tracing.emit(
                    "worker_start", trace_ctx, start_ns=spawn_start_ns,
                    node_id=self.node_id, worker_id=worker.worker_id,
                )
        lease = Lease(worker, resources, bundle_key, cards)
        self.leases[lease.lease_id] = lease
        return {
            "status": "ok",
            "lease_id": lease.lease_id,
            "worker_id": worker.worker_id,
            "worker_addr": list(worker.address),
        }

    async def rpc_return_worker(self, conn, payload) -> dict:
        lease = self.leases.pop(payload["lease_id"], None)
        if lease is None:
            # Possibly a NATIVE lease bounced here (reusable=False kill
            # path, or a lease granted by the engine for a worker that
            # died): reconcile from the engine's event log.
            self._drain_lease_events()
            native = self._native_leases.pop(payload["lease_id"], None)
            if native is None:
                return {"status": "unknown_lease"}
            engine = self._native_lease
            if engine is not None:
                engine.lib.rt_lease_forget(
                    engine.handle, payload["lease_id"].encode()
                )
            self._give_back(native.get("resources", {}), None)
            worker = self.workers.get(native.get("worker_id", ""))
            if worker is not None and worker.proc.returncode is None:
                # reusable leases never bounce — this is the kill path
                worker.intended_exit = True
                self._kill_worker_tree(worker)
            return {"status": "ok"}
        self._give_back(lease.resources, lease.bundle_key, lease.cards)
        worker = lease.worker
        if worker.proc.returncode is None and not worker.actor_id:
            if payload.get("reusable", True) and worker.death_reason is None:
                if (
                    self._native_lease is not None
                    and worker.env_hash == self._default_env_hash
                    and not worker.cards
                    and worker.address is not None
                ):
                    # hand the warm worker to the engine's grant pool —
                    # the next same-job lease never touches asyncio
                    engine = self._native_lease
                    engine.lib.rt_lease_pool_put(
                        engine.handle, worker.worker_id.encode(),
                        worker.job_id.encode(),
                        worker.address[0].encode(),
                        int(worker.address[1]),
                    )
                    return {"status": "ok"}
                self.idle_workers.setdefault(
                    self._pool_key(worker.env_hash, worker.cards), []
                ).append(worker)
            else:
                # reusable=False (the owner saw the conn die) or a pending
                # death mark: pooling would burn the next lease's tasks,
                # and leaving the process idling would leak it (and its
                # RSS) forever — kill it; the pool respawns on demand.
                worker.intended_exit = True
                self._kill_worker_tree(worker)
        return {"status": "ok"}

    # ------------------------------------------------------------------
    # RPC: actors
    # ------------------------------------------------------------------
    async def rpc_start_actor(self, conn, payload) -> dict:
        spec = payload["spec"]
        # Idempotent by actor_id: a retried start_actor (dropped reply,
        # duplicated request, controller re-schedule racing a slow ack)
        # must return the EXISTING incarnation, not spawn a second worker
        # that double-consumes resources and runs __init__ twice.
        for worker in self.workers.values():
            if (
                worker.actor_id == spec["actor_id"]
                and worker.proc.returncode is None
                and worker.address is not None
            ):
                return {
                    "status": "ok",
                    "worker_id": worker.worker_id,
                    "worker_addr": list(worker.address),
                    "pid": worker.proc.pid,
                }
        resources = spec.get("resources") or {"CPU": 1}
        strategy = spec.get("scheduling_strategy") or {}
        bundle = None
        bundle_key = None
        if strategy.get("kind") == "pg":
            index = strategy.get("bundle_index", -1)
            if index == -1:
                bundle_key = next(
                    (k for k in self.bundles if k[0] == strategy["pg_id"]), None
                )
            else:
                bundle_key = (strategy["pg_id"], index)
            if bundle_key is None or bundle_key not in self.bundles:
                return {"status": "no_bundle"}
            bundle = {"pg_id": bundle_key[0], "bundle_index": bundle_key[1]}
        if not self._try_consume(resources, bundle_key):
            return {"status": "busy"}
        cards = self._take_cards(resources)
        if cards is None:
            self._give_back(resources, bundle_key)
            return {"status": "busy"}
        # Prefer a warm idle worker (reference WorkerPool reuse): a fresh
        # interpreter costs seconds of imports, which under CPU contention
        # can push actor readiness past client deadlines.
        env_hash = self._env_hash(spec.get("runtime_env") or {})
        worker = self._pop_idle_worker(env_hash, spec.get("job_id", ""), cards)
        if worker is None:
            try:
                worker = await self._spawn_worker(
                    spec.get("runtime_env") or {}, spec.get("job_id", ""),
                    actor_mode=True, cards=cards,
                )
            except Exception as exc:
                self._give_back(resources, bundle_key, cards)
                return {"status": "spawn_failed", "error": str(exc)}
        worker.actor_id = spec["actor_id"]
        worker.resources = resources
        worker.bundle = bundle
        worker_client = RpcClient(worker.address, name="agent-to-worker")
        try:
            await worker_client.connect()
            # Bounded: a wedged worker must surface as creation_failed (the
            # controller retries on a fresh worker), not hang the scheduler.
            resp = await worker_client.call(
                "create_actor",
                {"spec": spec, "creation_args": payload.get("creation_args")},
                timeout=global_config().worker_register_timeout_s + 60,
            )
        except Exception as exc:
            self._fail_actor_worker(worker)
            self._give_back(resources, bundle_key, cards)
            return {"status": "creation_failed", "error": str(exc)}
        finally:
            await worker_client.close()
        if resp.get("status") != "ok":
            self._fail_actor_worker(worker)
            self._give_back(resources, bundle_key, cards)
            return {"status": "creation_failed", "error": resp.get("error")}
        return {
            "status": "ok",
            "worker_id": worker.worker_id,
            "worker_addr": list(worker.address),
            "pid": worker.proc.pid,
        }

    def _fail_actor_worker(self, worker: WorkerProcess) -> None:
        """Kill a worker whose actor creation failed. Clears the actor
        bookkeeping FIRST so _watch_worker does not give the same resources
        back a second time (the creation path already does)."""
        worker.actor_id = None
        worker.resources = {}
        worker.bundle = None
        worker.intended_exit = True
        try:
            worker.proc.kill()
        except ProcessLookupError:
            pass

    async def rpc_kill_worker(self, conn, payload) -> dict:
        worker = self.workers.get(payload["worker_id"])
        if worker is None:
            return {"status": "missing"}
        worker.intended_exit = bool(payload.get("intended", True))
        try:
            worker.proc.kill()
        except ProcessLookupError:
            pass
        return {"status": "ok"}

    async def rpc_chaos_kill_worker(self, conn, payload) -> dict:
        """ChaosMonkey hook: SIGKILL one hosted worker, UNintended — the
        death flows through the normal crash-report path (worker_died →
        controller restart policy). Deterministic victim selection:
        workers sorted by worker_id, indexed by the schedule."""
        candidates = sorted(
            (w for w in self.workers.values() if w.proc.returncode is None),
            key=lambda w: w.worker_id,
        )
        if payload.get("prefer") == "actor":
            actor_workers = [w for w in candidates if w.actor_id]
            candidates = actor_workers or candidates
        if not candidates:
            return {"status": "no_workers"}
        worker = candidates[int(payload.get("index", 0)) % len(candidates)]
        worker.death_reason = "chaos"
        self._kill_worker_tree(worker)
        return {
            "status": "ok",
            "worker_id": worker.worker_id,
            "actor_id": worker.actor_id,
        }

    # ------------------------------------------------------------------
    # RPC: placement group bundles (raylet side of the 2PC [N3])
    # ------------------------------------------------------------------
    async def rpc_prepare_bundle(self, conn, payload) -> dict:
        key = (payload["pg_id"], payload["bundle_index"])
        if key in self.bundles:
            return {"status": "ok"}
        resources = payload["resources"]
        if not self._try_consume(resources, None):
            return {"status": "insufficient"}
        self.bundles[key] = {
            "resources": dict(resources),
            "available": dict(resources),
            "committed": False,
        }
        return {"status": "ok"}

    async def rpc_commit_bundle(self, conn, payload) -> dict:
        key = (payload["pg_id"], payload["bundle_index"])
        bundle = self.bundles.get(key)
        if bundle is None:
            return {"status": "missing"}
        bundle["committed"] = True
        return {"status": "ok"}

    async def rpc_release_bundle(self, conn, payload) -> dict:
        key = (payload["pg_id"], payload["bundle_index"])
        bundle = self.bundles.pop(key, None)
        if bundle is None:
            return {"status": "missing"}
        self._give_back(bundle["resources"], None)
        return {"status": "ok"}

    # ------------------------------------------------------------------
    # RPC: object plane (object_manager.cc [N16]: C++ push + chunked pull
    # fallback)
    # ------------------------------------------------------------------
    async def rpc_pull_object_chunk(self, conn, payload) -> dict:
        object_id = payload["object_id"]
        view = self.store.get(object_id, timeout_ms=0)
        if view is None:
            return {"status": "missing"}
        try:
            self.pull_chunks_served += 1
            total = len(view)
            start = payload.get("offset", 0)
            end = min(start + payload.get("chunk", 5 * 1024 * 1024), total)
            return {"status": "ok", "data": bytes(view[start:end]), "total": total}
        finally:
            self.store.release(object_id)

    async def rpc_push_object(self, conn, payload) -> dict:
        """Push one of this node's objects to another node's agent
        (push_manager.cc role): the C++ sender thread slices it into
        obj_chunk frames — no per-chunk Python on either side. Replies
        as soon as the transfer is queued; the pull path remains the
        fallback if the transfer is dropped (budget/conn loss)."""
        import ctypes

        import numpy as np

        from ray_tpu_torch._private.rpc import _NativeEngine

        object_id = payload["object_id"]
        target = (payload["target_host"], payload["target_port"])
        try:
            engine = _NativeEngine.for_running_loop()
        except Exception:
            return {"status": "unsupported"}
        view = self.store.get(object_id, timeout_ms=0)
        if view is None:
            return {"status": "missing"}
        try:
            client = self._transfer_clients.get(target)
            if client is None or not client.connected:
                client = RpcClient(
                    target, name=f"xfer-to-{target[1]}"
                )
                await client.connect()
                self._transfer_clients[target] = client
            conn_id = getattr(client, "_conn_id", None)
            if conn_id is None:
                return {"status": "unsupported"}
            buf = np.frombuffer(view, dtype=np.uint8)
            # Executor thread: rt_push_object memcpys the whole object
            # into the sender's job buffer — a multi-hundred-MB copy must
            # not stall this event loop (engine.lib is CDLL: GIL released)
            loop = asyncio.get_running_loop()
            rc = await loop.run_in_executor(
                None,
                engine.lib.rt_push_object,
                engine.handle, conn_id, object_id.encode(),
                ctypes.c_void_p(buf.ctypes.data), len(view),
            )
            if rc != 0:
                return {"status": "busy" if rc == -1 else "error"}
            self.pushes_started += 1
            return {"status": "ok", "size": len(view)}
        finally:
            self.store.release(object_id)

    async def _on_obj_complete(self, conn, raw) -> None:
        """One inbound object fully reassembled by the engine: land it in
        this node's store and release the C++ buffer."""
        import ctypes

        from ray_tpu_torch._private.rpc import _NativeEngine

        object_id = bytes(raw).decode()
        try:
            engine = _NativeEngine.for_running_loop()
            ptr = ctypes.c_void_p()
            length = ctypes.c_uint64()
            if engine.lib.rt_transfer_take(
                engine.handle, object_id.encode(),
                ctypes.byref(ptr), ctypes.byref(length),
            ) != 0:
                return
            try:
                data = (
                    ctypes.c_ubyte * length.value
                ).from_address(ptr.value)
                try:
                    # .cast("B"): ctypes views carry an endian-prefixed
                    # format that memoryview slice-assign rejects
                    self.store.put(object_id, memoryview(data).cast("B"))
                except FileExistsError:
                    pass
                self.pushes_received += 1
            finally:
                engine.lib.rt_transfer_free(
                    engine.handle, object_id.encode()
                )
        except Exception:  # rtlint: disable=swallowed-exception - pull fallback still serves the object
            pass  # pull fallback still serves the object

    async def rpc_delete_object(self, conn, payload) -> dict:
        ok = self.store.delete(payload["object_id"])
        return {"status": "ok" if ok else "missing"}

    async def rpc_store_stats(self, conn, payload) -> dict:
        stats = self.store.stats()
        stats["transfer"] = {
            "pull_chunks_served": self.pull_chunks_served,
            "pushes_started": self.pushes_started,
            "pushes_received": self.pushes_received,
        }
        # Leases the PYTHON path still holds (direct-lane workers not yet
        # past their reuse grace): lets callers detect true quiescence
        # instead of "at least one worker returned".
        self._drain_lease_events()
        stats["leases_outstanding"] = len(self.leases) + len(self._native_leases)
        engine = self._native_lease
        if engine is not None:
            import ctypes

            out = (ctypes.c_longlong * 4)()
            engine.lib.rt_lease_stats(engine.handle, out)
            stats["native_lease"] = {
                "grants": int(out[0]),
                "returns": int(out[1]),
                "idle_workers": int(out[2]),
                "active": int(out[3]),
            }
        loop_engine = self._loop_engine()
        if loop_engine is not None and hasattr(loop_engine, "stats"):
            try:
                stats["engine"] = loop_engine.stats()
            except Exception:  # rtlint: disable=swallowed-exception - engine stats are advisory telemetry
                pass
        return stats

    async def rpc_runtime_env_info(self, conn, payload) -> dict:
        return self.runtime_envs.cache_info()

    async def _forward_to_worker(
        self, worker_id: str, method: str, payload: dict
    ) -> dict:
        """One-shot RPC into a worker this node hosts (reporter-agent role:
        the dashboard reaches workers through their node agent)."""
        worker = self.workers.get(worker_id or "")
        if worker is None or worker.address is None:
            return {"status": "error", "error": "unknown worker"}
        client = RpcClient(tuple(worker.address), name=f"{method}-fwd")
        try:
            await client.connect(retry=False)
            return await client.call(method, payload, timeout=30.0)
        except Exception as exc:
            return {"status": "error", "error": str(exc)}
        finally:
            await client.close()

    async def rpc_profile_worker(self, conn, payload) -> dict:
        """XLA profiler start/stop on one of this node's workers
        (SURVEY §5.1 TPU-equiv of py-spy/profiler triggers)."""
        return await self._forward_to_worker(
            payload.get("worker_id", ""),
            "profiler",
            {
                "action": payload.get("action"),
                "log_dir": payload.get("log_dir"),
            },
        )

    async def rpc_profile_gang(self, conn, payload) -> dict:
        """Step-profiler fan-out (the comm_evidence shape):
        apply one profiler action — arm / status / collect / abort — to
        this node's workers in parallel. ``workers`` limits the fan-out
        to named worker ids (the controller targets the armed ranks);
        absent, every local worker is asked (the status sweep that
        discovers which workers ARE train ranks)."""
        req = dict((payload or {}).get("args") or {})
        req["action"] = (payload or {}).get("action")
        worker_ids = (payload or {}).get("workers")
        if worker_ids is None:
            worker_ids = list(self.workers)
        else:
            worker_ids = [w for w in worker_ids if w in self.workers]
        results = await asyncio.gather(
            *(
                self._forward_to_worker(wid, "profiler", req)
                for wid in worker_ids
            ),
            return_exceptions=True,
        )
        workers = {}
        for wid, res in zip(worker_ids, results):
            if isinstance(res, BaseException):
                res = {"status": "error", "error": str(res)}
            workers[wid] = res
        return {"status": "ok", "node_id": self.node_id, "workers": workers}

    async def rpc_stack_trace_worker(self, conn, payload) -> dict:
        """Live thread stacks of a worker (dashboard 'Stack Trace' role)."""
        return await self._forward_to_worker(
            payload.get("worker_id", ""), "stack_trace", {}
        )

    async def rpc_comm_evidence(self, conn, payload) -> dict:
        """Hang-doctor fan-out: gather every local worker's comm flight
        snapshot (+ stacks) in parallel, one agent hop per node."""
        req = {
            "last_n": int((payload or {}).get("last_n", 256)),
            "stacks": bool((payload or {}).get("stacks", True)),
        }
        worker_ids = list(self.workers)
        results = await asyncio.gather(
            *(
                self._forward_to_worker(wid, "comm_flight", req)
                for wid in worker_ids
            ),
            return_exceptions=True,
        )
        workers = {}
        for wid, res in zip(worker_ids, results):
            if isinstance(res, BaseException):
                res = {"status": "error", "error": str(res)}
            workers[wid] = res
        return {"status": "ok", "node_id": self.node_id, "workers": workers}

    async def rpc_node_info(self, conn, payload) -> dict:
        self._refresh_available_mirror()
        return {
            "node_id": self.node_id,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "num_workers": len(self.workers),
        }

    async def shutdown(self) -> None:
        for worker in list(self.workers.values()):
            worker.intended_exit = True
            try:
                worker.proc.kill()
            except ProcessLookupError:
                pass
        await self.server.stop()
        if self.store_server is not None:
            self.store_server.stop()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--controller", required=True, help="host:port")
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--store-capacity", type=int, default=0)
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args()
    host, port = args.controller.rsplit(":", 1)

    async def run() -> None:
        agent = NodeAgent(
            args.node_id,
            (host, int(port)),
            args.session_dir,
            resources=json.loads(args.resources),
            store_capacity=args.store_capacity,
        )
        addr = await agent.start(args.port)
        # Atomic: the head polls for this discovery file.
        from ray_tpu_torch._private.atomic_io import atomic_write_json

        atomic_write_json(
            os.path.join(args.session_dir, f"agent-{args.node_id[-8:]}.addr"),
            {"addr": list(addr), "store": agent.store_info()},
        )
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
