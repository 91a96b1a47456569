"""Cluster process spawning — head-node bootstrap.

Role-equivalent of python/ray/_private/{node.py,services.py} in the
reference: starts the controller (gcs_server-equiv) and node agent
(raylet-equiv) subprocesses, manages the session directory
(``<tempdir>/raytpu_torch/session_*/`` with logs + sockets: the
port's own root, apart from the reference's ``raytpu``), and tears everything down.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from ray_tpu_torch._private.ids import NodeID


def _child_env(extra: dict | None = None) -> dict:
    """Child processes must be able to import ray_tpu_torch even when the driver
    loaded it from a source checkout rather than site-packages."""
    env = dict(os.environ)
    package_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    existing = env.get("PYTHONPATH", "")
    if package_root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = (
            package_root + (os.pathsep + existing if existing else "")
        )
    from ray_tpu_torch._private.config import applied_system_config

    system_config = applied_system_config()
    if system_config:
        env["RAYTPU_SYSTEM_CONFIG"] = json.dumps(system_config)
    if extra:
        env.update(extra)
    return env


def new_session_dir() -> str:
    import uuid

    base = os.path.join(tempfile.gettempdir(), "raytpu_torch")
    os.makedirs(base, exist_ok=True)
    # Random suffix: second+pid alone collide when one process creates two
    # clusters within a second (e.g. back-to-back pytest fixtures), which
    # would hand the new cluster the old cluster's stale controller.addr
    # and persisted snapshot.
    session = os.path.join(
        base,
        f"session_{int(time.time())}_{os.getpid()}_{uuid.uuid4().hex[:6]}",
    )
    os.makedirs(session, exist_ok=True)
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    return session


def _wait_for_file(path: str, timeout: float = 120.0) -> str:
    # Generous default: on a loaded single-core host, a fresh subprocess's
    # interpreter+import startup alone can exceed 30s.
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                content = f.read()
            if content.strip():
                return content
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {path}")


class ProcessHandle:
    def __init__(self, proc: subprocess.Popen, name: str):
        self.proc = proc
        self.name = name

    def kill(self) -> None:
        if self.proc.poll() is None:
            # Kill the whole process group: a dead node takes its workers
            # with it (they share the agent's session, set via setsid).
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                try:
                    self.proc.send_signal(signal.SIGKILL)
                except ProcessLookupError:
                    pass

    def alive(self) -> bool:
        return self.proc.poll() is None


def start_controller(session_dir: str, port: int = 0) -> tuple[ProcessHandle, tuple]:
    # Drop any stale address file so _wait_for_file can't return the
    # previous controller's port before the new process binds.
    try:
        os.remove(os.path.join(session_dir, "controller.addr"))
    except FileNotFoundError:
        pass
    log = open(os.path.join(session_dir, "logs", "controller.out"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "ray_tpu_torch._private.controller",
         "--session-dir", session_dir, "--port", str(port)],
        stdout=log,
        stderr=subprocess.STDOUT,
        env=_child_env(),
        start_new_session=True,
    )
    raw = _wait_for_file(os.path.join(session_dir, "controller.addr"))
    info = json.loads(raw)
    return ProcessHandle(proc, "controller"), (info["host"], info["port"])


def start_node_agent(
    session_dir: str,
    controller_addr: tuple,
    node_id: str | None = None,
    resources: dict | None = None,
    store_capacity: int = 0,
    env: dict | None = None,
) -> tuple[ProcessHandle, tuple, dict, str]:
    node_id = node_id or NodeID.random()
    log = open(
        os.path.join(session_dir, "logs", f"agent-{node_id[-8:]}.out"), "ab"
    )
    spawn_env = _child_env(env)
    proc = subprocess.Popen(
        [
            sys.executable, "-u", "-m", "ray_tpu_torch._private.node_agent",
            "--node-id", node_id,
            "--controller", f"{controller_addr[0]}:{controller_addr[1]}",
            "--session-dir", session_dir,
            "--resources", json.dumps(resources or {}),
            "--store-capacity", str(store_capacity),
        ],
        stdout=log,
        stderr=subprocess.STDOUT,
        env=spawn_env,
        start_new_session=True,
    )
    raw = _wait_for_file(os.path.join(session_dir, f"agent-{node_id[-8:]}.addr"))
    info = json.loads(raw)
    return ProcessHandle(proc, f"agent-{node_id[-8:]}"), tuple(info["addr"]), info["store"], node_id


class LocalCluster:
    """One controller + one or more node agents on this machine."""

    def __init__(self, session_dir: str | None = None):
        self.session_dir = session_dir or new_session_dir()
        self.controller_handle: ProcessHandle | None = None
        self.controller_addr: tuple | None = None
        self.agents: list[ProcessHandle] = []
        # Parallel to self.agents: each agent's RPC address and node id
        # (chaos tooling targets agents by index or node id).
        self.agent_addrs: list[tuple] = []
        self.agent_node_ids: list[str] = []
        self.head_store_info: dict | None = None
        self.head_node_id: str | None = None
        self.head_agent_addr: tuple | None = None
        atexit.register(self.shutdown)

    def start_head(
        self,
        resources: dict | None = None,
        store_capacity: int = 0,
    ) -> None:
        self.controller_handle, self.controller_addr = start_controller(
            self.session_dir
        )
        handle, addr, store, node_id = start_node_agent(
            self.session_dir,
            self.controller_addr,
            resources=resources,
            store_capacity=store_capacity,
        )
        self.agents.append(handle)
        self.agent_addrs.append(addr)
        self.agent_node_ids.append(node_id)
        self.head_agent_addr = addr
        self.head_store_info = store
        self.head_node_id = node_id

    def kill_controller(self) -> None:
        """SIGKILL the control plane (GCS fault-tolerance testing)."""
        if self.controller_handle is not None:
            self.controller_handle.kill()
            self.controller_handle = None

    def restart_controller(self) -> None:
        """Start a fresh controller process on the SAME address; it restores
        state from the session's snapshot and agents/drivers reconnect."""
        assert self.controller_addr is not None, "cluster never started"
        if self.controller_handle is not None:
            self.kill_controller()
        self.controller_handle, self.controller_addr = start_controller(
            self.session_dir, port=self.controller_addr[1]
        )

    def add_node(
        self, resources: dict | None = None, store_capacity: int = 0
    ) -> str:
        handle, addr, store, node_id = start_node_agent(
            self.session_dir, self.controller_addr, resources=resources,
            store_capacity=store_capacity,
        )
        self.agents.append(handle)
        self.agent_addrs.append(addr)
        self.agent_node_ids.append(node_id)
        return node_id

    def shutdown(self) -> None:
        for handle, node_id in zip(self.agents, self.agent_node_ids):
            handle.kill()
            # A SIGKILLed agent never unlinks its arena (the reference's
            # leaves it to the next agent's sweep): reap the agent, then
            # unlink /dev/shm/raytpu_torch-<agent pid>-<node suffix>.
            try:
                handle.proc.wait(timeout=10)
                os.unlink(f"/dev/shm/raytpu_torch-{handle.proc.pid}-{node_id[-8:]}")
            except (subprocess.TimeoutExpired, OSError):
                pass
        if self.controller_handle is not None:
            self.controller_handle.kill()
            try:
                self.controller_handle.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self.agents = []
        self.agent_node_ids = []
        self.controller_handle = None
