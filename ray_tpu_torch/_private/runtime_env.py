"""Per-node runtime-environment materialization.

Role-equivalent of the reference's runtime-env agent
(python/ray/_private/runtime_env/{agent,pip,working_dir,py_modules,plugin}.py):
before a worker starts under a runtime env, the node agent materializes
each plugin's resources into a per-node cache keyed by content URI, with
reference counting per job and LRU deletion of unreferenced entries.

Design differences from the reference (deliberate, documented):

- The manager runs **inside the node agent's process** instead of a
  sidecar agent process. Our node agent is already an asyncio daemon and
  the materialization work (pip subprocess, file copies) runs off-loop in
  a thread executor, so a separate process buys nothing here.
- URIs are content hashes computed locally (``pip://<sha1-of-reqs>``,
  ``pydir://<sha1-of-tree>``), not GCS-uploaded packages: every node can
  reach the job's submitted working_dir through the controller KV if it
  is remote, and local paths are the common case in tests and single-host
  clusters.

Plugins implemented: ``env_vars``, ``working_dir``, ``pip``,
``py_modules``. Unknown keys raise, matching the reference's validation.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import shutil
import sys
import time
import zipfile
from dataclasses import dataclass, field

from ray_tpu_torch._private.config import global_config
from ray_tpu_torch import exceptions

KNOWN_FIELDS = {
    "env_vars",
    "working_dir",
    "pip",
    "py_modules",
    "config",
}


def validate_runtime_env(runtime_env: dict | None) -> dict:
    env = dict(runtime_env or {})
    unknown = set(env) - KNOWN_FIELDS
    if unknown:
        raise ValueError(
            f"Unknown runtime_env field(s) {sorted(unknown)}; "
            f"supported: {sorted(KNOWN_FIELDS)}"
        )
    if "pip" in env and env["pip"] is not None:
        pip = env["pip"]
        if isinstance(pip, str):
            env["pip"] = [pip]
        elif isinstance(pip, dict):
            env["pip"] = list(pip.get("packages", []))
        elif not isinstance(pip, (list, tuple)):
            raise ValueError("runtime_env['pip'] must be a list / str / dict")
    if "py_modules" in env and env["py_modules"] is not None:
        if not isinstance(env["py_modules"], (list, tuple)):
            raise ValueError("runtime_env['py_modules'] must be a list")
    return env


def _hash_tree(path: str) -> str:
    """Content hash of a file or directory tree (names + bytes)."""
    digest = hashlib.sha1()
    if os.path.isfile(path):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                digest.update(chunk)
        return digest.hexdigest()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        # __pycache__ churns between runs without semantic change.
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in sorted(files):
            full = os.path.join(root, name)
            digest.update(os.path.relpath(full, path).encode())
            try:
                with open(full, "rb") as fh:
                    for chunk in iter(lambda: fh.read(1 << 20), b""):
                        digest.update(chunk)
            except OSError:
                continue
    return digest.hexdigest()


def _publish_dir(tmp: str, target: str) -> None:
    """Atomically publish a staged dir; another process winning the same
    content-addressed target is equivalent — discard ours and use theirs."""
    try:
        os.replace(tmp, target)
    except OSError:
        if os.path.isdir(target):
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            raise


def _dir_size(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


@dataclass
class CacheEntry:
    uri: str
    path: str
    size: int = 0
    refs: set = field(default_factory=set)  # job ids
    last_used: float = field(default_factory=time.monotonic)


@dataclass
class EnvContext:
    """What a materialized runtime env contributes to a worker spawn."""

    env_vars: dict = field(default_factory=dict)
    python_paths: list = field(default_factory=list)
    working_dir: str | None = None
    uris: list = field(default_factory=list)


class RuntimeEnvManager:
    """Materializes runtime envs into ``<session_dir>/runtime_env/``.

    Concurrency: ``setup`` may be called for many workers at once; per-URI
    creation is single-flighted through an asyncio lock so two workers
    needing the same pip env trigger one install.
    """

    def __init__(self, session_dir: str):
        self.root = os.path.join(session_dir, "runtime_env")
        os.makedirs(self.root, exist_ok=True)
        self._cache: dict[str, CacheEntry] = {}
        self._locks: dict[str, asyncio.Lock] = {}
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    # -- public ---------------------------------------------------------
    async def setup(self, runtime_env: dict | None, job_id: str) -> EnvContext:
        env = validate_runtime_env(runtime_env)
        ctx = EnvContext()
        ctx.env_vars = {
            str(k): str(v) for k, v in (env.get("env_vars") or {}).items()
        }
        timeout = global_config().runtime_env_setup_timeout_s
        try:
            if env.get("pip"):
                entry = await asyncio.wait_for(
                    self._get_or_create_pip(list(env["pip"]), job_id), timeout
                )
                ctx.python_paths.append(entry.path)
                ctx.uris.append(entry.uri)
            for module in env.get("py_modules") or []:
                entry = await asyncio.wait_for(
                    self._get_or_create_py_module(str(module), job_id), timeout
                )
                ctx.python_paths.append(entry.path)
                ctx.uris.append(entry.uri)
            working_dir = env.get("working_dir")
            if working_dir:
                if str(working_dir).endswith(".zip"):
                    entry = await asyncio.wait_for(
                        self._get_or_create_zip_dir(str(working_dir), job_id),
                        timeout,
                    )
                    ctx.working_dir = entry.path
                    ctx.uris.append(entry.uri)
                else:
                    # Plain directories are used in place (single-host /
                    # shared-filesystem case; also what the existing
                    # working_dir tests rely on).
                    ctx.working_dir = str(working_dir)
        except asyncio.TimeoutError:
            raise exceptions.RuntimeEnvSetupError(
                f"runtime env setup timed out after {timeout:.0f}s: {env}"
            )
        return ctx

    def release_job(self, job_id: str) -> None:
        """Drop ``job_id``'s references; GC unreferenced entries over cap."""
        for entry in self._cache.values():
            entry.refs.discard(job_id)
        self._evict_over_cap()

    def cache_info(self) -> dict:
        return {
            "entries": [
                {
                    "uri": e.uri,
                    "path": e.path,
                    "size": e.size,
                    "refs": sorted(e.refs),
                }
                for e in self._cache.values()
            ],
            **self.stats,
        }

    # -- plugin creation ------------------------------------------------
    async def _single_flight(self, uri: str, job_id: str, create) -> CacheEntry:
        lock = self._locks.setdefault(uri, asyncio.Lock())
        async with lock:
            entry = self._cache.get(uri)
            if entry is not None and os.path.isdir(entry.path):
                self.stats["hits"] += 1
            else:
                self.stats["misses"] += 1
                path = await create()
                entry = CacheEntry(uri=uri, path=path, size=_dir_size(path))
                self._cache[uri] = entry
            entry.refs.add(job_id)
            entry.last_used = time.monotonic()
            return entry

    async def _get_or_create_pip(
        self, reqs: list[str], job_id: str
    ) -> CacheEntry:
        digest = hashlib.sha1("\n".join(sorted(reqs)).encode()).hexdigest()
        uri = f"pip://{digest}"
        target = os.path.join(self.root, "pip", digest)

        async def create() -> str:
            # Per-process staging dir: node agents are separate processes
            # sharing one session dir, so a shared tmp path would let one
            # agent rmtree another's in-progress install.
            tmp = f"{target}.installing.{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            cmd = [
                sys.executable, "-m", "pip", "install",
                "--quiet", "--no-input", "--disable-pip-version-check",
                "--target", tmp,
            ]
            extra = global_config().runtime_env_pip_extra_args.split()
            cmd += extra + list(reqs)
            proc = await asyncio.create_subprocess_exec(
                *cmd,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.STDOUT,
            )
            try:
                out, _ = await proc.communicate()
            except asyncio.CancelledError:
                # setup() timeout cancelled us: kill pip so a retry's
                # rmtree can't race a still-running install into a
                # corrupt cached env.
                proc.kill()
                try:
                    await proc.wait()
                except Exception:  # rtlint: disable=swallowed-exception - pip already reaped after kill
                    pass
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise exceptions.RuntimeEnvSetupError(
                    f"pip install failed for {reqs}:\n"
                    + out.decode(errors="replace")[-4000:]
                )
            _publish_dir(tmp, target)
            return target

        return await self._single_flight(uri, job_id, create)

    async def _get_or_create_py_module(
        self, module_path: str, job_id: str
    ) -> CacheEntry:
        if not os.path.exists(module_path):
            raise exceptions.RuntimeEnvSetupError(
                f"py_modules entry does not exist: {module_path}"
            )
        digest = await asyncio.get_running_loop().run_in_executor(
            None, _hash_tree, module_path
        )
        uri = f"pydir://{digest}"
        target = os.path.join(self.root, "py_modules", digest)

        async def create() -> str:
            def stage() -> str:
                tmp = f"{target}.staging.{os.getpid()}"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp, exist_ok=True)
                if module_path.endswith(".zip"):
                    with zipfile.ZipFile(module_path) as zf:
                        zf.extractall(tmp)
                else:
                    # The *parent* goes on sys.path; stage the module dir
                    # under its own name (reference py_modules semantics).
                    name = os.path.basename(module_path.rstrip("/"))
                    shutil.copytree(module_path, os.path.join(tmp, name))
                _publish_dir(tmp, target)
                return target

            return await asyncio.get_running_loop().run_in_executor(None, stage)

        return await self._single_flight(uri, job_id, create)

    async def _get_or_create_zip_dir(
        self, zip_path: str, job_id: str
    ) -> CacheEntry:
        if not os.path.exists(zip_path):
            raise exceptions.RuntimeEnvSetupError(
                f"working_dir zip does not exist: {zip_path}"
            )
        digest = await asyncio.get_running_loop().run_in_executor(
            None, _hash_tree, zip_path
        )
        uri = f"workdir://{digest}"
        target = os.path.join(self.root, "working_dir", digest)

        async def create() -> str:
            def stage() -> str:
                tmp = f"{target}.staging.{os.getpid()}"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp, exist_ok=True)
                with zipfile.ZipFile(zip_path) as zf:
                    zf.extractall(tmp)
                _publish_dir(tmp, target)
                return target

            return await asyncio.get_running_loop().run_in_executor(None, stage)

        return await self._single_flight(uri, job_id, create)

    # -- GC -------------------------------------------------------------
    def _evict_over_cap(self) -> None:
        cap = global_config().runtime_env_cache_size_mb * 1024 * 1024
        unreferenced = [e for e in self._cache.values() if not e.refs]
        total = sum(e.size for e in self._cache.values())
        unreferenced.sort(key=lambda e: e.last_used)
        for entry in unreferenced:
            if total <= cap:
                break
            shutil.rmtree(entry.path, ignore_errors=True)
            self._cache.pop(entry.uri, None)
            self._locks.pop(entry.uri, None)
            total -= entry.size
            self.stats["evictions"] += 1
