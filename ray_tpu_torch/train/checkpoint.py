"""Checkpoints: a directory of files, sharded tree I/O and the commit
protocol, in the JAX package's on-disk format.

Copies, for torch tensors, ray_tpu's ``train/checkpoint.py`` (``Checkpoint``,
``save_pytree``, ``verify_sharded_checkpoint``, ``load_pytree``), the commit
protocol of its ``train/_internal/storage.py`` (``StorageContext``) and the
atomic writes of ``_private/atomic_io.py``. A checkpoint written by either
package loads in the other:

    manifest.json                      global shapes and dtypes, mesh, world_size
    shards/p<rank>/<key>.s<k>.npy      one file per shard this rank owns
    shards/p<rank>/<key>.s<k>.idx.json the shard's global index ([start, stop] a dim)
    shards/p<rank>/<key>.scalar.pkl    a leaf that is no tensor (rank 0)
    DONE.p<rank>                       this rank's inventory (size, CRC32), last
    extra.pkl                          save_pytree_checkpoint's ``extra``
    ingest.json                        the ranks' dataset positions (StorageContext)
    COMMIT.json                        StorageContext.persist's stamp

Leaf keys are the JAX package's (``_leaf_key``): dict keys, sequence
indices and attribute names joined by ".", with "%", ".", "/", "\\" and
NUL escaped; dicts flatten in sorted key order, as JAX flattens them. A
``DTensor`` leaf writes the shards its rank owns (replica 0 of each) with
their global index; a plain tensor is written whole by rank 0. bf16 has no
numpy dtype: its bits are written as numpy's raw 2-byte items (``'<V2'``),
exactly what ``np.save`` writes for the JAX package's ``ml_dtypes``
arrays, and read back by the same views.

The one file the port cannot write is the JAX package's ``treedef.pkl`` (a
pickled JAX ``PyTreeDef``), which its ``load_pytree`` needs. The port never
opens it: it rebuilds a tree by placing each manifest key into a template
tree, or from ``tree.json``, the structure it writes beside the manifest.
A JAX reader of a port checkpoint needs ``treedef.pkl`` supplied from a JAX
tree of the same structure, and nothing else.

The two torn-save windows carry the reference's chaos fail points:
``train.checkpoint.mid_save`` (shards written, no DONE marker) and
``train.storage.pre_commit`` (staged and verified, no COMMIT stamp).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import pickle
import re
import shutil
import tempfile
import time
import uuid
import zlib
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ray_tpu_torch._private import chaos

logger = logging.getLogger(__name__)

_MANIFEST = "manifest.json"
_TREE = "tree.json"
_COMMIT = "COMMIT.json"
_DONE_PREFIX = "DONE.p"


class Checkpoint:
    """A directory of files; the framework never interprets the contents
    except through the tree helpers below."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: str | None = None) -> str:
        if path is None or os.path.abspath(path) == self.path:
            return self.path
        os.makedirs(path, exist_ok=True)
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Checkpoint) and other.path == self.path

    def __hash__(self) -> int:
        return hash(self.path)


# ---------------------------------------------------------------------------
# Atomic small-file writes (tmp + os.replace: a reader sees the old file or
# the new one, never a torn one)
# ---------------------------------------------------------------------------


def _atomic_write_bytes(path: str, data: bytes, *, fsync: bool = False) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _atomic_write_json(path: str, obj: Any, *, fsync: bool = False) -> None:
    _atomic_write_bytes(path, json.dumps(obj).encode(), fsync=fsync)


def _atomic_write_pickle(path: str, obj: Any) -> None:
    _atomic_write_bytes(path, pickle.dumps(obj))


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


class _CrcWriter:
    """A binary file that keeps the CRC32 and size of what is written, so a
    shard's inventory entry needs no second read of the file."""

    def __init__(self, f):
        self._f, self.crc, self.size = f, 0, 0

    def write(self, data) -> int:
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(memoryview(data).cast("B"))
        return self._f.write(data)


# ---------------------------------------------------------------------------
# Leaf keys and tree structure
# ---------------------------------------------------------------------------

# "." joins key parts, "/" and NUL would break shard paths, "%" escapes the
# escape; the mapping is injective.
_KEY_ESCAPES = {"%": "%25", ".": "%2E", "/": "%2F", "\\": "%5C", "\x00": "%00"}


def _escape_key_part(part: str) -> str:
    if not any(ch in part for ch in _KEY_ESCAPES):
        return part
    return "".join(_KEY_ESCAPES.get(ch, ch) for ch in part)


def _leaf_key(path_parts: tuple) -> str:
    """The JAX package's key of a leaf: dict keys and attribute names
    escaped, sequence indices as numbers, joined by "."."""
    out = [str(p) if isinstance(p, int) else _escape_key_part(str(p)) for p in path_parts]
    return ".".join(out) or "leaf"


def _flatten(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) in JAX's order: dicts by sorted key, sequences by index;
    None is an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, path + (i,))
    elif tree is not None:
        yield path, tree


def _structure(tree: Any) -> Any:
    """tree.json's form of a tree: {"dict": {...}}, {"list": [...]},
    {"tuple": [...]}, {"none": null} or null for a leaf."""
    if isinstance(tree, dict):
        return {"dict": {str(k): _structure(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list" if isinstance(tree, list) else "tuple": [_structure(v) for v in tree]}
    if tree is None:
        return {"none": None}
    return None


def _rebuild(structure: Any) -> Any:
    """A template tree (each leaf 0) from tree.json's form."""
    if structure is None:
        return 0
    (kind, body), = structure.items()
    if kind == "dict":
        return {k: _rebuild(v) for k, v in body.items()}
    if kind == "none":
        return None
    items = [_rebuild(v) for v in body]
    return items if kind == "list" else tuple(items)


def _map_paths(fn, tree: Any, path: tuple = ()) -> Any:
    """fn(path, leaf) over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

# torch dtype <-> the manifest's dtype name (numpy's, and ml_dtypes' for bf16).
_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


def _write_npy(f, t: torch.Tensor) -> None:
    """A CPU tensor as the .npy file the JAX package's ``np.save`` writes:
    the same header, and bf16 as raw 2-byte items described '<V2', as
    ``ml_dtypes.bfloat16`` describes itself."""
    t = t.contiguous()
    array = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    header = np.lib.format.header_data_from_array_1_0(array)
    if t.dtype == torch.bfloat16:
        header["descr"] = "<V2"
    np.lib.format.write_array_header_1_0(f, header)
    if array.size:
        f.write(memoryview(array.reshape(-1)).cast("B"))


def _from_numpy(array: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of _write_npy's array. A bf16 leaf comes as raw 2-byte items
    (``'V2'``) or, from an ``ml_dtypes`` reader, as ``bfloat16``."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(array).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(array))


def _owned_shards(leaf: torch.Tensor) -> list[tuple[torch.Tensor, list[list[int]]]]:
    """The shards of ``leaf`` this rank writes, each with its global index:
    a DTensor's local shard when this rank holds replica 0 of it (the first
    coordinate along every mesh dim the leaf is not split over), with the
    offsets ``train.torch_utils`` cuts it at (a dim split by several mesh
    dims, major first); a plain tensor whole."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return [(leaf, [[0, n] for n in leaf.shape])]
    mesh, coords = leaf.device_mesh, leaf.device_mesh.get_coordinate()
    start, length = [0] * leaf.dim(), list(leaf.shape)
    for i, placement in enumerate(leaf.placements):
        if placement.is_shard():
            d = placement.dim
            length[d] //= mesh.size(i)
            start[d] += coords[i] * length[d]
        elif coords[i] != 0:
            return []  # another rank holds replica 0
    return [(leaf.to_local(), [[s, s + n] for s, n in zip(start, length)])]


def _done_marker_path(directory: str, process_index: int) -> str:
    return os.path.join(directory, f"{_DONE_PREFIX}{process_index}")


def save_pytree(
    directory: str,
    tree: Any,
    *,
    process_index: int = 0,
    world_size: int = 1,
    mesh_metadata: dict | None = None,
) -> None:
    """Writes this process's shards of a tree of tensors (DTensors or plain
    ones) under ``directory``, two-phase: every shard file, then (rank 0)
    the manifest and tree.json, then this rank's ``DONE.p<rank>``
    inventory, atomically and last. Every process calls this with the same
    tree; the union of the shard files covers every leaf once. A reader
    treats a shard dir without a verifying DONE marker as torn. Inside a
    train session the save's wall time is the step's "checkpoint" phase."""
    from ray_tpu_torch.train import step_stats

    start = time.perf_counter()
    leaves = list(_flatten(tree))
    seen: dict[str, tuple] = {}
    for path, _ in leaves:
        key = _leaf_key(path)
        if key in seen and seen[key] != path:
            raise ValueError(f"leaf key collision: tree paths {seen[key]!r} and {path!r} "
                             f"both map to shard key {key!r}")
        seen[key] = path

    shard_dir = os.path.join(directory, "shards", f"p{process_index}")
    os.makedirs(shard_dir, exist_ok=True)
    inventory: dict[str, dict] = {}

    def track(path: str, size: int | None = None, crc: int | None = None) -> None:
        inventory[os.path.relpath(path, directory)] = {
            "size": os.path.getsize(path) if size is None else size,
            "crc32": _file_crc32(path) if crc is None else crc,
        }

    manifest: dict[str, Any] = {"leaves": {}, "mesh": mesh_metadata or {},
                                "world_size": int(world_size)}
    for path, leaf in leaves:
        key = _leaf_key(path)
        if not isinstance(leaf, torch.Tensor):
            manifest["leaves"][key] = {"scalar": True}
            if process_index == 0:
                pkl_path = os.path.join(shard_dir, f"{key}.scalar.pkl")
                _atomic_write_pickle(pkl_path, leaf)
                track(pkl_path)
            continue
        if leaf.dtype not in _DTYPE_NAMES:
            raise TypeError(f"leaf {key}: no checkpoint dtype for {leaf.dtype}")
        manifest["leaves"][key] = {"shape": list(leaf.shape), "dtype": _DTYPE_NAMES[leaf.dtype]}
        shards = _owned_shards(leaf)
        from torch.distributed.tensor import DTensor

        if not isinstance(leaf, DTensor) and process_index != 0:
            shards = []  # a plain tensor is the same on every rank: rank 0 writes it
        for k, (data, index) in enumerate(shards):
            npy_path = os.path.join(shard_dir, f"{key}.s{k}.npy")
            tmp = f"{npy_path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                writer = _CrcWriter(f)
                _write_npy(writer, data.detach().cpu())
            os.replace(tmp, npy_path)
            track(npy_path, writer.size, writer.crc)
            idx_path = os.path.join(shard_dir, f"{key}.s{k}.idx.json")
            _atomic_write_json(idx_path, index)
            track(idx_path)

    if process_index == 0:
        _atomic_write_json(os.path.join(directory, _TREE), _structure(tree))
        track(os.path.join(directory, _TREE))
        # Not inventoried: a merge rewrites its world_size to the writers
        # present; its own atomic write and the COMMIT stamp protect it.
        _atomic_write_json(os.path.join(directory, _MANIFEST), manifest)
    # The torn-save window: everything above is on disk, the commit marker
    # is not. A kill here leaves a directory verify_sharded_checkpoint
    # rejects and latest_checkpoint() skips.
    chaos.failpoint("train.checkpoint.mid_save")
    _atomic_write_json(_done_marker_path(directory, process_index),
                       {"rank": int(process_index), "files": inventory})
    step_stats.record_phase("checkpoint", time.perf_counter() - start)


def _done_markers(directory: str) -> dict[int, dict]:
    """rank -> parsed DONE marker, for every marker present."""
    markers: dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return markers
    for name in names:
        suffix = name[len(_DONE_PREFIX):]
        if not name.startswith(_DONE_PREFIX) or not suffix.isdigit():
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                markers[int(suffix)] = json.load(f)
        except (OSError, ValueError):
            continue
    return markers


def verify_sharded_checkpoint(directory: str) -> tuple[bool, str]:
    """Is this directory a complete sharded save? No manifest: an opaque
    user directory, OK. Otherwise every ``shards/p<r>`` needs its DONE.p<r>,
    the markers must cover the manifest's world size, and every
    inventoried file must exist with its size and CRC. (The JAX package's
    reader also requires its treedef.pkl, which the port neither writes
    nor reads.) Returns (ok, the first failure found)."""
    manifest_path = os.path.join(directory, _MANIFEST)
    if not os.path.exists(manifest_path):
        return True, "opaque (no manifest)"
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        return False, f"unreadable manifest: {exc}"
    markers = _done_markers(directory)
    shards_root = os.path.join(directory, "shards")
    shard_ranks = set()
    if os.path.isdir(shards_root):
        shard_ranks = {int(n[1:]) for n in os.listdir(shards_root)
                       if n.startswith("p") and n[1:].isdigit()}
    for rank in sorted(shard_ranks):
        if rank not in markers:
            return False, f"shards/p{rank} present but DONE.p{rank} missing"
    world_size = int(manifest.get("world_size", 1) or 1)
    for rank in range(world_size):
        if rank not in markers:
            return False, f"manifest world_size={world_size} but DONE.p{rank} missing"
    for rank, marker in sorted(markers.items()):
        for rel, meta in (marker.get("files") or {}).items():
            path = os.path.join(directory, rel)
            if not os.path.exists(path):
                return False, f"inventoried file missing: {rel} (rank {rank})"
            size = os.path.getsize(path)
            if size != int(meta.get("size", -1)):
                return False, f"size mismatch for {rel}: {size} != {meta.get('size')}"
            if "crc32" in meta and _file_crc32(path) != int(meta["crc32"]):
                return False, f"crc mismatch for {rel}"
    return True, "ok"


def is_committed(directory: str) -> bool:
    """True when the directory carries a parseable COMMIT.json stamp."""
    try:
        with open(os.path.join(directory, _COMMIT)) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def _read_leaf(directory: str, proc_dirs: list[str], key: str, meta: dict) -> Any:
    """One leaf, assembled from every rank's shards of it."""
    shards_root = os.path.join(directory, "shards")
    if meta.get("scalar"):
        for pd in proc_dirs:
            p = os.path.join(shards_root, pd, f"{key}.scalar.pkl")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    return pickle.load(f)
        return None
    dtype = _DTYPES[meta["dtype"]]
    out = torch.empty(meta["shape"], dtype=dtype)
    filled = torch.zeros(meta["shape"], dtype=torch.bool) if meta["shape"] else None
    # Exact-key match: a prefix test would feed leaf "w.step"'s shards to "w".
    shard_re = re.compile(re.escape(key) + r"\.s\d+\.npy$")
    for pd in proc_dirs:
        pdir = os.path.join(shards_root, pd)
        for fname in os.listdir(pdir):
            if not shard_re.fullmatch(fname):
                continue
            data = _from_numpy(np.load(os.path.join(pdir, fname)), dtype)
            with open(os.path.join(pdir, fname[:-4] + ".idx.json")) as f:
                index = json.load(f)
            slices = tuple(slice(a, b) for a, b in index)
            out[slices] = data
            if filled is not None:
                filled[slices] = True
    if filled is not None and not filled.all():
        raise IOError(f"checkpoint {directory}: leaf {key} has missing shards "
                      f"({int((~filled).sum())} elements uncovered)")
    return out


def load_pytree(directory: str, template: Any = None) -> Any:
    """The saved tree as CPU tensors (scalar leaves as saved). ``template``
    (a tree of any leaves) gives the structure, and each of its leaves is
    replaced by the saved leaf under its key, so a checkpoint the JAX
    package wrote loads without its treedef.pkl; without one, the
    structure comes from the port's tree.json. Verifies the per-rank
    inventory before reading anything, so a torn save fails fast. Placing
    the leaves on a mesh is ``train.torch_utils.restore_sharded_state``'s
    work."""
    ok, reason = verify_sharded_checkpoint(directory)
    if not ok:
        raise IOError(f"checkpoint {directory} failed inventory verification: {reason}")
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    if template is None:
        tree_path = os.path.join(directory, _TREE)
        if not os.path.exists(tree_path):
            raise IOError(f"checkpoint {directory} has no {_TREE}: pass a template tree")
        with open(tree_path) as f:
            template = _rebuild(json.load(f))
    shards_root = os.path.join(directory, "shards")
    proc_dirs = sorted(os.listdir(shards_root)) if os.path.isdir(shards_root) else []
    leaves = manifest["leaves"]

    def read(path, _):
        key = _leaf_key(path)
        if key not in leaves:
            raise KeyError(f"checkpoint {directory} has no leaf {key!r}")
        return _read_leaf(directory, proc_dirs, key, leaves[key])

    return _map_paths(read, template)


def save_pytree_checkpoint(tree: Any, *, extra: dict | None = None) -> Checkpoint:
    """A fresh Checkpoint directory holding ``tree`` (and pickled
    ``extra``). Inside a train session it is stamped with the writer's rank
    and world size, so multi-rank saves carry per-rank commit markers, and
    lands under the trial directory, from which the trainer's commit moves
    it instead of copying it; elsewhere under the temporary directory."""
    from ray_tpu_torch.train import session

    process_index, world_size = 0, 1
    root = tempfile.gettempdir()
    if session.in_session():
        ctx = session.get_context()
        process_index, world_size = ctx.world_rank, ctx.world_size
        root = ctx.trial_dir or root
    path = os.path.join(root, f"ray_tpu_ckpt_{uuid.uuid4().hex[:8]}")
    os.makedirs(path, exist_ok=True)
    save_pytree(path, tree, process_index=process_index, world_size=world_size)
    if extra is not None:
        _atomic_write_pickle(os.path.join(path, "extra.pkl"), extra)
    return Checkpoint(path)


def load_pytree_checkpoint(checkpoint: Checkpoint, template: Any = None) -> tuple[Any, dict]:
    with checkpoint.as_directory() as path:
        tree = load_pytree(path, template)
        extra_path = os.path.join(path, "extra.pkl")
        extra = {}
        if os.path.exists(extra_path):
            with open(extra_path, "rb") as f:
                extra = pickle.load(f)
    return tree, extra


# ---------------------------------------------------------------------------
# The commit protocol and retention (ray_tpu/train/_internal/storage.py)
# ---------------------------------------------------------------------------

_CKPT_RE = re.compile(r"^checkpoint_(\d{6})$")
_STAGING_SUFFIX = ".staging"
# The per-rank dataset-iterator states stamped into a committed checkpoint,
# {"world_size": W, "datasets": {name: [state per rank]}}, from which a
# restart at any world size resumes ingest exactly.
INGEST_FILE = "ingest.json"


class StorageContext:
    """Persists reported checkpoint directories as
    ``<storage_path>/<experiment>/<trial>/checkpoint_NNNNNN``, committed
    two-phase, and keeps CheckpointConfig's retention.

    ``persist`` stages the reported directory at ``checkpoint_NNNNNN.staging``
    (moved when it lies on the same filesystem, else copied), verifies the
    per-rank inventory, stamps ``COMMIT.json`` and only then renames it to
    its final name: ``checkpoint_NNNNNN`` exists committed or not at all.
    At start the tracker reconciles with disk: committed directories it
    missed are adopted, uncommitted or unverifiable ones removed, so
    ``latest_checkpoint`` only ever returns a committed checkpoint. Local
    paths only."""

    def __init__(self, storage_path: str, experiment_name: str, trial_name: str = "",
                 checkpoint_config=None):
        from ray_tpu_torch.train.config import CheckpointConfig

        self.experiment_dir = os.path.join(os.path.expanduser(storage_path), experiment_name)
        self.trial_dir = (os.path.join(self.experiment_dir, trial_name) if trial_name
                          else self.experiment_dir)
        os.makedirs(self.trial_dir, exist_ok=True)
        self.checkpoint_config = checkpoint_config or CheckpointConfig()
        self._index = 0
        self._kept: list[tuple[str, dict]] = []  # (path, metrics)
        self._load_state()

    @property
    def _state_path(self) -> str:
        return os.path.join(self.trial_dir, ".storage_state.json")

    def _load_state(self) -> None:
        if os.path.exists(self._state_path):
            try:
                with open(self._state_path) as f:
                    state = json.load(f)
            except (OSError, ValueError) as exc:
                logger.warning("unreadable %s (%s); rebuilding from disk", self._state_path, exc)
                state = {"index": 0, "kept": []}
            self._index = state.get("index", 0)
            self._kept = [(p, m) for p, m in state.get("kept", [])
                          if os.path.isdir(p) and is_committed(p)]
        self._reconcile_disk()

    def _save_state(self) -> None:
        _atomic_write_json(self._state_path, {"index": self._index, "kept": self._kept})

    def _reconcile_disk(self) -> None:
        """Adopts committed checkpoints the tracker missed and removes torn
        ones: a staging leftover, an uncommitted or unverifiable directory."""
        known = {p for p, _ in self._kept}
        try:
            names = sorted(os.listdir(self.trial_dir))
        except OSError:
            return
        changed = False
        for name in names:
            path = os.path.join(self.trial_dir, name)
            if name.endswith(_STAGING_SUFFIX) and os.path.isdir(path):
                logger.warning("removing abandoned staging dir %s", path)
                shutil.rmtree(path, ignore_errors=True)
                continue
            m = _CKPT_RE.match(name)
            if not m or not os.path.isdir(path) or path in known:
                continue
            if not is_committed(path):
                logger.warning("removing uncommitted checkpoint dir %s", path)
                shutil.rmtree(path, ignore_errors=True)
                continue
            ok, reason = verify_sharded_checkpoint(path)
            if not ok:
                logger.warning("removing committed but unverifiable checkpoint %s: %s",
                               path, reason)
                shutil.rmtree(path, ignore_errors=True)
                continue
            try:
                with open(os.path.join(path, _COMMIT)) as f:
                    commit = json.load(f)
            except (OSError, ValueError):
                commit = {}
            self._kept.append((path, commit.get("metrics", {})))
            changed = True
        if changed:
            self._kept.sort(key=lambda pm: pm[0])
            self._index = max(self._index, max(
                int(_CKPT_RE.match(os.path.basename(p)).group(1)) + 1 for p, _ in self._kept))
            self._save_state()

    def persist(self, checkpoint: Checkpoint, metrics: dict,
                ingest: dict | None = None) -> Checkpoint:
        """Two-phase commit of a reported checkpoint directory: stage,
        write ``ingest`` (the ranks' dataset positions) as ingest.json,
        verify the inventory, stamp COMMIT.json, rename. Raises IOError for
        a torn save; the caller skips the round and keeps the previous
        committed checkpoint."""
        dest = os.path.join(self.trial_dir, f"checkpoint_{self._index:06d}")
        clean_metrics = {k: v for k, v in metrics.items()
                         if isinstance(v, (int, float, str, bool))}
        stamp = {"index": self._index, "ts": time.time(), "metrics": clean_metrics}
        if os.path.abspath(checkpoint.path) != dest:
            staging = dest + _STAGING_SUFFIX
            for stale in (staging, dest):
                if os.path.isdir(stale):
                    shutil.rmtree(stale)
            shutil.move(checkpoint.path, staging)
            if ingest is not None:
                _atomic_write_json(os.path.join(staging, INGEST_FILE), ingest)
            ok, reason = verify_sharded_checkpoint(staging)
            if not ok:
                shutil.rmtree(staging, ignore_errors=True)
                raise IOError(f"refusing to commit torn checkpoint {checkpoint.path}: {reason}")
            # The kill window: staged and verified, no COMMIT.json or final
            # name yet. The next StorageContext's reconcile removes it.
            chaos.failpoint("train.storage.pre_commit")
            _atomic_write_json(os.path.join(staging, _COMMIT), stamp, fsync=True)
            os.replace(staging, dest)
        else:
            if ingest is not None:
                _atomic_write_json(os.path.join(dest, INGEST_FILE), ingest)
            if not is_committed(dest):
                _atomic_write_json(os.path.join(dest, _COMMIT), stamp, fsync=True)
        self._index += 1
        self._kept.append((dest, clean_metrics))
        self._enforce_retention()
        self._save_state()
        return Checkpoint(dest)

    def _enforce_retention(self) -> None:
        keep = self.checkpoint_config.num_to_keep
        if keep is None or len(self._kept) <= keep:
            return
        drop, self._kept = self._kept[:-keep], self._kept[-keep:]
        for path, _ in drop:
            shutil.rmtree(path, ignore_errors=True)

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        """The newest committed, verifying checkpoint; one that lost its
        stamp or inventory since it was tracked is dropped, so recovery
        falls back to the previous one."""
        while self._kept:
            path, _ = self._kept[-1]
            if os.path.isdir(path) and is_committed(path):
                ok, reason = verify_sharded_checkpoint(path)
                if ok:
                    return Checkpoint(path)
                logger.warning("dropping unverifiable checkpoint %s: %s", path, reason)
            else:
                logger.warning("dropping uncommitted checkpoint %s", path)
            self._kept.pop()
            shutil.rmtree(path, ignore_errors=True)
            self._save_state()
        return None

    def latest_ingest(self) -> Optional[dict]:
        """The ranks' dataset-iterator states stamped into the newest
        committed checkpoint, or None when it carries none."""
        ckpt = self.latest_checkpoint()
        if ckpt is None:
            return None
        try:
            with open(os.path.join(ckpt.path, INGEST_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def checkpoints(self) -> list[tuple[Checkpoint, dict]]:
        return [(Checkpoint(p), m) for p, m in self._kept]


def merge_sharded_checkpoints(reported: list[Optional[Checkpoint]]) -> Optional[Checkpoint]:
    """Rank 0's reported directory is canonical; the other ranks' ``shards/p*``
    directories and DONE markers are moved into it, and the manifest's
    world_size becomes the number of markers present: a save only rank 0
    reported verifies as one writer's, and a sharded save that lost a
    writer's marker fails verification at commit (ray_tpu's
    ``BackendExecutor.merge_sharded_checkpoints``)."""
    base = reported[0]
    if base is None:
        return None
    for ckpt in reported[1:]:
        if ckpt is None or ckpt.path == base.path:
            continue
        src_shards = os.path.join(ckpt.path, "shards")
        if os.path.isdir(src_shards):
            for proc_dir in os.listdir(src_shards):
                dst = os.path.join(base.path, "shards", proc_dir)
                if not os.path.isdir(dst):
                    shutil.move(os.path.join(src_shards, proc_dir), dst)
        for name in os.listdir(ckpt.path):
            if name.startswith(_DONE_PREFIX):
                dst = os.path.join(base.path, name)
                if not os.path.exists(dst):
                    shutil.move(os.path.join(ckpt.path, name), dst)
        shutil.rmtree(ckpt.path, ignore_errors=True)
    manifest_path = os.path.join(base.path, _MANIFEST)
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            manifest = None
        if manifest is not None:
            manifest["world_size"] = max(1, len(_done_markers(base.path)))
            _atomic_write_json(manifest_path, manifest)
    return base
