"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every ``ops/csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, into an object file; the objects are linked into one
shared library with a plain C interface. The library's name carries a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
loads the library already built. Output goes to ``build/ray_tpu_torch/``
beside the package (``.gitignore`` lists ``build/``).

A failed build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ray_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# Seconds the last build took (0.0 when an existing library was loaded).
build_seconds: float | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every C entry point; each returns a cudaError_t.
_SIGNATURES = {
    # q, k, v, o, lse, bh, seq_q, seq_k, head_dim, is_bf16, causal, scale, stream
    "rt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, w, y, rows, dim, is_bf16, eps, stream
    "rt_rmsnorm": [_P, _P, _P, _I, _I, _I, _F, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and Path(path).is_file():
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def _digest(nvcc: str, sources: list[Path]) -> str:
    h = hashlib.sha256()
    h.update(" ".join([nvcc, *NVCC_FLAGS]).encode())
    for path in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build() -> Path:
    """Compiles the sources (if their hash is new) and returns the library."""
    global build_seconds
    nvcc = _nvcc()
    sources = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libray_tpu_torch_{_digest(nvcc, sources)}.so"
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path
    start = time.perf_counter()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    procs = [
        (src, _run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]))
        for src, obj in zip(sources, objects)
    ]
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = lib_path.with_suffix(f".{tag}.tmp")
        link = _run([nvcc, "-shared", *(str(o) for o in objects), "-o", str(tmp)])
        out, _ = link.communicate()
        log.append(f"== link\n{out}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib_path)
    for obj in objects:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log)
        )
    build_seconds = time.perf_counter() - start
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def contiguous_aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows in 16-byte pieces; a fresh copy is aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(name: str, device: torch.device, *args) -> None:
    """Calls C entry point ``name`` with ``args`` and the current stream of
    ``device``, and raises if it returns a CUDA error. It enters ``device``
    only when that is not the current device: this runs at every launch."""
    fn = getattr(library(), name)
    if device.index == torch.cuda.current_device():
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(status, name)


def check(status: int, what: str) -> None:
    """Raises when a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        message = library().rt_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
