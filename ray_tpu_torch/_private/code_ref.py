"""User code on its way to a runtime actor, by module and qualified name.

The runtime's own serializer (``serialization.py``) pickles a function or
class of a module outside the package by value (cloudpickle). The port's
libraries send user code by name instead, as the standard library's pickle
does, so that a gang member, a Tune trial or an env runner imports the
user's module and runs its code as the module defines it. Two things make
a name resolvable in a worker, whose ``sys.path`` is not the caller's:

* a function or class of the driver's main script is named by the
  script's module name (``python3 chip_smoke.py`` -> ``chip_smoke``), as
  serve's ``CallableRef`` names a deployment;
* each name carries the directory its module was imported from, which the
  worker appends to its path when the module is not importable there
  (a test module under ``tests/``).

``pack(value)`` wraps a value so that the runtime's serializer carries it
as stdlib pickle bytes and the worker gets the value back on unpickling:
``actor.method.remote(pack(fn), pack(args))`` hands ``fn`` and ``args``
to the method as they were.
"""

from __future__ import annotations

import importlib
import importlib.util
import io
import os
import pickle
import sys
import sysconfig
import types
from typing import Any

# Modules under these directories are importable in every worker.
_INSTALLED_ROOTS = tuple(
    os.path.realpath(p) for p in {
        sysconfig.get_paths().get("stdlib", ""),
        sysconfig.get_paths().get("purelib", ""),
        sysconfig.get_paths().get("platlib", ""),
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    } if p)


def _import_root(module, name: str) -> str:
    """The sys.path entry ``module`` (imported as ``name``) was found under,
    or "" for one without a file."""
    path = getattr(module, "__file__", None)
    if not path:
        return ""
    root = os.path.dirname(os.path.abspath(path))
    depth = name.count(".") + (os.path.basename(path).startswith("__init__.") and 1)
    for _ in range(depth):
        root = os.path.dirname(root)
    return root


def name_of(obj: Any) -> tuple[str, str, str]:
    """(module, qualified name, import root) of a module-level function or
    class; ``ValueError`` for one no worker could import by name."""
    module_name, qualname = obj.__module__, obj.__qualname__
    if "<locals>" in qualname:
        raise ValueError(f"{module_name}.{qualname}: a worker imports it by name, so it "
                         f"must be defined at the top level of an importable module")
    module = sys.modules.get(module_name)
    if module_name == "__main__":
        spec = getattr(module, "__spec__", None)
        path = getattr(module, "__file__", None)
        if spec is not None and spec.name:
            module_name = spec.name
        elif path:
            module_name = os.path.splitext(os.path.basename(path))[0]
        else:
            raise ValueError(f"{qualname}: defined in an interactive session, so no "
                             f"worker can import it by name")
    return module_name, qualname, _import_root(module, module_name)


def lookup(module: str, qualname: str, root: str = "") -> Any:
    """The object ``module.qualname``, importing ``module`` (from ``root``
    when it is not importable otherwise)."""
    if root and root not in sys.path:
        try:
            found = importlib.util.find_spec(module) is not None
        except (ImportError, ValueError):
            found = False
        if not found:
            sys.path.append(root)
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _needs_root(obj: Any) -> bool:
    """Whether ``obj``'s module may be missing from a worker's path."""
    module_name = getattr(obj, "__module__", None)
    if not module_name:
        return False
    if module_name == "__main__":
        return True
    path = getattr(sys.modules.get(module_name), "__file__", None)
    if not path:
        return False
    real = os.path.realpath(path)
    return not any(real.startswith(root + os.sep) for root in _INSTALLED_ROOTS)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, (types.FunctionType, type)) and _needs_root(obj):
            return lookup, name_of(obj)
        return NotImplemented


def dumps(value: Any) -> bytes:
    """``value`` as stdlib pickle bytes, its user functions and classes by
    name (``name_of``)."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(value)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    return pickle.loads(data)


class Packed:
    """A value that the runtime's serializer carries as ``dumps`` bytes and
    that unpickles as the value itself."""

    def __init__(self, value: Any):
        self.data = dumps(value)

    def __reduce__(self):
        return loads, (self.data,)


def pack(value: Any) -> Packed:
    return Packed(value)
