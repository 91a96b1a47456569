"""Serialization for task args/returns and ray_tpu_torch.put values.

Role-equivalent of the reference's SerializationContext
(python/ray/_private/serialization.py): cloudpickle for code/closures,
pickle protocol 5 with out-of-band buffers so large numpy arrays and CPU
``torch.Tensor``s are written as raw bytes (and reconstructed zero-copy as
views onto the shared-memory arena on the read side).

Tensors take the place of the reference's jax arrays:

* A CPU tensor goes out of band as its numpy view (bf16, which numpy lacks,
  as its 2-byte integer view) and comes back as a tensor over the arena's
  read-only buffer, with no copy. torch has no read-only tensors: writing
  into one writes the shared object, which the reference's contract
  forbids as it does for numpy.
* A CUDA tensor crosses as host bytes (one device-to-host copy on the
  writer) and is rebuilt on the reader's current CUDA device. A process
  with no card raises on it, as unpickling a jax array does without its
  backend.

This module imports no torch: a value holds a tensor only where its
process already imported torch.

Wire layout of a serialized value:
    [u32 nbufs][u64 len_meta][meta pickle][u64 len_buf0][buf0]...
ObjectRefs inside values are replaced at pickle time by _RefPlaceholder and
collected, so the runtime can (a) register borrows with owners and (b)
resolve them back to live ObjectRefs on the consumer side.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import sys
import sysconfig
import types
from typing import Any, Callable

import cloudpickle

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# Directories whose modules are importable on every worker (stdlib +
# site-packages + this framework). Functions/classes from any OTHER module
# (user scripts, pytest files) are registered for pickle-by-value — workers
# must not need the driver's sys.path to unpickle user code. The reference
# only gets this for __main__; we extend it to all non-installed modules.
_INSTALLED_ROOTS = tuple(
    os.path.realpath(p)
    for p in {
        sysconfig.get_paths().get("stdlib", ""),
        sysconfig.get_paths().get("purelib", ""),
        sysconfig.get_paths().get("platlib", ""),
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    }
    if p
)
_byvalue_checked: set[str] = set()


def _maybe_register_by_value(obj: Any) -> None:
    mod_name = getattr(obj, "__module__", None)
    if not mod_name or mod_name in _byvalue_checked:
        return
    _byvalue_checked.add(mod_name)
    if mod_name == "__main__" or mod_name.partition(".")[0] in sys.builtin_module_names:
        return
    module = sys.modules.get(mod_name)
    mod_file = getattr(module, "__file__", None)
    if module is None or not mod_file:
        return
    real = os.path.realpath(mod_file)
    if any(real.startswith(root + os.sep) for root in _INSTALLED_ROOTS):
        return
    try:
        cloudpickle.register_pickle_by_value(module)
    except Exception:  # rtlint: disable=swallowed-exception - module rejects by-value: fall back to by-reference
        pass


class _RefPlaceholder:
    __slots__ = ("object_id", "owner_address")

    def __init__(self, object_id: str, owner_address: tuple | None):
        self.object_id = object_id
        self.owner_address = owner_address

    def __reduce__(self):
        return (_RefPlaceholder, (self.object_id, self.owner_address))


# numpy has no bfloat16 or float8: such tensors cross as the integer view
# of their element size.
_INT_VIEW = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _reduce_tensor(tensor):
    if str(tensor.layout) != "torch.strided" or tensor.is_quantized:
        return None
    device = tensor.device.type
    if device not in ("cpu", "cuda"):
        return None
    host = tensor.detach()
    host = host.cpu() if device == "cuda" else host.contiguous()
    dtype = None
    try:
        array = host.numpy()
    except TypeError:
        import torch

        dtype = str(tensor.dtype).split(".")[-1]
        array = host.view(getattr(torch, _INT_VIEW[host.element_size()])).numpy()
    rebuild = _rebuild_cuda_tensor if device == "cuda" else _rebuild_cpu_tensor
    return rebuild, (array, dtype, tensor.requires_grad)


def _rebuild_cpu_tensor(array, dtype, requires_grad):
    import warnings

    import torch

    with warnings.catch_warnings():
        # A view of the arena's read-only buffer, shared on purpose.
        warnings.simplefilter("ignore", UserWarning)
        tensor = torch.from_numpy(array)
    if dtype is not None:
        tensor = tensor.view(getattr(torch, dtype))
    return tensor.requires_grad_(requires_grad) if requires_grad else tensor


def _rebuild_cuda_tensor(array, dtype, requires_grad):
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA tensor was sent to a process that has no CUDA device "
            "(a task or actor without num_gpus sees no card)")
    host = _rebuild_cpu_tensor(array, dtype, False)
    tensor = host.to(torch.device("cuda", torch.cuda.current_device()))
    return tensor.requires_grad_(requires_grad) if requires_grad else tensor


class _Pickler(cloudpickle.CloudPickler):
    def __init__(self, file, collected_refs: list, protocol: int = 5, **kw):
        super().__init__(file, protocol=protocol, **kw)
        self._collected_refs = collected_refs

    def reducer_override(self, obj: Any):
        # Exactly torch.Tensor (a Parameter pickles its data through here).
        cls = type(obj)
        if cls.__name__ == "Tensor" and cls.__module__ == "torch":
            reduced = _reduce_tensor(obj)
            if reduced is not None:
                return reduced
        return super().reducer_override(obj)

    def persistent_id(self, obj: Any):
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            self._collected_refs.append(obj)
            return ("raytpu_ref", obj.id, obj.owner_address)
        if isinstance(obj, (types.FunctionType, type)):
            _maybe_register_by_value(obj)
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, ref_resolver, buffers=None):
        super().__init__(file, buffers=buffers)
        self._ref_resolver = ref_resolver

    def persistent_load(self, pid):
        tag, object_id, owner_address = pid
        if tag != "raytpu_ref":
            raise pickle.UnpicklingError(f"unknown persistent id {tag!r}")
        if self._ref_resolver is None:
            raise pickle.UnpicklingError("ObjectRef found but no resolver given")
        return self._ref_resolver(object_id, owner_address)


# Fast lane for plain-data values (the typical task args/returns on the
# hot path): the stock C pickler is ~10x cheaper than instantiating a
# CloudPickler per call, and such values can contain no ObjectRefs,
# functions, or out-of-band buffers by construction. The high bit of the
# nbufs header marks these payloads so deserialize can use the stock C
# unpickler (persistent ids are impossible in them).
_PLAIN_FLAG = 0x80000000
_PLAIN_SCALARS = frozenset((type(None), bool, int, float, str, bytes))


def _is_plain(value: Any, depth: int = 4) -> bool:
    t = type(value)
    if t in _PLAIN_SCALARS:
        return True
    if depth <= 0:
        return False
    if t is tuple or t is list:
        return len(value) <= 16 and all(
            _is_plain(item, depth - 1) for item in value
        )
    if t is dict:
        return len(value) <= 16 and all(
            type(k) is str and _is_plain(v, depth - 1)
            for k, v in value.items()
        )
    return False


def serialize_parts(value: Any) -> tuple[list, int, list]:
    """Serialize without joining: returns (parts, total_nbytes,
    contained_object_refs) where parts is a list of bytes/memoryview in wire
    order. The put path streams parts straight into its shared-memory
    allocation — one copy total, instead of join-then-copy (the join of an
    8 MiB array costs as much as the final memcpy itself)."""
    if _is_plain(value):
        meta = pickle.dumps(value, protocol=5)
        return (
            [_U32.pack(_PLAIN_FLAG), _U64.pack(len(meta)), meta],
            12 + len(meta),
            [],
        )
    buffers: list[pickle.PickleBuffer] = []
    refs: list = []
    meta_io = io.BytesIO()
    pickler = _Pickler(meta_io, refs, protocol=5, buffer_callback=buffers.append)
    pickler.dump(value)
    meta = meta_io.getbuffer()

    parts: list = [_U32.pack(len(buffers)), _U64.pack(meta.nbytes), meta]
    total = 12 + meta.nbytes
    for buffer in buffers:
        raw = buffer.raw()
        parts.append(_U64.pack(raw.nbytes))
        parts.append(raw)
        total += 8 + raw.nbytes
    return parts, total, refs


def join_parts(parts) -> bytes:
    """Wire-order parts -> one contiguous payload."""
    return b"".join(
        bytes(p) if isinstance(p, memoryview) else p for p in parts
    )


def serialize(value: Any) -> tuple[bytes, list]:
    """Returns (payload, contained_object_refs)."""
    parts, _total, refs = serialize_parts(value)
    return join_parts(parts), refs


def serialized_size(payload: bytes) -> int:
    return len(payload)


def deserialize(
    payload: bytes | memoryview,
    ref_resolver: Callable[[str, Any], Any] | None = None,
    zero_copy: bool = True,
) -> Any:
    view = memoryview(payload)
    (nbufs,) = _U32.unpack_from(view, 0)
    (meta_len,) = _U64.unpack_from(view, 4)
    pos = 12
    meta = view[pos : pos + meta_len]
    pos += meta_len
    if nbufs & _PLAIN_FLAG:
        # Plain-data payload: stock C unpickler, nothing persistent inside.
        return pickle.loads(meta)
    buffers = []
    for _ in range(nbufs):
        (blen,) = _U64.unpack_from(view, pos)
        pos += 8
        buf = view[pos : pos + blen]
        # zero_copy=False makes an owning copy (needed if the arena slice is
        # released after get, e.g. values that outlive the store mapping).
        buffers.append(buf if zero_copy else bytes(buf))
        pos += blen
    unpickler = _Unpickler(io.BytesIO(bytes(meta)), ref_resolver, buffers)
    return unpickler.load()


def dumps_function(fn: Any) -> bytes:
    # Run through _Pickler (not bare cloudpickle.dumps) so persistent_id
    # fires for every NESTED function/class too — a task fn calling a helper
    # from a sibling user module must ship that module by value as well.
    out = io.BytesIO()
    _Pickler(out, [], protocol=5).dump(fn)
    return out.getvalue()


def loads_function(raw: bytes, ref_resolver: Callable | None = None) -> Any:
    return _Unpickler(io.BytesIO(raw), ref_resolver).load()


# Precomputed payloads for the two dominant hot-path values: a no-arg
# call's ((), {}) and a None return. Serializing them is pure fixed cost
# (~8us of pickler setup per task on the microbenchmark's noop loop).
EMPTY_ARGS_PAYLOAD: bytes = serialize(((), {}))[0]
NONE_PAYLOAD: bytes = serialize(None)[0]
