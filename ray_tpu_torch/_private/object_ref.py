"""ObjectRef — a distributed future naming an immutable object.

Role-equivalent of the reference ObjectRef (python/ray/_raylet.pyx ObjectRef +
src/ray/common/id.h ObjectID). Holds the owner's address so any holder can
resolve the value (ownership-based object directory,
src/ray/object_manager/ownership_object_directory.cc).
__del__ drives distributed reference counting (reference_count.cc [N21]).
"""

from __future__ import annotations

from typing import Any


class ObjectRef:
    __slots__ = ("id", "owner_address", "_runtime", "__weakref__")

    def __init__(self, object_id: str, owner_address: tuple | None = None, runtime: Any | None = None):
        self.id = object_id
        self.owner_address = tuple(owner_address) if owner_address else None
        self._runtime = runtime
        if runtime is not None:
            runtime.add_local_ref(object_id)

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        assert self._runtime is not None
        return self._runtime.as_future(self)

    def __del__(self):
        runtime = getattr(self, "_runtime", None)
        if runtime is not None:
            try:
                runtime.remove_local_ref(self.id)
            except Exception:  # rtlint: disable=swallowed-exception - __del__ during interpreter teardown
                pass

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id})"

    def __reduce__(self):
        # Plain pickling (outside the runtime serializer) loses the borrow
        # bookkeeping; the runtime serializer intercepts via persistent_id
        # before this is reached.
        return (ObjectRef, (self.id, self.owner_address))
