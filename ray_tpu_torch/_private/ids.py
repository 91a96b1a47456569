"""Unique identifiers for objects, tasks, actors, nodes, jobs, workers.

Equivalent of the reference's src/ray/common/id.h (ObjectID/TaskID/ActorID/
NodeID/...). We keep the reference's key structural property: an ObjectID
embeds the TaskID that created it plus a return/put index, which is what makes
lineage-based reconstruction possible (the object's creating task is
recoverable from its id alone).
"""

from __future__ import annotations

import os
import threading

_KIND_PREFIX = {
    "Job": "job",
    "Node": "node",
    "Worker": "wkr",
    "Actor": "act",
    "Task": "tsk",
    "Object": "obj",
    "PlacementGroup": "pg",
    "Gang": "gang",
}


class BaseID(str):
    """Ids are prefixed hex strings — cheap, hashable, msgpack-friendly."""

    KIND = "Base"

    @classmethod
    def random(cls) -> "BaseID":
        return cls(f"{_KIND_PREFIX[cls.KIND]}-{os.urandom(12).hex()}")

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(f"{_KIND_PREFIX[cls.KIND]}-{'0'*24}")

    def is_nil(self) -> bool:
        return self.endswith("0" * 24)


class JobID(BaseID):
    KIND = "Job"


class NodeID(BaseID):
    KIND = "Node"


class WorkerID(BaseID):
    KIND = "Worker"


class ActorID(BaseID):
    KIND = "Actor"


class PlacementGroupID(BaseID):
    KIND = "PlacementGroup"


class GangID(BaseID):
    KIND = "Gang"


class TaskID(BaseID):
    KIND = "Task"

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(f"tsk-creation-{actor_id}")


class ObjectID(BaseID):
    KIND = "Object"

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        # Embeds the creating task id => lineage reconstruction can find the
        # creating task from the object id (reference: id.h return-id layout).
        return cls(f"obj-{task_id}-r{index}")

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(f"obj-{task_id}-p{put_index}")

    def creating_task_id(self) -> TaskID | None:
        if self.startswith("obj-tsk-"):
            body = self[len("obj-"):]
            task_part = body.rsplit("-", 1)[0]
            return TaskID(task_part)
        return None

    def is_put(self) -> bool:
        return "-p" in self.rsplit("-", 1)[-1] or self.rsplit("-", 1)[-1].startswith("p")


class _Counter:
    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
