"""User-facing exceptions.

Role-equivalent of python/ray/exceptions.py in the reference
(RayError/RayTaskError/ActorDiedError/ObjectLostError/...).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised; carries the remote traceback.

    Reference: RayTaskError — raised from ray.get() at the caller, so the
    remote failure surfaces at the point the value is consumed.
    """

    def __init__(self, task_name: str, remote_traceback: str):
        self.task_name = task_name
        self.remote_traceback = remote_traceback
        super().__init__(
            f"task {task_name!r} failed remotely:\n{remote_traceback}"
        )

    def __reduce__(self):
        return (TaskError, (self.task_name, self.remote_traceback))


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu_torch.cancel() (reference:
    ray.exceptions.TaskCancelledError, python/ray/tests/test_cancel.py)."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died (e.g. OOM-killed, segfault)."""


class OutOfMemoryError(WorkerCrashedError):
    """The node's memory monitor killed the worker (reference
    memory_monitor.cc / raylet OOM-killer role, N15): a system failure
    distinct from application exceptions — it participates in task
    retries (max_retries) and never masquerades as user code raising."""


class ActorDiedError(RayTpuError):
    """The actor is permanently dead (restarts exhausted or never restartable)."""


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class DAGActorDiedError(ActorDiedError):
    """An actor participating in a compiled DAG died while an execution
    was in flight. Raised from DAGRef.get() instead of a bare timeout so
    callers can distinguish 'the graph is dead' from 'the graph is
    slow'; names the dead actor and its device-plane rank so the report
    lines up with the hang doctor's suspect ranks, plus the edge it was
    detected on — channel name, family, channel epoch, and the seq
    frontier the consumer was blocked at — so the DAG supervisor and the
    hang report agree on the blast radius."""

    def __init__(self, dag_id: str, actor_id: str, rank: int,
                 detail: str = "", *, channel: str | None = None,
                 family: str | None = None, epoch: int | None = None,
                 seq: int | None = None):
        self.dag_id = dag_id
        self.actor_id = actor_id
        self.rank = rank
        self.detail = detail
        self.channel = channel
        self.family = family
        self.epoch = epoch
        self.seq = seq
        message = (
            f"compiled DAG {dag_id}: actor {actor_id} (dag rank {rank}) "
            "died with executions in flight"
        )
        if channel is not None:
            message += (
                f" [detected on {family or '?'} channel {channel}"
                f" epoch={epoch} seq frontier={seq}]"
            )
        if detail:
            message += f": {detail}"
        super().__init__(message)

    def __reduce__(self):
        # 3rd element updates __dict__ on unpickle, so the edge evidence
        # survives the wire without breaking older (dag_id, actor_id,
        # rank) consumers.
        return (
            DAGActorDiedError,
            (self.dag_id, self.actor_id, self.rank, self.detail),
            {
                "channel": self.channel, "family": self.family,
                "epoch": self.epoch, "seq": self.seq,
            },
        )


class ReplicaDiedError(RayTpuError):
    """The serve replica backing an in-flight request died mid-call and
    the request could not be completed on another replica. Raised by
    DeploymentResponse.result() instead of a bare timeout/actor error so
    callers can distinguish 'my request is lost' from 'my request is
    slow' (the handle already spent its RetryPolicy budget against
    healthy replicas)."""

    def __init__(self, deployment: str, replica: str, detail: str = ""):
        self.deployment = deployment
        self.replica = replica
        message = (
            f"replica {replica!r} of deployment {deployment!r} died "
            f"while serving the request"
        )
        if detail:
            message += f": {detail}"
        super().__init__(message)

    def __reduce__(self):
        return (ReplicaDiedError, (self.deployment, self.replica))


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's propagated serve Deadline expired before completion.

    Subclasses TimeoutError so callers that handled the old bare
    GetTimeoutError-style timeouts keep working; distinct from it so SLO
    accounting can tell 'the budget ran out' from 'an internal get timed
    out'. Maps to HTTP 504 at the proxy."""

    def __init__(self, detail: str = ""):
        self.detail = detail
        super().__init__(detail or "request deadline exceeded")

    def __reduce__(self):
        return (DeadlineExceededError, (self.detail,))


class RequestShedError(RayTpuError):
    """Admission control rejected the request before doing work (queue depth
    projected past the route SLO). Maps to HTTP 503 + Retry-After at the
    proxy; never retried by the handle — retrying amplifies overload."""

    def __init__(self, detail: str = "", retry_after_s: float = 1.0):
        self.detail = detail
        self.retry_after_s = retry_after_s
        super().__init__(detail or "request shed by admission control")

    def __reduce__(self):
        return (RequestShedError, (self.detail, self.retry_after_s))


class ReplicaDrainingError(RayTpuError):
    """The replica is draining (oom_risk / SIGTERM / scale-down) and not
    accepting new work. The handle retries another replica without charging
    the circuit breaker — draining is deliberate, not a fault."""

    def __init__(self, replica: str = ""):
        self.replica = replica
        super().__init__(
            f"replica {replica!r} is draining and not accepting requests"
        )

    def __reduce__(self):
        return (ReplicaDrainingError, (self.replica,))


class ObjectLostError(RayTpuError):
    """All copies of the object are gone and it could not be reconstructed."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get(..., timeout=) expired."""


class ObjectStoreFullError(RayTpuError):
    """The shared-memory store cannot fit the object even after eviction."""


class RuntimeEnvSetupError(RayTpuError):
    """Worker runtime environment failed to materialize."""


class PlacementGroupUnschedulableError(RayTpuError):
    """The placement group cannot fit on the cluster."""


class GangDiedError(RayTpuError):
    """A member of an SPMD worker gang died; the gang's collectives are wedged
    and the whole gang is the failure domain (see SURVEY §5.3)."""
