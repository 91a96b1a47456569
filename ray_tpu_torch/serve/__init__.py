"""The port's serve plane: deployments on replica processes, placed on the
host's cards, behind a stdlib HTTP proxy with SSE, reached through handles,
and autoscaled on their ongoing requests; ``@batch`` in front of the model.

Port of ray_tpu's ``serve/`` onto the port's single-host processes
(``api``, ``controller``, ``replica``, ``handle``, ``proxy``,
``long_poll``, ``routing``, ``autoscaling_policy``, ``batching``). A
deployment's class or function must be importable from a module: replicas
import it by name. Left out (ROADMAP Queue A item 9): multiplexing, the
gRPC proxy, YAML deploys, hedging and circuit breakers, several proxies,
and drains on memory telemetry.
"""

from ray_tpu_torch.serve._common import (
    AutoscalingConfig, Deadline, DeadlineExceededError, DeploymentConfig, ReplicaDiedError,
    RequestShedError, RetryPolicy, TaskError,
)
from ray_tpu_torch.serve.api import (
    Application, Deployment, delete, deployment, get_app_handle, get_deployment_handle, run,
    shutdown, start, status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse, ResponseStream

__all__ = [
    "deployment", "Deployment", "Application", "run", "start", "status", "delete", "shutdown",
    "get_app_handle", "get_deployment_handle", "DeploymentHandle", "DeploymentResponse",
    "ResponseStream", "batch", "AutoscalingConfig", "DeploymentConfig", "RetryPolicy",
    "Deadline", "DeadlineExceededError", "ReplicaDiedError", "RequestShedError", "TaskError",
]
