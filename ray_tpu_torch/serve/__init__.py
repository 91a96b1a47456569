"""The port's serve plane: deployments on replica processes, placed on the
host's cards, behind a stdlib HTTP proxy with SSE (and more proxies, each
a process the controller restarts, and a gRPC proxy), reached through
handles with retries, hedging and circuit breakers, autoscaled on their
ongoing requests, the routes' p99 and a serve-LLM pool's KV headroom;
``@batch`` and ``@multiplexed`` in front of the model; deploys from YAML.

Port of ray_tpu's ``serve/`` onto the port's single-host processes
(``api``, ``controller``, ``replica``, ``handle``, ``proxy``,
``grpc_proxy``, ``long_poll``, ``routing``, ``autoscaling_policy``,
``batching``, ``multiplex``, ``schema``, and ``llm``: the serve-LLM
engine with continuous batching, disaggregated prefill and decode pools
and the KV pool on the decode replica's card). A deployment's class or
function must be importable from a module: replicas import it by name.
Waiting for the runtime core (ROADMAP Queue A item 14): the controller's
checkpoint in its KV store, drains on out-of-memory telemetry, the flush
of route stats to the workload store, and the ``serve deploy`` command.
"""

from ray_tpu_torch.serve._common import (
    AutoscalingConfig, Deadline, DeadlineExceededError, DeploymentConfig, ReplicaDiedError,
    RequestShedError, RetryPolicy, TaskError,
)
from ray_tpu_torch.serve.api import (
    Application, Deployment, delete, deployment, get_app_handle, get_deployment_handle, run,
    run_from_config, shutdown, start, status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse, ResponseStream
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "deployment", "Deployment", "Application", "run", "start", "status", "delete", "shutdown",
    "get_app_handle", "get_deployment_handle", "DeploymentHandle", "DeploymentResponse",
    "ResponseStream", "run_from_config", "batch", "multiplexed", "get_multiplexed_model_id",
    "AutoscalingConfig", "DeploymentConfig", "RetryPolicy", "Deadline",
    "DeadlineExceededError", "ReplicaDiedError", "RequestShedError", "TaskError",
]
