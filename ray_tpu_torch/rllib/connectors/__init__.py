from ray_tpu_torch.rllib.connectors.connector import (
    ClipActions,
    ConnectorPipelineV2,
    ConnectorV2,
    FlattenObservations,
    FrameStack,
    GeneralAdvantageEstimation,
    LambdaConnector,
    NormalizeObservations,
    default_env_to_module,
    default_module_to_env,
)

__all__ = [
    "ClipActions",
    "ConnectorPipelineV2",
    "ConnectorV2",
    "FlattenObservations",
    "FrameStack",
    "GeneralAdvantageEstimation",
    "LambdaConnector",
    "NormalizeObservations",
    "default_env_to_module",
    "default_module_to_env",
]
