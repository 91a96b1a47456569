"""ray_tpu_torch.rllib — reinforcement learning on the port: PPO.

Port of ray_tpu's ``rllib`` (new API stack), single-agent PPO path:
RLModules whose params live on the learner's device (``MLPModule``,
``ConvModule``, ``LSTMModule``), a ``Learner`` that runs loss, gradients,
the global-norm clip and Adam there (cuda unless the caller passes
``device="cpu"``), env runners that step gymnasium vector envs on the CPU,
ConnectorV2 pipelines, SampleBatch, GAE, and an ``Algorithm`` that loops
sample → GAE → minibatch epochs → weight sync, with save, restore and
evaluate. The reference's own split holds: learners own the accelerator,
rollouts stay on the host.

**The boundary.** The reference runs env runners and learners as
``ray_tpu.remote`` actors (``env_runner_group.py:35-51``,
``learner.py:182-194``), and multi-learner data parallelism all-reduces
over the runtime's ``ring`` backend (``learner.py:123-145``). The port has
no actor runtime (ROADMAP Queue A item 4), so:

  * env runners each live in a CPU process of ``util.gang.WorkerGang(n,
    use_gpu=False)``, in the member's state, one torch thread each (the
    reference's actors take one CPU): ``num_env_runners`` keeps its
    meaning and rollouts stay parallel;
  * with ``num_learners=0`` (the default) the learner is local, in the
    caller's process, on ``device``; with ``num_learners >= 1`` the learners
    run on a gang (a card each on cuda, gloo on the CPU) whose
    ``NcclGroup`` sums the shards' gradients, divided by the world size,
    as the reference's ``update_shard`` does.

``num_tpus_per_learner`` is kept in the config, as the reference keeps
it, and read nowhere. ``rl_module``, ``learner`` and ``ppo`` import
gymnasium nowhere at module level, so the learner half imports on a
machine without it.

Not yet ported (ROADMAP Queue A item 7b): IMPALA, APPO, DQN, SAC, BC,
MARWIL and CQL, vtrace, replay buffers, offline data, ``MultiAgentEnv``,
``MultiAgentCartPole``, ``MultiAgentEnvRunner``, and the multi-agent paths
of ``Algorithm`` and PPO, which raise ``NotImplementedError`` naming that
item, as the asynchronous sampling of ``EnvRunnerGroup`` does.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup, MultiAgentLearnerGroup
from ray_tpu_torch.rllib.core.multi_rl_module import MultiRLModule, MultiRLModuleSpec
from ray_tpu_torch.rllib.core.rl_module import (
    ConvModule, LSTMModule, MLPModule, RLModule, RLModuleSpec,
)
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "PPOLearner", "Learner",
    "LearnerGroup", "MultiAgentLearnerGroup", "MultiRLModule", "MultiRLModuleSpec",
    "RLModule", "RLModuleSpec", "MLPModule", "ConvModule", "LSTMModule",
    "SingleAgentEnvRunner", "EnvRunnerGroup", "SampleBatch", "MultiAgentBatch",
]
