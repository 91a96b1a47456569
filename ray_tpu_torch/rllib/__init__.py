"""ray_tpu_torch.rllib — reinforcement learning on the port.

Port of ray_tpu's ``rllib`` (new API stack): RLModules whose params live
on the learner's device (``MLPModule``, ``ConvModule``, ``LSTMModule``,
SAC's ``SACModule``), a ``Learner`` that runs loss, gradients, the
global-norm clip and Adam there (cuda unless the caller passes
``device="cpu"``), env runners that step gymnasium vector envs (or a
``MultiAgentEnv``) on the CPU, ConnectorV2 pipelines, SampleBatch and
MultiAgentBatch, GAE and V-trace, replay buffers and offline data, and
the algorithms with their fluent configs: PPO (single- and multi-agent),
IMPALA and APPO (asynchronous sampling), DQN and SAC (replay), BC, MARWIL
and CQL (offline). The reference's own split holds: learners own the
accelerator, rollouts, replay and the offline datasets stay on the host.

**Actors.** As in the reference (``env_runner_group.py:35-51``,
``learner.py:182-194``), env runners and remote learners are
``ray_tpu_torch.remote`` actors, so an algorithm that builds them needs
``ray_tpu_torch.init()`` first:

  * env runners (single- or multi-agent) are ``num_env_runners`` actors of
    one CPU each, one torch thread each; IMPALA's asynchronous sampling
    starts ``sample`` on each and harvests the refs as they come
    (``EnvRunnerGroup.sample_async`` / ``collect_ready``);
  * with ``num_learners=0`` (the default) the learner is local, in the
    caller's process, on ``device``; with ``num_learners >= 1`` the
    learners are ``_LearnerActor``s (a card each on cuda, a CPU each on the
    CPU) whose collective group (an ``NcclGroup`` on the card, where the
    reference's moves host copies over ``ring``) sums the shards'
    gradients, divided by the world size, as the reference's
    ``update_shard`` does. Multi-agent learners (one a module id) are
    local, as the reference's.

Where the reference draws from JAX's PRNG inside a jitted step (SAC's and
CQL's sampled actions), the port's step takes the noise as tensors, drawn
from the learner's ``torch.Generator`` on its device.

``num_tpus_per_learner`` is kept in the config, as the reference keeps
it, and read nowhere. No module here imports gymnasium at module level,
so the learner half imports on a machine without it.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.marwil.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rllib.algorithms.sac.sac import SAC, SACConfig
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup, MultiAgentLearnerGroup
from ray_tpu_torch.rllib.core.multi_rl_module import MultiRLModule, MultiRLModuleSpec
from ray_tpu_torch.rllib.core.rl_module import (
    ConvModule, LSTMModule, MLPModule, RLModule, RLModuleSpec,
)
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentCartPole, MultiAgentEnv
from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
    "IMPALAConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "BC", "BCConfig", "CQL",
    "CQLConfig", "MARWIL", "MARWILConfig", "SAC", "SACConfig", "Learner",
    "LearnerGroup", "MultiAgentLearnerGroup", "MultiRLModule",
    "MultiRLModuleSpec", "RLModule", "RLModuleSpec", "MLPModule",
    "SingleAgentEnvRunner", "EnvRunnerGroup", "MultiAgentEnv",
    "MultiAgentCartPole", "MultiAgentEnvRunner", "SampleBatch",
    "MultiAgentBatch",
    # the port's own beyond the reference's list
    "PPOLearner", "ConvModule", "LSTMModule",
]
