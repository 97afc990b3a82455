"""ray_tpu_torch.rl: the RL layer, in PyTorch.

Mirrors ray_tpu/rl/ (reference rllib/): EnvRunner members sample with
host-side numpy policies on the CPU; the learners' updates are plain
torch functions with autograd on an explicit device; learner groups
allreduce their gradients through the runtime's collective; the policy
server is a deployment behind the runtime's HTTP ingress; the
actor-learner loop closes the serving pool and the trainer into one
post-training system. Members are spawned and called through a runtime
(``serve.runtime``; in-process by default). Every module of ray_tpu/rl/
is ported.
"""

from ray_tpu_torch.rl.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rl.env_runner import EnvRunner  # noqa: F401
from ray_tpu_torch.rl.learner import Learner  # noqa: F401
from ray_tpu_torch.rl.learner_group import (  # noqa: F401
    LearnerGroup,
    SACLearnerGroup,
)
from ray_tpu_torch.rl.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rl.bc import BC, BCConfig  # noqa: F401
from ray_tpu_torch.rl.replay import ReplayBuffer  # noqa: F401
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rl.vector_env import VectorEnvRunner  # noqa: F401
from ray_tpu_torch.rl.multi_agent import (  # noqa: F401
    MultiAgentEnv,
    SharedPolicyWrapper,
)
from ray_tpu_torch.rl.vtrace import vtrace  # noqa: F401
from ray_tpu_torch.rl.experience import ExperienceBuffer  # noqa: F401
from ray_tpu_torch.rl.actor_learner import (  # noqa: F401
    ActorLearnerConfig,
    ActorLearnerLoop,
)
from ray_tpu_torch.rl.sac import SAC, SACConfig, SACLearner  # noqa: F401
from ray_tpu_torch.rl.policy_server import (  # noqa: F401
    PolicyClient,
    PolicyServer,
)
from ray_tpu_torch.rl.connectors import (  # noqa: F401
    ClipAction,
    Connector,
    FrameStack,
    ObsNormalizer,
    Pipeline,
)
from ray_tpu_torch.rl.envs import PendulumEnv  # noqa: F401
