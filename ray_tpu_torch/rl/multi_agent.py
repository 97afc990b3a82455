"""Multi-agent environments (reference rllib/env/multi_agent_env.py).

The port's own copy of ray_tpu/rl/multi_agent.py (plain Python,
unchanged).

A MultiAgentEnv's reset/step speak per-agent dicts:

    reset() -> {agent_id: obs}
    step({agent_id: action}) -> ({id: obs}, {id: reward}, {id: done}, info)
    dones may include "__all__" to end the episode for everyone.

`SharedPolicyWrapper` flattens a MultiAgentEnv into the single-agent env
contract the existing runners/algorithms consume with ONE shared policy
(parameter sharing — the standard first multi-agent setup): each step
feeds every live agent's observation through the policy and emits the
summed reward; transitions interleave per agent so the policy trains on
all agents' experience.
"""

from __future__ import annotations

from typing import Any


class MultiAgentEnv:
    """Interface marker (subclass and implement reset/step)."""

    def reset(self) -> dict:  # pragma: no cover — interface
        raise NotImplementedError

    def step(self, action_dict: dict) -> tuple[dict, dict, dict, dict]:
        raise NotImplementedError  # pragma: no cover

    @property
    def agent_ids(self) -> list:  # pragma: no cover — optional
        return []


class SharedPolicyWrapper:
    """MultiAgentEnv -> single-agent env with round-robin agent turns.

    Each call to step() advances ONE agent's pending action; when every
    live agent has an action queued, the underlying env steps once and
    rewards are credited to the agent whose action completed the joint
    step (summed team reward). Observations presented to the policy are
    always the CURRENT agent's — so one policy network serves all agents
    and the trajectory interleaves their experience (parameter sharing)."""

    def __init__(self, env: MultiAgentEnv):
        self.env = env
        self._obs: dict = {}
        self._order: list = []
        self._idx = 0
        self._pending: dict = {}

    def reset(self):
        self._obs = self.env.reset()
        self._order = sorted(self._obs)
        self._idx = 0
        self._pending = {}
        return self._obs[self._order[0]]

    def step(self, action) -> tuple[Any, float, bool, dict]:
        agent = self._order[self._idx]
        self._pending[agent] = action
        self._idx += 1
        if self._idx < len(self._order):
            # next agent's turn; no env transition yet
            return self._obs[self._order[self._idx]], 0.0, False, {}
        obs, rewards, dones, info = self.env.step(self._pending)
        self._pending = {}
        done_all = bool(dones.get("__all__", False)) or (
            all(dones.get(a, False) for a in self._order))
        team_reward = float(sum(rewards.values()))
        if done_all:
            return (next(iter(obs.values())) if obs
                    else self._obs[self._order[0]],
                    team_reward, True, info)
        self._obs = {a: o for a, o in obs.items()
                     if not dones.get(a, False)}
        self._order = sorted(self._obs)
        self._idx = 0
        return self._obs[self._order[0]], team_reward, False, info
