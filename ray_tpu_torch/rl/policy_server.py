"""External-env policy serving: PolicyServer + PolicyClient, in PyTorch.

Mirrors ray_tpu/rl/policy_server.py (reference
rllib/env/policy_server_input.py:1 + policy_client.py): an EXTERNAL
simulator (a game server, a robot, a process the cluster doesn't
control) connects over HTTP, asks the current policy for actions, and
reports rewards; the collected episodes become training batches. The
server is a deployment through ``runtime`` (``serve.runtime``'s
``deploy`` and ``http_address``; None: in-process, whose ingress is a
stdlib HTTP server), the policy is an RLModule's forward on ``device``
(None: ``cuda``, which raises without a card), and drain_samples()
returns PPO-ready (obs, actions, logp, rewards, dones) arrays the
Learner/LearnerGroup consume unchanged. The module and params travel as
objects (JAX packs them into blobs for its runtime's serializer; a
hosting runtime pickles a call's arguments itself); exploration
samples through the module's ``forward_exploration`` with a threefry key
(``utils/prng.py``) folded from the seed and a draw counter, where JAX
splits its key.
"""

from __future__ import annotations

import json
import threading

_MAX_CONCURRENT_QUERIES = 16


class _PolicyDeploymentImpl:
    """The replica: holds module params, serves actions, buffers
    transitions per episode. Deployed with one replica — the sample
    buffer is replica-local state."""

    def __init__(self, module, params, explore: bool = True, seed: int = 0,
                 device=None):
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.rl import models
        from ray_tpu_torch.utils import prng

        self.device = resolve_device(device)
        self.module = module
        self.params = models.as_tensors(params, self.device)
        self.explore = explore
        self._key = prng.prng_key(seed)
        self._draws = 0
        self._lock = threading.Lock()
        self._episodes: dict[str, dict] = {}
        self._complete: list[dict] = []
        self._next_eid = 0

    def __call__(self, req: dict):
        cmd = req.get("cmd")
        if cmd == "start_episode":
            with self._lock:
                eid = f"ep_{self._next_eid}"
                self._next_eid += 1
                self._episodes[eid] = {
                    "obs": [], "actions": [], "logp": [], "rewards": [],
                }
            return {"episode_id": eid}
        if cmd == "get_action":
            return self._get_action(req["episode_id"], req["obs"])
        if cmd == "log_returns":
            with self._lock:
                ep = self._episodes[req["episode_id"]]
                # reward for the MOST RECENT action (reference
                # log_returns contract)
                ep["rewards"][-1] += float(req["reward"])
            return {"ok": True}
        if cmd == "end_episode":
            with self._lock:
                ep = self._episodes.pop(req["episode_id"])
                ep["final_obs"] = req.get("obs")
                self._complete.append(ep)
            return {"ok": True}
        raise ValueError(f"unknown policy server cmd {cmd!r}")

    def _get_action(self, eid: str, obs):
        import numpy as np
        import torch

        from ray_tpu_torch.utils import prng

        ob = torch.from_numpy(np.asarray(obs, np.float32).reshape(1, -1)
                              ).to(self.device)
        with self._lock:
            key = prng.fold_in(self._key, self._draws)
            self._draws += 1
            params = self.params
        with torch.no_grad():
            if self.explore:
                act, logp = self.module.forward_exploration(params, ob, key)
                a, lp = int(act[0]), float(logp[0])
            else:
                a = int(self.module.forward_inference(params, ob)[0])
                lp = 0.0
        with self._lock:
            ep = self._episodes[eid]
            ep["obs"].append([float(x) for x in np.asarray(obs).ravel()])
            ep["actions"].append(a)
            ep["logp"].append(lp)
            ep["rewards"].append(0.0)  # log_returns accumulates into it
        return {"action": a, "logp": lp}

    # -- trainer-side calls (through the deployment handle, not HTTP) --

    def set_weights(self, params):
        from ray_tpu_torch.rl import models

        params = models.as_tensors(params, self.device)
        with self._lock:
            self.params = params
        return True

    def drain_samples(self):
        """Completed episodes since the last drain, as plain lists."""
        with self._lock:
            out, self._complete = self._complete, []
        return out

    def stats(self):
        with self._lock:
            return {"open_episodes": len(self._episodes),
                    "complete_episodes": len(self._complete)}


class PolicyServer:
    """Driver-side facade: deploy the policy, push weights, drain
    training batches (reference PolicyServerInput's role)."""

    def __init__(self, module, params, *, name: str = "policy",
                 route: str = "/policy", explore: bool = True,
                 seed: int = 0, runtime=None, device=None):
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.rl import models
        from ray_tpu_torch.serve.runtime import InProcessRuntime

        self.name = name
        self.runtime = runtime or InProcessRuntime()
        self.handle = self.runtime.deploy(
            _PolicyDeploymentImpl, name=name, route_prefix=route,
            init_args=(module, models.to_host(params)),
            init_kwargs={"explore": explore, "seed": seed,
                         "device": resolve_device(device)},
            num_replicas=1, max_concurrent_queries=_MAX_CONCURRENT_QUERIES)
        self.address = self.runtime.http_address()
        self.route = route

    def set_weights(self, params) -> None:
        from ray_tpu_torch.rl import models

        rt = self.runtime
        rt.get(rt.call(self.handle, "set_weights", models.to_host(params)),
               timeout=120)

    def drain_samples(self) -> dict | None:
        """PPO-ready arrays from all completed episodes since the last
        call: obs/actions/logp/rewards/dones (+ episode_returns)."""
        import numpy as np

        rt = self.runtime
        eps = rt.get(rt.call(self.handle, "drain_samples"), timeout=120)
        if not eps:
            return None
        obs, actions, logp, rewards, dones, rets = [], [], [], [], [], []
        for ep in eps:
            n = len(ep["actions"])
            if n == 0:
                continue
            obs.extend(ep["obs"])
            actions.extend(ep["actions"])
            logp.extend(ep["logp"])
            rewards.extend(ep["rewards"])
            dones.extend([False] * (n - 1) + [True])
            rets.append(sum(ep["rewards"]))
        if not actions:
            return None
        return {
            "obs": np.asarray(obs, np.float32),
            "actions": np.asarray(actions, np.int32),
            "logp": np.asarray(logp, np.float32),
            "rewards": np.asarray(rewards, np.float32),
            "dones": np.asarray(dones, bool),
            "episode_returns": rets,
        }

    def shutdown(self) -> None:
        """Undeploy (the in-process ingress stops with its last route)."""
        self.runtime.kill(self.handle)


def _floats(obs) -> list:
    """An observation (a number, a nested list, or anything with
    ``tolist``) as a flat list of floats."""
    if hasattr(obs, "tolist"):
        obs = obs.tolist()
    if isinstance(obs, (list, tuple)):
        return [f for x in obs for f in _floats(x)]
    return [float(obs)]


class PolicyClient:
    """The external simulator's side (reference policy_client.py): a
    plain HTTP client — nothing beyond the standard library, so a
    third-party process can speak it from anywhere."""

    def __init__(self, address: tuple, route: str = "/policy",
                 timeout: float = 60.0):
        self.host, self.port = address
        self.route = route
        self.timeout = timeout

    def _post(self, body: dict) -> dict:
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("POST", self.route, json.dumps(body),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            data = json.loads(r.read() or b"null")
            if r.status != 200:
                raise RuntimeError(f"policy server {r.status}: {data}")
            return data
        finally:
            conn.close()

    def start_episode(self) -> str:
        return self._post({"cmd": "start_episode"})["episode_id"]

    def get_action(self, episode_id: str, obs) -> int:
        return self._post({
            "cmd": "get_action", "episode_id": episode_id,
            "obs": _floats(obs),
        })["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._post({"cmd": "log_returns", "episode_id": episode_id,
                    "reward": float(reward)})

    def end_episode(self, episode_id: str, obs=None) -> None:
        self._post({
            "cmd": "end_episode", "episode_id": episode_id,
            "obs": _floats(obs) if obs is not None else None,
        })
