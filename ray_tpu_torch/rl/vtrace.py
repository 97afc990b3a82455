"""V-trace off-policy correction (Espeholt et al. 2018), in PyTorch.

Mirrors ray_tpu/rl/vtrace.py. Given behaviour-policy log-probs mu and
target-policy log-probs pi over a trajectory, compute value targets vs
and policy-gradient advantages with clipped importance weights:

    rho_t  = min(rho_bar, exp(pi_t - mu_t))
    c_t    = lambda * min(c_bar, exp(pi_t - mu_t))
    delta_t = rho_t * (r_t + gamma_t * V_{t+1} - V_t)
    vs_t   = V_t + delta_t + gamma_t * c_t * (vs_{t+1} - V_{t+1})
    adv_t  = rho_t * (r_t + gamma_t * vs_{t+1} - V_t)

gamma_t = gamma * (1 - done_t): episode boundaries cut the recursion.
JAX's reverse ``lax.scan`` is a reverse loop over T here, and its
``stop_gradient`` on the outputs is a computation without autograd.
"""

from __future__ import annotations

import torch


def _device(*xs) -> torch.device:
    return next((x.device for x in xs if isinstance(x, torch.Tensor)),
                torch.device("cpu"))


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value,
           dones, *, gamma: float = 0.99, lam: float = 1.0,
           rho_bar: float = 1.0, c_bar: float = 1.0):
    """All inputs [T] (single trajectory) or [T, B], tensors or arrays, on
    one device; returns (vs, adv) as f32 tensors there, outside autograd
    (the losses treat them as constants, as IMPALA does)."""
    dev = _device(behavior_logp, target_logp, rewards, values,
                  bootstrap_value, dones)

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)

    behavior_logp, target_logp = f32(behavior_logp), f32(target_logp)
    rewards, values = f32(rewards), f32(values)
    bootstrap = f32(bootstrap_value)[None]

    log_rho = target_logp - behavior_logp
    rho = torch.clamp(torch.exp(log_rho), max=rho_bar)
    c = lam * torch.clamp(torch.exp(log_rho), max=c_bar)
    discount = gamma * (1.0 - f32(dones))

    next_values = torch.cat([values[1:], bootstrap])
    deltas = rho * (rewards + discount * next_values - values)

    errs = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[-1])  # vs_{t+1} - V_{t+1}
    for t in reversed(range(deltas.shape[0])):
        carry = deltas[t] + discount[t] * c[t] * carry
        errs[t] = carry
    vs = values + errs
    next_vs = torch.cat([vs[1:], bootstrap])
    adv = rho * (rewards + discount * next_vs - values)
    return vs, adv
