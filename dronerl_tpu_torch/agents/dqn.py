"""DQN actor-learner for dense Q-networks (counterpart of
``dronerl_tpu/agents/dqn.py``, dense networks only).

Parameters keep flax's layout: layer i has ``kernel`` (in, out) and
``bias`` (out,), so weights carry across from the JAX package unchanged
(``interop/from_jax.py``) and the fused tick kernel reads them as they
are. The feature-major forward is ``kernelᵀ @ x + bias``.

The optimizer is Adam written out in optax's ``scale_by_adam`` order;
``torch.optim.Adam`` orders the same math differently.

:meth:`DQN.init_state` given a key draws the JAX package's initial nets
bit for bit: flax's per-parameter keys (``rng.flax_param_key``) and jax's
truncated normal (``rng.truncated_normal``).
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from dronerl_tpu_torch import resolve_device, rng
from dronerl_tpu_torch.constants import NUM_ACTIONS
from dronerl_tpu_torch.env.types import EnvParams

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class DQNConfig:
    """Static agent hyper-parameters (dense networks)."""

    hidden_layers: Tuple[int, ...] = (32, 32)
    gamma: float = 0.95
    epsilon_start: float = 1.0
    epsilon_decay: float = 0.999
    epsilon_end: float = 0.01
    epsilon_decay_every: Optional[int] = None
    learning_rate: float = 1e-3
    target_update_interval: int = 5
    tau: float = 1.0  # 1.0 = hard target copy; < 1 = EMA

    def __post_init__(self):
        object.__setattr__(self, "hidden_layers", tuple(self.hidden_layers))


class DenseQNet(nn.Module):
    """(Dense + ReLU)* → Dense(num_actions), weights in flax layout."""

    def __init__(self, obs_dim: int, hidden_layers: Tuple[int, ...],
                 device=None):
        super().__init__()
        widths = (obs_dim, *hidden_layers, NUM_ACTIONS)
        self.kernels = nn.ParameterList([
            nn.Parameter(torch.zeros(i, o, device=device))
            for i, o in zip(widths[:-1], widths[1:])])
        self.biases = nn.ParameterList([
            nn.Parameter(torch.zeros(o, device=device)) for o in widths[1:]])

    @property
    def n_layers(self) -> int:
        return len(self.kernels)

    def flat(self) -> List[torch.Tensor]:
        """[kernel_0, bias_0, kernel_1, bias_1, ...] (optax leaf order)."""
        out = []
        for w, b in zip(self.kernels, self.biases):
            out += [w, b]
        return out

    def forward_t(self, obs_t: torch.Tensor) -> torch.Tensor:
        """Feature-major forward: (obs_dim, B) → (num_actions, B)."""
        x = obs_t
        for idx, (w, b) in enumerate(zip(self.kernels, self.biases)):
            x = torch.matmul(w.t(), x) + b[:, None]
            if idx < self.n_layers - 1:
                x = torch.relu(x)
        return x

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """Row-major forward: (B, obs_dim) → (B, num_actions)."""
        return self.forward_t(obs.reshape(obs.shape[0], -1).t()).t()


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: step count and per-leaf moments."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class DQNState:
    params: DenseQNet
    target_params: DenseQNet
    opt_state: AdamState
    epsilon: torch.Tensor  # 0-d float32 on the state's device


# The standard deviation of a standard normal truncated to (-2, 2).
TRUNCATED_STD = 0.87962566103423978


def _he_init(net: DenseQNet, generator: torch.Generator) -> None:
    """flax init: he_normal hidden kernels, lecun_normal output kernel
    (both truncated normal on ±2σ, σ rescaled by 0.8796), zero biases."""
    with torch.no_grad():
        for idx, w in enumerate(net.kernels):
            scale = 2.0 if idx < net.n_layers - 1 else 1.0
            std = float(np.sqrt(scale / w.shape[0]) / TRUNCATED_STD)
            cpu = torch.empty(w.shape)
            nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            w.copy_(cpu)
            net.biases[idx].zero_()


def _flax_init(net: DenseQNet, key: torch.Tensor) -> None:
    """The JAX package's ``network.init({"params": key}, ...)`` of a dense
    Q-net (``dronerl_tpu/agents/dqn.py::DenseQNet``), bit for bit: layer i
    is flax's ``Dense_i``, whose kernel takes the module's first
    ``make_rng`` (count 1; the bias, zeros, the second). Hidden kernels use
    ``he_normal`` and the output kernel ``Dense``'s default
    ``lecun_normal``: ``variance_scaling(scale, "fan_in",
    "truncated_normal")`` with scale 2 and 1, i.e. ``truncated_normal(k,
    -2, 2) * (sqrt(f32(scale / fan_in)) / f32(0.8796...))`` in f32. The
    draw runs on the CPU and is copied to the net's device."""
    key = key.cpu()
    with torch.no_grad():
        for idx, w in enumerate(net.kernels):
            scale = 2.0 if idx < net.n_layers - 1 else 1.0
            variance = torch.tensor(scale / w.shape[0], dtype=torch.float32)
            std = torch.sqrt(variance) / torch.tensor(TRUNCATED_STD,
                                                      dtype=torch.float32)
            k = rng.flax_param_key(key, (f"Dense_{idx}", 1))
            w.copy_(rng.truncated_normal(k, -2.0, 2.0, w.shape) * std)
            net.biases[idx].zero_()


class DQN:
    """Dense DQN: static topology plus state-transition methods."""

    def __init__(self, config: DQNConfig, env_params: EnvParams,
                 device="cuda"):
        self.config = config
        self.env_params = env_params
        self.device = resolve_device(device)
        h, w, c = env_params.obs_shape
        self.obs_dim = h * w * c

    def make_net(self) -> DenseQNet:
        return DenseQNet(self.obs_dim, self.config.hidden_layers, self.device)

    def init_state(self, key: Union[torch.Tensor, torch.Generator]
                   ) -> DQNState:
        """A fresh learner state; Adam moments zero, ε at its start value.

        With a key (two uint32 words, as ``rng.PRNGKey`` makes them) the
        nets are the JAX package's ``DQN.init_state(key)`` bit for bit:
        the online net from ``key``, the target net from ``split(key)[1]``
        (drawn on the CPU, then moved to the agent's device). With a
        ``torch.Generator`` both nets are drawn from it in turn, with
        torch's truncated normal."""
        params, target = self.make_net(), self.make_net()
        if isinstance(key, torch.Generator):
            _he_init(params, key)
            _he_init(target, key)
        else:
            _flax_init(params, key)
            _flax_init(target, rng.split(key.cpu(), 2)[1])
        return DQNState(
            params=params,
            target_params=target,
            opt_state=AdamState(
                count=0,
                mu=[torch.zeros_like(p) for p in params.flat()],
                nu=[torch.zeros_like(p) for p in params.flat()]),
            epsilon=torch.tensor(self.config.epsilon_start,
                                 dtype=torch.float32, device=self.device),
        )

    def q_values_t(self, params: DenseQNet,
                   obs_t: torch.Tensor) -> torch.Tensor:
        """(obs_dim, B) observations → (num_actions, B) Q-values."""
        return params.forward_t(obs_t)

    def act_t(self, key: torch.Tensor, obs_t: torch.Tensor,
              state: DQNState) -> torch.Tensor:
        """ε-greedy actions for (obs_dim, B) observations → (B,) int32.

        Greedy is the lowest-index argmax of :meth:`q_values_t`. Else the
        key splits into explore and action keys: explore where
        ``uniform(explore_key, (B,)) < ε``, with ``randint(action_key, (B,),
        0, NUM_ACTIONS)``. The draws run where ``obs_t`` lies (B counters
        each), so a host key goes to that device first.
        """
        with torch.no_grad():
            q = self.q_values_t(state.params, obs_t)
        greedy_actions = torch.argmax(q, dim=0).to(torch.int32)
        batch = obs_t.shape[1]
        explore_key, action_key = rng.split(key, 2).to(obs_t.device)
        explore = rng.uniform(explore_key, (batch,)) < state.epsilon
        random_acts = rng.randint(action_key, (batch,), 0, NUM_ACTIONS)
        return torch.where(explore, random_acts, greedy_actions)

    def act(self, key: torch.Tensor, obs: torch.Tensor,
            state: DQNState) -> torch.Tensor:
        """ε-greedy actions for row-major observations (B, obs_dim) or (B,
        H, W, C) → (B,) int32: :meth:`act_t` on the transposed batch (the
        row-major forward is the feature-major one transposed, and the
        draws are the same B counters)."""
        return self.act_t(key, obs.reshape(obs.shape[0], -1).t(), state)

    def train_step(
        self, state: DQNState, batch: Dict[str, torch.Tensor],
    ) -> Tuple[DQNState, torch.Tensor]:
        """TD(0) MSE step with Adam on a row-major batch: obs / next_obs (B,
        obs_dim); actions, rewards and dones (B,). :meth:`train_step_t` on
        the transposed observations."""
        def rows_t(x):
            return x.reshape(x.shape[0], -1).t()
        return self.train_step_t(state, dict(
            batch, obs=rows_t(batch["obs"]),
            next_obs=rows_t(batch["next_obs"])))

    def train_step_t(
        self, state: DQNState, batch: Dict[str, torch.Tensor],
    ) -> Tuple[DQNState, torch.Tensor]:
        """TD(0) MSE step with Adam on a feature-major batch.

        ``batch``: obs / next_obs (obs_dim, B) float32; actions (B,) int;
        rewards and dones (B,) float32. Updates the online parameters and
        the moments in place and returns ``(state, loss)``.
        """
        cfg = self.config
        params = state.params.flat()
        with torch.no_grad():
            next_q = self.q_values_t(state.target_params, batch["next_obs"])
            bootstrap = next_q.max(dim=0).values
            target = batch["rewards"] + cfg.gamma * bootstrap * (
                1 - batch["dones"])
        with torch.enable_grad():
            q = self.q_values_t(state.params, batch["obs"])
            taken = q.gather(0, batch["actions"].long()[None, :])[0]
            loss = torch.mean(torch.square(taken - target))
            grads = torch.autograd.grad(loss, params)

        adam = state.opt_state
        count = adam.count + 1
        b1, b2 = np.float32(ADAM_B1), np.float32(ADAM_B2)
        bc1 = float(np.float32(1.0) - b1 ** np.float32(count))
        bc2 = float(np.float32(1.0) - b2 ** np.float32(count))
        # optax's formulas, one op at a time over every leaf at once (a
        # foreach op is one launch for all leaves).
        with torch.no_grad():
            mu = torch._foreach_add(torch._foreach_mul(grads, 1 - ADAM_B1),
                                    torch._foreach_mul(adam.mu, ADAM_B1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(grads, grads),
                                   1 - ADAM_B2),
                torch._foreach_mul(adam.nu, ADAM_B2))
            torch._foreach_copy_(adam.mu, mu)
            torch._foreach_copy_(adam.nu, nu)
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), ADAM_EPS)
            update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(
                params, torch._foreach_mul(update, -cfg.learning_rate))
        adam.count = count
        return state, loss.detach()

    def should_decay_epsilon(self, step: int, done: torch.Tensor):
        """Decay every N steps if configured, else at episode boundaries."""
        if self.config.epsilon_decay_every is None:
            return done
        return step % self.config.epsilon_decay_every == 0

    def update_target(self, state: DQNState) -> DQNState:
        """``tau·params + (1-tau)·target`` into the target net, in place
        (optax's ``incremental_update``; a hard copy at ``tau`` = 1)."""
        tau = self.config.tau
        with torch.no_grad():
            target = state.target_params.flat()
            torch._foreach_copy_(target, torch._foreach_add(
                torch._foreach_mul(state.params.flat(), tau),
                torch._foreach_mul(target, 1.0 - tau)))
        return state

    def decayed_epsilon(self, state: DQNState) -> torch.Tensor:
        """``max(ε·decay, end)``."""
        return torch.clamp(state.epsilon * self.config.epsilon_decay,
                           min=self.config.epsilon_end)

    def decay_epsilon(self, state: DQNState) -> DQNState:
        state.epsilon = self.decayed_epsilon(state)
        return state

    def apply_schedules(self, state: DQNState, step: int,
                        done: torch.Tensor) -> DQNState:
        """Target sync every ``target_update_interval`` steps (EMA with
        ``tau``, a hard copy at 1.0) and the ε decay, in place."""
        if step % self.config.target_update_interval == 0:
            self.update_target(state)
        do_e = self.should_decay_epsilon(step, done)
        if isinstance(do_e, torch.Tensor):
            state.epsilon = torch.where(do_e, self.decayed_epsilon(state),
                                        state.epsilon)
        elif do_e:
            self.decay_epsilon(state)
        return state
