"""DQN actor-learner (counterpart of ``dronerl_tpu/agents/dqn.py``):
dense Q-networks and the conv family.

Parameters keep flax's layout where the kernels read them: dense layer i
has ``kernel`` (in, out) and ``bias`` (out,), so weights carry across
from the JAX package unchanged (``interop/from_jax.py``) and the fused
tick kernel reads them as they are. The feature-major forward is
``kernelᵀ @ x + bias``. Conv kernels are torch's OIHW (flax's HWIO
transposed); ``ConvQNet`` runs them with ``F.conv2d`` on NCHW input and
flattens in NCHW order, as the JAX package's ``ConvQNet`` does after its
transpose, so its dense weights are the JAX net's. With ``conv_matmul``
the conv layers run as their im2col matrices (``ops/conv2mat.py``), the
same chain the fused tick kernel runs.

The optimizer is Adam written out in optax's ``scale_by_adam`` order;
``torch.optim.Adam`` orders the same math differently.

:meth:`DQN.init_state` given a key draws the JAX package's initial nets
bit for bit: flax's per-parameter keys (``rng.flax_param_key``) and jax's
truncated normal (``rng.truncated_normal``).
"""

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dronerl_tpu_torch import resolve_device, rng
from dronerl_tpu_torch.constants import NUM_ACTIONS
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import conv2mat
from dronerl_tpu_torch.utils.graphs import upload

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def adam_bias_corrections(count: int) -> Tuple[float, float]:
    """optax's bias corrections ``1 - b ** count`` of the Adam step that
    makes the count ``count``, in f32 as optax computes them (numpy f32 on
    the host, so the values are the same wherever they are used)."""
    b1, b2 = np.float32(ADAM_B1), np.float32(ADAM_B2)
    return (float(np.float32(1.0) - b1 ** np.float32(count)),
            float(np.float32(1.0) - b2 ** np.float32(count)))


def all_reduce_mean(tensors: List[torch.Tensor],
                    group) -> List[torch.Tensor]:
    """The mean over ``group``'s ranks of every tensor (f32, one device),
    as one collective: flattened into one contiguous buffer, summed by
    ``all_reduce``, divided by the world size (``lax.pmean``'s psum / n)
    and split back into the tensors' shapes. Counted in
    ``all_reduce_mean.calls``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    all_reduce_mean.calls += 1
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


all_reduce_mean.calls = 0


def _freeze_conv_specs(specs) -> Tuple[Tuple[Tuple[str, int], ...], ...]:
    """Conv layer specs (dicts or item-tuples) as hashable sorted
    item-tuples."""
    if isinstance(specs, dict):
        specs = (specs,)
    return tuple(tuple(sorted(spec.items())) if isinstance(spec, dict)
                 else tuple(spec) for spec in specs)


@dataclass(frozen=True)
class DQNConfig:
    """Static agent hyper-parameters, the JAX package's fields and
    defaults. ``conv_layers`` takes dicts like ``{"out_channels": 8,
    "kernel_size": 3, "stride": 1, "padding": 1}`` and stores them as
    sorted item-tuples (:meth:`conv_specs` reads them back). With
    ``conv_matmul`` a conv net's layers run as im2col matrices, the
    contraction the fused tick kernels' actor runs."""

    hidden_layers: Tuple[int, ...] = (32, 32)
    network_type: str = "dense"  # 'dense' | 'conv'
    conv_layers: Tuple = (
        (("kernel_size", 3), ("out_channels", 8), ("padding", 1),
         ("stride", 1)),
    )
    conv_dense_layers: Tuple[int, ...] = ()
    gamma: float = 0.95
    epsilon_start: float = 1.0
    epsilon_decay: float = 0.999
    epsilon_end: float = 0.01
    epsilon_decay_every: Optional[int] = None
    learning_rate: float = 1e-3
    target_update_interval: int = 5
    tau: float = 1.0  # 1.0 = hard target copy; < 1 = EMA
    conv_matmul: bool = False

    def __post_init__(self):
        object.__setattr__(self, "hidden_layers", tuple(self.hidden_layers))
        object.__setattr__(self, "conv_layers",
                           _freeze_conv_specs(self.conv_layers))
        object.__setattr__(self, "conv_dense_layers",
                           tuple(self.conv_dense_layers))

    def conv_specs(self) -> Tuple[Dict[str, int], ...]:
        return tuple(dict(spec) for spec in self.conv_layers)


def chain_forward_t(chain: List[torch.Tensor],
                    obs_t: torch.Tensor) -> torch.Tensor:
    """The feature-major forward of a matmul chain ``[W0 (in, out), b0
    (out,), W1, b1, ...]``: (in, B) → (out, B), ReLU between layers."""
    x = obs_t
    n = len(chain) // 2
    for idx in range(n):
        x = torch.matmul(chain[2 * idx].t(), x) + chain[2 * idx + 1][:, None]
        if idx < n - 1:
            x = torch.relu(x)
    return x


def chain_forward(chain: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The row-major forward of a matmul chain: (B, in) → (B, out), each
    layer ``x @ W + b`` as flax's Dense computes it."""
    n = len(chain) // 2
    for idx in range(n):
        x = x @ chain[2 * idx] + chain[2 * idx + 1]
        if idx < n - 1:
            x = torch.relu(x)
    return x


@contextlib.contextmanager
def _conv_f32():
    """cuDNN convolutions in f32 (no TF32) inside, as the CPU computes
    them; the process-wide flag is restored on the way out."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


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
        """[kernel_0, bias_0, kernel_1, bias_1, ...]: the port's leaf order
        (Adam moments, target copies) and the net's matmul chain."""
        out = []
        for w, b in zip(self.kernels, self.biases):
            out += [w, b]
        return out

    def init_layers(self):
        """flax's initialisers, one entry a layer: (module name, kernel,
        bias, the kernel's shape in flax's layout, fan-in, variance
        scale): ``he_normal`` (scale 2) on the hidden kernels, ``Dense``'s
        default ``lecun_normal`` (scale 1) on the output kernel."""
        return [(f"Dense_{i}", w, b, tuple(w.shape), w.shape[0],
                 2.0 if i < self.n_layers - 1 else 1.0)
                for i, (w, b) in enumerate(zip(self.kernels, self.biases))]

    def forward_t(self, obs_t: torch.Tensor) -> torch.Tensor:
        """Feature-major forward: (obs_dim, B) → (num_actions, B)."""
        return chain_forward_t(self.flat(), obs_t)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """Row-major forward: (B, obs_dim) → (B, num_actions)."""
        return self.forward_t(obs.reshape(obs.shape[0], -1).t()).t()


class ConvQNet(nn.Module):
    """(Conv + ReLU)* → NCHW flatten → (Dense + ReLU)* → Dense(num_actions):
    the JAX package's ``ConvQNet``. Conv kernels are OIHW, dense kernels
    (in, out); the input is the flattened (H, W, C) observation."""

    def __init__(self, obs_shape, conv_specs, dense_layers: Tuple[int, ...],
                 device=None):
        super().__init__()
        h, w, c = obs_shape
        self.obs_shape = tuple(obs_shape)
        self.convs = []  # (kernel_size, stride, padding) a layer
        kernels, biases = [], []
        for spec in conv_specs:
            k, s, p = spec["kernel_size"], spec.get("stride", 1), spec.get(
                "padding", 0)
            co = spec["out_channels"]
            kernels.append(nn.Parameter(torch.zeros(co, c, k, k,
                                                    device=device)))
            biases.append(nn.Parameter(torch.zeros(co, device=device)))
            self.convs.append((k, s, p))
            h, w = conv2mat.conv_out_hw(h, w, k, s, p)
            c = co
        self.conv_kernels = nn.ParameterList(kernels)
        self.conv_biases = nn.ParameterList(biases)
        widths = (h * w * c, *dense_layers, NUM_ACTIONS)
        self.kernels = nn.ParameterList([
            nn.Parameter(torch.zeros(i, o, device=device))
            for i, o in zip(widths[:-1], widths[1:])])
        self.biases = nn.ParameterList([
            nn.Parameter(torch.zeros(o, device=device)) for o in widths[1:]])

    def flat(self) -> List[torch.Tensor]:
        """[conv_kernel_0, conv_bias_0, ..., kernel_0, bias_0, ...]: the
        port's leaf order."""
        out = []
        for w, b in zip(self.conv_kernels, self.conv_biases):
            out += [w, b]
        for w, b in zip(self.kernels, self.biases):
            out += [w, b]
        return out

    def init_layers(self):
        """As :meth:`DenseQNet.init_layers`: every layer takes its module's
        default ``lecun_normal`` (scale 1); a conv kernel is drawn in
        flax's HWIO shape with fan-in k·k·C_in."""
        out = []
        for i, (w, b) in enumerate(zip(self.conv_kernels, self.conv_biases)):
            co, ci, kh, kw = w.shape
            out.append((f"Conv_{i}", w, b, (kh, kw, ci, co), kh * kw * ci,
                        1.0))
        for i, (w, b) in enumerate(zip(self.kernels, self.biases)):
            out.append((f"Dense_{i}", w, b, tuple(w.shape), w.shape[0], 1.0))
        return out

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """Row-major forward: (B, obs_dim) or (B, H, W, C) → (B,
        num_actions)."""
        x = obs.reshape(obs.shape[0], *self.obs_shape).permute(0, 3, 1, 2)
        with _conv_f32():
            for (_, s, p), w, b in zip(self.convs, self.conv_kernels,
                                       self.conv_biases):
                x = torch.relu(torch.nn.functional.conv2d(
                    x, w, b, stride=s, padding=p))
        x = x.reshape(x.shape[0], -1)
        dense = []
        for w, b in zip(self.kernels, self.biases):
            dense += [w, b]
        return chain_forward(dense, x)


QNet = Union[DenseQNet, ConvQNet]


def build_network(config: DQNConfig, env_params: EnvParams,
                  device=None) -> QNet:
    """The Q-net of ``config`` for ``env_params``' observation, zeros."""
    if env_params.wrapper not in ("window", "global"):
        raise NotImplementedError(f"wrapper={env_params.wrapper!r}")
    h, w, c = env_params.obs_shape
    if config.network_type == "dense":
        return DenseQNet(h * w * c, config.hidden_layers, device)
    if config.network_type == "conv":
        return ConvQNet(env_params.obs_shape, config.conv_specs(),
                        config.conv_dense_layers, device)
    raise ValueError(f"Unsupported network type {config.network_type!r}")


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: step count and per-leaf moments."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class DQNState:
    params: QNet
    target_params: QNet
    opt_state: AdamState
    epsilon: torch.Tensor  # 0-d float32 on the state's device


# The standard deviation of a standard normal truncated to (-2, 2).
TRUNCATED_STD = 0.87962566103423978


def _he_init(net: QNet, generator: torch.Generator) -> None:
    """flax's initialisers (``init_layers``) drawn with torch's truncated
    normal from ``generator``: truncated on ±2σ, σ rescaled by 0.8796,
    zero biases."""
    with torch.no_grad():
        for _, w, b, shape, fan_in, scale in net.init_layers():
            std = float(np.sqrt(scale / fan_in) / TRUNCATED_STD)
            cpu = torch.empty(shape)
            nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            w.copy_(_from_flax_layout(cpu, w))
            b.zero_()


def _from_flax_layout(kernel: torch.Tensor, like: torch.Tensor):
    """A kernel in flax's layout → ``like``'s: HWIO → OIHW for a conv."""
    return kernel.permute(3, 2, 0, 1) if like.dim() == 4 else kernel


def _flax_init(net: QNet, key: torch.Tensor) -> None:
    """The JAX package's ``network.init({"params": key}, ...)`` of its
    ``DenseQNet`` or ``ConvQNet``, bit for bit: each layer is a flax
    module (``Dense_i``, ``Conv_i``) whose kernel takes the module's first
    ``make_rng`` (count 1; the bias, zeros, the second). A kernel is
    ``variance_scaling(scale, "fan_in", "truncated_normal")``, i.e.
    ``truncated_normal(k, -2, 2, shape) * (sqrt(f32(scale / fan_in)) /
    f32(0.8796...))`` in f32, drawn in flax's layout (``init_layers``).
    The draw runs on the CPU and is copied to the net's device."""
    key = key.cpu()
    with torch.no_grad():
        for name, w, b, shape, fan_in, scale in net.init_layers():
            variance = torch.tensor(scale / fan_in, dtype=torch.float32)
            std = torch.sqrt(variance) / torch.tensor(TRUNCATED_STD,
                                                      dtype=torch.float32)
            k = rng.flax_param_key(key, (name, 1))
            w.copy_(_from_flax_layout(
                rng.truncated_normal(k, -2.0, 2.0, shape) * std, w))
            b.zero_()


class DQN:
    """DQN: static topology plus state-transition methods."""

    def __init__(self, config: DQNConfig, env_params: EnvParams,
                 device="cuda"):
        self.config = config
        self.env_params = env_params
        self.device = resolve_device(device)
        h, w, c = env_params.obs_shape
        self.obs_dim = h * w * c
        # The conv layers' im2col lowering (None unless a conv net with
        # conv_matmul): the tick kernels' actor chain
        # (fused_tick.flatten_net_params).
        self.net_spec = (
            conv2mat.net_layer_specs(config, env_params.obs_shape)
            if config.network_type == "conv" and config.conv_matmul
            else None)

    def make_net(self) -> QNet:
        return build_network(self.config, self.env_params, self.device)

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

    def q_values(self, params: QNet, obs: torch.Tensor) -> torch.Tensor:
        """(B, obs_dim) or (B, H, W, C) observations → (B, num_actions):
        the im2col chain row-major (``x @ W + b``) with ``conv_matmul``,
        else the net's row-major forward."""
        x = obs.reshape(obs.shape[0], -1)
        if self.net_spec is not None:
            return chain_forward(
                conv2mat.effective_dense_params(params, self.net_spec), x)
        return params.forward(x)

    def q_values_t(self, params: QNet, obs_t: torch.Tensor) -> torch.Tensor:
        """(obs_dim, B) observations → (num_actions, B). A dense net runs
        feature-major, a conv net with ``conv_matmul`` its im2col chain
        feature-major (``Wᵀx + b``), any other conv net its row-major
        module behind two transposes."""
        if self.config.network_type == "dense":
            return params.forward_t(obs_t)
        if self.net_spec is not None:
            return chain_forward_t(
                conv2mat.effective_dense_params(params, self.net_spec), obs_t)
        return params.forward(obs_t.t()).t()

    def _epsilon_greedy(self, key: torch.Tensor, greedy_actions: torch.Tensor,
                        state: DQNState) -> torch.Tensor:
        batch = greedy_actions.shape[0]
        explore_key, action_key = rng.split(key, 2).to(greedy_actions.device)
        explore = rng.uniform(explore_key, (batch,)) < state.epsilon
        random_acts = rng.randint(action_key, (batch,), 0, NUM_ACTIONS)
        return torch.where(explore, random_acts,
                           greedy_actions.to(torch.int32))

    def act_t(self, key: torch.Tensor, obs_t: torch.Tensor,
              state: DQNState, greedy: bool = False) -> torch.Tensor:
        """ε-greedy actions for (obs_dim, B) observations → (B,) int32.

        Greedy is the lowest-index argmax of :meth:`q_values_t`; with
        ``greedy`` it alone (``key`` unused). Else the key splits into
        explore and action keys: explore where ``uniform(explore_key,
        (B,)) < ε``, with ``randint(action_key, (B,), 0, NUM_ACTIONS)``.
        The draws run where ``obs_t`` lies (B counters each), so a host
        key goes to that device first. A conv net's forward through its
        module (no ``conv_matmul``: cuDNN on a card) is counted in
        ``DQN.act_t.module_forwards``.
        """
        if self.config.network_type != "dense" and self.net_spec is None:
            DQN.act_t.module_forwards += 1
        with torch.no_grad():
            q = self.q_values_t(state.params, obs_t)
        if greedy:
            return torch.argmax(q, dim=0).to(torch.int32)
        return self._epsilon_greedy(key, torch.argmax(q, dim=0), state)

    def act(self, key: torch.Tensor, obs: torch.Tensor,
            state: DQNState, greedy: bool = False) -> torch.Tensor:
        """ε-greedy actions for row-major observations (B, obs_dim) or (B,
        H, W, C) → (B,) int32: greedy on :meth:`q_values`, the draws as
        :meth:`act_t`'s; with ``greedy`` the argmax alone (``key``
        unused)."""
        with torch.no_grad():
            q = self.q_values(state.params, obs)
        if greedy:
            return torch.argmax(q, dim=1).to(torch.int32)
        return self._epsilon_greedy(key, torch.argmax(q, dim=1), state)

    def train_step(
        self, state: DQNState, batch: Dict[str, torch.Tensor], group=None,
        corrections=None,
    ) -> Tuple[DQNState, torch.Tensor]:
        """TD(0) MSE step with Adam on a row-major batch: obs / next_obs (B,
        obs_dim); actions, rewards and dones (B,). Updates the online
        parameters and the moments in place and returns ``(state,
        loss)``; ``group`` and ``corrections`` as :meth:`train_step_t`."""
        return self._td_step(state, batch, self.q_values, 1, group,
                             corrections)

    def train_step_t(
        self, state: DQNState, batch: Dict[str, torch.Tensor], group=None,
        corrections=None,
    ) -> Tuple[DQNState, torch.Tensor]:
        """TD(0) MSE step with Adam on a feature-major batch.

        ``batch``: obs / next_obs (obs_dim, B) float32; actions (B,) int;
        rewards and dones (B,) float32. Updates the online parameters and
        the moments in place and returns ``(state, loss)``. With a process
        ``group`` (the JAX package's ``axis_name``) the gradients and the
        loss are averaged over its ranks before the (replicated) update:
        one all-reduce of one buffer (:func:`all_reduce_mean`).
        ``corrections``: this step's Adam bias corrections as two 0-d f32
        tensors on the state's device (:func:`adam_bias_corrections` of
        the count after the step; a CUDA graph's step reads them from a
        buffer the host fills), else made from the count here.
        """
        return self._td_step(state, batch, self.q_values_t, 0, group,
                             corrections)

    def _td_step(self, state: DQNState, batch: Dict[str, torch.Tensor],
                 q_values, axis: int, group=None,
                 corrections=None) -> Tuple[DQNState, torch.Tensor]:
        """The TD(0) step on Q-values ``q_values(params, obs)`` whose action
        axis is ``axis``: the autograd learner, counted in
        ``DQN._td_step.calls``."""
        DQN._td_step.calls += 1
        cfg = self.config
        params = state.params.flat()
        actions = batch["actions"].long()
        with torch.no_grad():
            next_q = q_values(state.target_params, batch["next_obs"])
            bootstrap = next_q.max(dim=axis).values
            target = batch["rewards"] + cfg.gamma * bootstrap * (
                1 - batch["dones"])
        with torch.enable_grad(), _conv_f32():
            q = q_values(state.params, batch["obs"])
            taken = q.gather(axis, actions.unsqueeze(axis)).squeeze(axis)
            loss = torch.mean(torch.square(taken - target))
            grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if group is not None:
            *grads, loss = all_reduce_mean([*grads, loss], group)

        adam = state.opt_state
        count = adam.count + 1
        if corrections is None:
            corrections = upload(adam_bias_corrections(count), torch.float32,
                                 loss.device)
        bc1, bc2 = corrections[0], corrections[1]
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
        return state, loss

    def should_decay_epsilon(self, step: int, done: torch.Tensor):
        """Decay every N steps if configured, else at episode boundaries."""
        if self.config.epsilon_decay_every is None:
            return done
        return step % self.config.epsilon_decay_every == 0

    def schedule_flags(self, step: int) -> Tuple[bool, Optional[bool]]:
        """The host flags of ``step``'s schedules: ``(target sync, ε
        decay)``, the decay None where it follows the episode's done (no
        ``epsilon_decay_every``)."""
        every = self.config.epsilon_decay_every
        return (step % self.config.target_update_interval == 0,
                None if every is None else step % every == 0)

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

    def apply_schedules(self, state: DQNState, step: Optional[int],
                        done: torch.Tensor, flags=None) -> DQNState:
        """Target sync every ``target_update_interval`` steps (EMA with
        ``tau``, a hard copy at 1.0) and the ε decay, in place; ``flags``
        (:meth:`schedule_flags`) in place of ``step``'s."""
        sync, do_e = flags if flags is not None else self.schedule_flags(
            step)
        if sync:
            self.update_target(state)
        if do_e is None:
            do_e = done
        if isinstance(do_e, torch.Tensor):
            state.epsilon = torch.where(do_e, self.decayed_epsilon(state),
                                        state.epsilon)
        elif do_e:
            self.decay_epsilon(state)
        return state

    # --- persistence -------------------------------------------------------

    def save(self, path: str, state: DQNState) -> None:
        """The online net as a jax-format safetensors checkpoint."""
        from dronerl_tpu_torch.interop import safetensors_io

        safetensors_io.save_jax(path, state.params, self.config,
                                self.env_params)

    def save_as_torch(self, path: str, state: DQNState) -> None:
        """The online net as a torch-format safetensors checkpoint."""
        from dronerl_tpu_torch.interop import safetensors_io

        safetensors_io.save_torch(path, state.params, self.config,
                                  self.env_params)

    @staticmethod
    def restore(path: str, env_params: EnvParams,
                device="cuda") -> Tuple["DQN", QNet]:
        """Load any checkpoint (jax- or torch-format) → (agent, net on
        ``device``); the topology comes from the checkpoint's metadata."""
        from dronerl_tpu_torch.interop import safetensors_io
        from dronerl_tpu_torch.interop.from_jax import qnet_from_flax

        config, params = safetensors_io.load_checkpoint(path)
        agent = DQN(config, env_params, device)
        net = qnet_from_flax(params, agent.device, env_params.obs_shape,
                             config.conv_specs())
        return agent, net

    def state_with_params(self, state: DQNState, params: QNet) -> DQNState:
        """Install loaded params into both the online and the target net
        (copied in place; the Adam moments and ε stay as they are)."""
        with torch.no_grad():
            for net in (state.params, state.target_params):
                torch._foreach_copy_(net.flat(), [
                    p.to(net.flat()[0].device) for p in params.flat()])
        return state


DQN.act_t.module_forwards = 0
DQN._td_step.calls = 0
