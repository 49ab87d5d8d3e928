"""The parts of a DQN training tick that every engine shares, in plain
PyTorch: the per-tick keys, the env step under the epsilon-greedy actor,
the TD(0) step with optax's Adam, the schedules, the loop over ticks and
the readings a run is judged by.

A run starts from the seed (:func:`start`) or from a snapshot of a
training run's state (:func:`resume`: the env state, the replay, the
nets, Adam's moments and count, epsilon, the key chain and the step,
in the layout that ``portbench.engines``' ``snapshot`` gives).

``Variant`` sets how the reference computes: ``tf32`` rounds every matmul
operand to TF32's 10-bit mantissa (the precision below the configured
float32, for the control), ``actor_tf32`` rounds only the actor's Q
forward so (the control of the tick kernels' actor), ``half_batch``
trains on the first half of each batch (a fault the comparison must
catch). The default is float32 throughout, TF32 off.
"""

import contextlib
import dataclasses
import importlib
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import env, threefry

B1, B2, EPS = 0.9, 0.999, 1e-8
# A greedy choice whose two best Q-values lie closer than this share of
# the largest |Q| is a near tie: f32 sums in another order may pick either.
NEAR_TIE = 1e-5


@dataclasses.dataclass(frozen=True)
class Variant:
    tf32: bool = False
    actor_tf32: bool = False
    half_batch: bool = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest (ties away) at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with every operand, the backward's too, rounded to TF32,
    each product summed in f32: what a TF32 tensor-core matmul does."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = tf32_round(grad)
        return grad @ b.t(), a.t() @ grad


def matmul_for(variant: Variant):
    return _TF32Matmul.apply if variant.tf32 else torch.matmul


@contextlib.contextmanager
def exact_f32():
    """cuBLAS and cuDNN in true f32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def net_module(flags: dict):
    return importlib.import_module(
        f"portbench.reference.nets.{flags['network_type']}")


def epsilon_decay(flags: dict) -> float:
    """The CLI's rule: epsilon reaches half its range after the half-life
    fraction of ``num_steps``, decaying once every
    ``epsilon_decay_every`` ticks (given ``epsilon_decay``, that)."""
    if flags.get("epsilon_decay") is not None:
        return flags["epsilon_decay"]
    return (1 - 0.5 * (1 - flags["epsilon_end"] / flags["epsilon_start"])) ** (
        1 / (flags["epsilon_decay_half_life_fraction"] * flags["num_steps"]))


class KeyChain:
    """The trainer's host chain: each tick ``split(rng, 3)`` gives the
    next rng, the step key and the sample key."""

    def __init__(self, words):
        self.words = tuple(int(v) & threefry.MASK32 for v in words)

    def next(self, device):
        rng, step, sample = threefry.split_host(*self.words, 3)
        self.words = rng
        return (torch.tensor(step, dtype=torch.int64, device=device),
                torch.tensor(sample, dtype=torch.int64, device=device))


class Learner:
    """Online and target nets, Adam's moments and count, epsilon, the
    schedules and the TD(0) step."""

    def __init__(self, flags: dict, variant: Variant, params, target,
                 mu, nu, count: int, epsilon: torch.Tensor):
        self.net = net_module(flags)
        self.flags, self.variant = flags, variant
        self.matmul = matmul_for(variant)
        self.actor_matmul = matmul_for(
            Variant(tf32=variant.tf32 or variant.actor_tf32))
        self.params, self.target = params, target
        self.initial = ([t.clone() for t in params],
                        [t.clone() for t in target])
        self.mu, self.nu, self.count = mu, nu, count
        self.epsilon = epsilon
        self.decay = epsilon_decay(flags)
        self.first_grads = None

    @classmethod
    def from_seed(cls, key, p: env.Params, flags: dict, device,
                  variant: Variant) -> "Learner":
        net = net_module(flags)
        params = [t.to(device) for t in net.init(key, p.obs_dim, flags)]
        target = [t.to(device) for t in net.init(
            threefry.split(key, 2)[1], p.obs_dim, flags)]
        return cls(flags, variant, params, target,
                   [torch.zeros_like(t) for t in params],
                   [torch.zeros_like(t) for t in params], 0,
                   torch.tensor(flags["epsilon_start"], dtype=torch.float32,
                                device=device))

    @classmethod
    def from_snapshot(cls, snap: dict, flags: dict, device,
                      variant: Variant) -> "Learner":
        own = lambda ts: [t.to(device, copy=True) for t in ts]  # noqa: E731
        return cls(flags, variant, own(snap["params"]), own(snap["target"]),
                   own(snap["mu"]), own(snap["nu"]), int(snap["count"]),
                   snap["epsilon"].to(device, torch.float32, copy=True))

    def q(self, leaves, obs_t):
        return self.net.forward_t(leaves, obs_t, self.matmul, self.flags)

    def act(self, u: torch.Tensor, obs_t: torch.Tensor):
        """Drone 0's action and the others' random ones from the (N + 1,
        E) uniforms: row 0 below epsilon explores with row 1's action,
        else the lowest-index argmax of the Q-values. Returns ``(actions
        (N, E), ties (E,))``, ``ties`` where drone 0 acted greedily on a
        near tie."""
        rand = torch.floor(u[1:] * float(env.NUM_ACTIONS)).to(
            torch.int32).clamp(0, env.NUM_ACTIONS - 1)
        with torch.no_grad():
            q = self.net.forward_t(self.params, obs_t, self.actor_matmul,
                                   self.flags)
        top = q.topk(2, dim=0).values
        explore = u[0] < self.epsilon
        ties = ~explore & (top[0] - top[1] < NEAR_TIE * q.abs().amax(dim=0))
        a0 = torch.where(explore, rand[0],
                         torch.argmax(q, dim=0).to(torch.int32))
        return torch.cat([a0[None], rand[1:]], dim=0), ties

    def train(self, batch: Dict[str, torch.Tensor]) -> float:
        """One TD(0) MSE step with Adam (optax's order) on a feature-major
        batch; returns the loss."""
        if self.variant.half_batch:
            half = batch["actions"].shape[0] // 2
            batch = {k: v[..., :half] for k, v in batch.items()}
        gamma = self.flags["gamma"]
        with torch.no_grad():
            boot = self.q(self.target, batch["next_obs"]).max(dim=0).values
            target = batch["rewards"] + gamma * boot * (1 - batch["dones"])
        leaves = [t.detach().requires_grad_(True) for t in self.params]
        with torch.enable_grad():
            q = self.q(leaves, batch["obs"])
            taken = q.gather(0, batch["actions"].long()[None])[0]
            loss = torch.mean(torch.square(taken - target))
            grads = torch.autograd.grad(loss, leaves)
        if self.first_grads is None:
            self.first_grads = [g.clone() for g in grads]
        self.count += 1
        f = np.float32
        bc1 = float(f(1) - f(B1) ** f(self.count))
        bc2 = float(f(1) - f(B2) ** f(self.count))
        lr = self.flags["learning_rate"]
        with torch.no_grad():
            for i, g in enumerate(grads):
                self.mu[i] = g * (1 - B1) + self.mu[i] * B1
                self.nu[i] = g * g * (1 - B2) + self.nu[i] * B2
                update = (self.mu[i] / bc1) / (
                    torch.sqrt(self.nu[i] / bc2) + EPS)
                self.params[i] = self.params[i] + update * -lr
        return float(loss.detach())

    def schedules(self, step: int) -> None:
        tau = self.flags["tau"]
        if step % self.flags["target_update_interval"] == 0:
            self.target = [p * tau + t * (1.0 - tau)
                           for p, t in zip(self.params, self.target)]
        if step % self.flags["epsilon_decay_every"] == 0:
            self.epsilon = torch.clamp(self.epsilon * self.decay,
                                       min=self.flags["epsilon_end"])


def env_tick(step_key, state: env.State, obs_t, learner: Learner,
             p: env.Params, flags: dict, step: int):
    """Every env one tick under the actor from ``obs_t`` (D, E): the key
    split into the envs' keys, the actor's uniforms and the reset's key;
    the envs reset after the step on every ``reset_env_every``-th tick.
    Returns ``(state, actions (N, E), rewards (E, N), dones (E, N),
    ties (E,))``."""
    e = obs_t.shape[1]
    keys = threefry.split(step_key, e + 2)
    u = threefry.uniform(keys[e], (p.n_drones + 1, e))
    actions, ties = learner.act(u, obs_t)
    state, rewards, dones = env.step(keys[:e], state, actions.t(), p)
    if step % flags["reset_env_every"] == 0:
        state = env.reset_all(keys[e + 1], p, e)
    return state, actions, rewards, dones, ties


def drive(engine, learner: Learner, chain: KeyChain, step: int,
          trained: int, device) -> dict:
    """The engine's ticks from ``step`` until ``trained`` of them have
    trained (``engine.tick(step, step_key, sample_key, learner) ->
    (answers, loss or None, ties)``), then :func:`readings`."""
    ticks, losses, epsilons, ties = [], [], [], []
    with exact_f32():
        while len(losses) < trained:
            step_key, sample_key = chain.next(device)
            answers, loss, tie = engine.tick(step, step_key, sample_key,
                                             learner)
            if loss is not None:
                losses.append(loss)
            learner.schedules(step)
            ties.append(tie)
            epsilons.append(float(learner.epsilon))
            ticks.append({k: v.to("cpu", copy=True)
                          for k, v in answers.items()})
            step += 1
    return readings(learner, ticks, losses, epsilons, ties)


def start(engine_module, flags: dict, seed: int, trained: int, device,
          variant: Variant = Variant()) -> dict:
    """The readings of the engine's first ticks from the seed, until
    ``trained`` have trained."""
    p = env.Params.from_flags(flags)
    key = threefry.prng_key(seed)
    engine = engine_module.Engine.from_seed(flags, p, key.to(device))
    learner = Learner.from_seed(key, p, flags, device, variant)
    return drive(engine, learner, KeyChain(key.tolist()), 0, trained,
                 device)


def resume(engine_module, flags: dict, snap: dict, trained: int, device,
           variant: Variant = Variant()) -> dict:
    """The readings of the engine's ticks from a snapshot of a run's state
    (copied, never changed), until ``trained`` have trained."""
    p = env.Params.from_flags(flags)
    engine = engine_module.Engine.from_snapshot(flags, p, snap, device)
    learner = Learner.from_snapshot(snap["learner"], flags, device, variant)
    return drive(engine, learner, KeyChain(snap["rng"]), int(snap["step"]),
                 trained, device)


def state_from_snapshot(snap: dict, device) -> env.State:
    """The env state of a snapshot (env-major, as :mod:`env` keeps it)."""
    s = snap["state"]
    return env.State(*(s[name].to(device, copy=True)
                       for name in env.State._fields))


def state_answers(s: env.State) -> Dict[str, torch.Tensor]:
    """The env state feature-major (field, env), as the program keeps it."""
    e = s.ground.shape[0]
    return {"ground": s.ground.reshape(e, -1).t(), "air_x": s.air_x.t(),
            "air_y": s.air_y.t(), "carrying": s.carrying.to(torch.int8).t(),
            "charge": s.charge.t()}


def readings(learner: Learner, ticks: List[dict], losses: List[float],
             epsilons: List[float], ties: List[torch.Tensor]) -> dict:
    """What a run is judged by, on the host: each check tick's answers,
    the trained ticks' losses, epsilon after each tick, the first
    gradient, the nets before and after, and each tick's near ties."""
    cpu = lambda ts: [t.detach().float().cpu() for t in ts]  # noqa: E731
    return {"ticks": [{k: v.cpu() for k, v in t.items()} for t in ticks],
            "ties": [t.cpu() for t in ties],
            "losses": losses, "epsilons": epsilons,
            "grads": cpu(learner.first_grads),
            "params": (cpu(learner.initial[0]), cpu(learner.params)),
            "target": (cpu(learner.initial[1]), cpu(learner.target))}
