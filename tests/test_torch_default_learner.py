"""The engines' default TD step on the learner kernel (``train.
learner_route``, ``train.kernel_train_step``), on the CPU.

The route: the kernel takes the step of a dense net on a CUDA card with
no process group, at the batches and widths ``learner_kernel.
kernel_problems`` accepts; a conv net, a group, the CPU, batch 512 and
widths whose slices do not fit a CTA's shared memory stay on autograd,
each with its reason.

The kernel's function: ``kernel_train_step`` (on CPU tensors
``td_adam_plain``) against JAX's ``DQN.train_step_t`` (optax's Adam) over
ten successive batches from one state, both drawn with numpy from a seed,
at dense (16,16) and (128,64), batch 8, the batch gathered from k = 1 and
k = 2 row groups: the loss within rtol 1e-5; params, mu and nu within rtol
1e-5, atol 1e-6 except where ``learner_kernel.cancellations`` marks a
gradient (once marked, an element stays exempt).

The trainers: the ring, full and jnp engines' chunks with the route forced
to the kernel (here alone: ``learner_problems`` patched to find nothing,
so ``td_adam`` runs its plain version on the CPU) against the autograd
route from one carry, ε pinned at 1 so that no Q-value steers an action:
the kernel step taken on every trained tick, rewards and ε bitwise, the
loss within rtol 1e-5, params within atol 1e-5, the Adam count equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu_torch import replay, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import learner_kernel

RTOL, ATOL = 1e-5, 1e-6
BATCH = 8
KW = dict(grid_size=9, n_drones=4)


def _agent(**kw):
    return DQN(DQNConfig(**kw), EnvParams(**KW), device="cpu")


@pytest.mark.parametrize("case,kw,batch,group,device,reason", [
    ("dense", dict(hidden_layers=(16, 16)), BATCH, None, "cuda", None),
    ("dense128x64", dict(hidden_layers=(128, 64)), 256, None, "cuda", None),
    ("conv", dict(network_type="conv"), BATCH, None, "cuda", "conv network"),
    ("conv_matmul", dict(network_type="conv", conv_matmul=True), BATCH, None,
     "cuda", "conv network"),
    ("group", dict(hidden_layers=(16, 16)), BATCH, object(), "cuda",
     "process group"),
    ("cpu", dict(hidden_layers=(16, 16)), BATCH, None, "cpu", "cpu device"),
    ("batch512", dict(hidden_layers=(16, 16)), 512, None, "cuda",
     "batch 512"),
    ("wide", dict(hidden_layers=(2048,)), BATCH, None, "cuda",
     "shared memory"),
])
def test_learner_route(case, kw, batch, group, device, reason):
    agent = _agent(**kw)
    problems = train.learner_problems(agent, batch, group, device)
    if reason is None:
        assert problems == []
    else:
        assert len(problems) == 1 and reason in problems[0], problems
    # On this CPU every tick's route is autograd, with its reasons.
    route = train.learner_route(agent, batch, group)
    assert route.startswith(train.AUTOGRAD) and "cpu device" in route


def _row_group_batch(obs_dim: int, k: int, seed: int):
    """A batch of BATCH columns as the ring sample gathers it from k row
    groups (each drone's BATCH // k columns side by side), obs and
    next_obs column slices of one (obs_dim, 2 BATCH) array."""
    r = np.random.default_rng(seed)
    cols = BATCH // k
    groups = (r.random((2, k, obs_dim, cols)) < 0.3).astype(np.float32)
    both = np.concatenate([np.concatenate(list(g), axis=1) for g in groups],
                          axis=1)
    return both, {
        "actions": r.integers(0, 5, BATCH).astype(np.int32),
        "rewards": r.choice([-1.0, 0.0, 1.0, -0.1], BATCH).astype(
            np.float32),
        "dones": (r.random(BATCH) < 0.2).astype(np.float32),
    }


def _flax_leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][key])
            for i in range(len(layers)) for key in ("kernel", "bias")]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("hidden", [(16, 16), (128, 64)])
def test_kernel_step_matches_jax_train_step_t(hidden, k):
    cfg = dict(hidden_layers=hidden, gamma=0.9, learning_rate=1e-3)
    ja = JDQN(JConfig(**cfg), JParams(**KW))
    ta = _agent(**cfg)
    r = np.random.default_rng(7)
    js = ja.init_state(jax.random.PRNGKey(0))
    widths = (ta.obs_dim, *hidden, 5)

    def net():
        return {"params": {f"Dense_{i}": {
            "kernel": jnp.asarray(r.normal(0, 1 / np.sqrt(i_w), (i_w, o_w)),
                                  jnp.float32),
            "bias": jnp.asarray(r.normal(0, 0.05, (o_w,)), jnp.float32)}
            for i, (i_w, o_w) in enumerate(zip(widths[:-1], widths[1:]))}}

    params = net()
    js = js.replace(params=params, target_params=net(),
                    opt_state=ja.optimizer.init(params))
    ts = from_jax.dqn_state_from_jax(jax.device_get(js))
    step = jax.jit(ja.train_step_t)
    cancelled = [torch.zeros(p.shape, dtype=torch.bool)
                 for p in ts.params.flat()]
    for t in range(10):
        both, rest = _row_group_batch(ta.obs_dim, k, 100 + t)
        jbatch = {"obs": both[:, :BATCH], "next_obs": both[:, BATCH:],
                  **rest}
        tboth = torch.from_numpy(both)
        batch = {"obs": tboth[:, :BATCH], "next_obs": tboth[:, BATCH:],
                 **{key: torch.from_numpy(v) for key, v in rest.items()}}
        _, grads, scales = learner_kernel.td_gradients(
            batch, ts.params, ts.target_params, ta.config.gamma,
            with_scales=True)
        cancelled = [c | m for c, m in zip(
            cancelled, learner_kernel.cancellations(grads, scales))]
        js, jloss = step(js, {key: jnp.asarray(v)
                              for key, v in jbatch.items()})
        count = ts.opt_state.count
        ts, loss = train.kernel_train_step(ta, ts, batch, count)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
        adam = js.opt_state[0]
        assert ts.opt_state.count == int(adam.count) == count + 1
        for name, ours, ref in (
                ("params", ts.params.flat(), _flax_leaves(js.params)),
                ("mu", ts.opt_state.mu, _flax_leaves(adam.mu)),
                ("nu", ts.opt_state.nu, _flax_leaves(adam.nu))):
            for i, (o, want, c) in enumerate(zip(ours, ref, cancelled)):
                o = o.detach().numpy()
                bad = np.abs(o - want) > ATOL + RTOL * np.abs(want)
                assert not (bad & ~c.numpy()).any(), (
                    f"t={t} {name} leaf {i}: {int((bad & ~c.numpy()).sum())}"
                    f" elements off, max {np.abs(o - want)[bad].max()}")
    # The target net is the learner's input alone: untouched.
    for a, b in zip(ts.target_params.flat(), _flax_leaves(js.target_params)):
        assert np.array_equal(a.detach().numpy(), b)


E = 128
TICKS = 12


def _engine(engine: str, agent: DQN):
    """``engine``'s tick and initial carry at a small size, a reset every
    5 ticks."""
    tp = agent.env_params
    if engine == "ring":
        cap = 2 * E
        return (train.build_train_step_ring(agent, tp, E, cap, BATCH, 5),
                train.init_ring_carry(agent, tp, E, cap, rng.PRNGKey(0)))
    if engine == "full":
        buf = replay.StreamReplay(3 * E, BATCH, stride=E)
        return (train.build_train_step_full(agent, buf, tp, E, 5),
                train.init_stream_carry(agent, tp, E, buf, rng.PRNGKey(0)))
    buf = replay.ReplayBuffer(64, BATCH, uniform_pushes=True)
    return (train.build_train_step(agent, buf, tp, 4, 5),
            train.init_jnp_carry(agent, tp, 4, buf, rng.PRNGKey(0)))


@pytest.mark.parametrize("engine", ["ring", "full", "jnp"])
def test_kernel_route_trainer_matches_autograd(engine, monkeypatch):
    cfg = dict(hidden_layers=(16, 16), epsilon_start=1.0, epsilon_end=1.0,
               epsilon_decay_every=2, target_update_interval=3, gamma=0.9)
    ref_tick, ref_carry = _engine(engine, _agent(**cfg))
    assert ref_tick.learner.startswith(train.AUTOGRAD)
    monkeypatch.setattr(train, "learner_problems", lambda *a, **kw: [])
    steps = []
    kernel_step = train.kernel_train_step

    def counted(*args):
        steps.append(args[3])
        return kernel_step(*args)

    monkeypatch.setattr(train, "kernel_train_step", counted)
    tick, carry = _engine(engine, _agent(**cfg))
    assert tick.learner == train.KERNEL
    carry, (rewards, eps, loss) = train.Chunk(tick)(carry, TICKS)
    ref_carry, (ref_rewards, ref_eps, ref_loss) = train.Chunk(ref_tick)(
        ref_carry, TICKS)
    trained = ref_loss >= 0
    assert int(trained.sum()) == len(steps) > TICKS // 2
    # The count each step read from its row: the trained ticks before it.
    assert [int(c) for c in steps] == list(range(len(steps)))
    assert torch.equal(rewards, ref_rewards) and torch.equal(eps, ref_eps)
    assert torch.equal(loss < 0, ~trained)
    np.testing.assert_allclose(loss.numpy(), ref_loss.numpy(), rtol=1e-5)
    assert carry[3].opt_state.count == ref_carry[3].opt_state.count
    for a, b in zip(carry[3].params.flat(), ref_carry[3].params.flat()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-5)
