"""The learner kernel's plain version against the JAX package's learners.

``learn_tick_fused`` on CPU tensors (``td_adam_plain``, the version the
CUDA kernel is held to on the card) against JAX's ``learn_tick_fused`` in
Pallas interpret mode, from one state carried across by
``interop.from_jax``, over 6 ticks with the flag pattern of
tests/test_learner_kernel.py (learn off at tick 2, sync on even ticks,
decay every third). Tolerances: params, target, mu and nu within rtol
1e-5, atol 1e-6, except where a gradient is a cancellation (|g| <= 1e-5
of the sum of its terms' magnitudes: the two frameworks sum the B terms
in other orders, and Adam's first steps map a tiny g to about ±lr); ε
bitwise; the Adam count equal. Also: ``update_target`` / ``decay_epsilon``
against JAX's, and the CUDA wrapper's argument block and the inputs it
refuses, without a launch (the kernel needs a card:
tests/test_torch_kernel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.agents.dqn import DQN as JDQN, DQNConfig as JConfig
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu.ops.learner_kernel import learn_tick_fused as jlearn
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import from_jax
from dronerl_tpu_torch.ops import _build, learner_kernel

RTOL, ATOL = 1e-5, 1e-6
BATCH = 8


def _agents(hidden, **kw):
    cfg = dict(dict(epsilon_decay=0.99, epsilon_end=0.01,
                    target_update_interval=5, gamma=0.9),
               hidden_layers=hidden, **kw)
    jp, tp = JParams(grid_size=9, n_drones=4), EnvParams(grid_size=9,
                                                         n_drones=4)
    return JDQN(JConfig(**cfg), jp), DQN(DQNConfig(**cfg), tp, device="cpu")


def _batch(obs_dim, seed, bsz=BATCH):
    r = np.random.default_rng(seed)
    return {
        "obs": (r.random((obs_dim, bsz)) < 0.3).astype(np.float32),
        "next_obs": (r.random((obs_dim, bsz)) < 0.3).astype(np.float32),
        "actions": r.integers(0, 5, bsz).astype(np.int32),
        "rewards": r.choice([-1.0, 0.0, 1.0, -0.1], bsz).astype(np.float32),
        "dones": (r.random(bsz) < 0.2).astype(np.float32),
    }


def _flax_leaves(tree):
    layers = tree["params"]
    return [np.asarray(layers[f"Dense_{i}"][k])
            for i in range(len(layers)) for k in ("kernel", "bias")]


def assert_leaves_close(ours, ref, cancelled, tag):
    """rtol 1e-5, atol 1e-6 wherever the gradient is no cancellation;
    returns how many cancelled elements differ beyond that."""
    outliers = 0
    for i, (o, r, c) in enumerate(zip(ours, ref, cancelled)):
        o = o.detach().numpy()
        bad = np.abs(o - r) > ATOL + RTOL * np.abs(r)
        assert not (bad & ~c.numpy()).any(), (
            f"{tag} leaf {i}: {int((bad & ~c.numpy()).sum())} elements "
            f"off, max {np.abs(o - r)[bad].max()}")
        outliers += int(bad.sum())
    return outliers


@pytest.mark.parametrize("hidden", [(16, 16), (128, 64)])
def test_learn_tick_fused_matches_jax(hidden):
    ja, ta = _agents(hidden)
    js = ja.init_state(jax.random.PRNGKey(0))
    ts = from_jax.dqn_state_from_jax(jax.device_get(js))
    outliers = 0
    cancelled = [torch.zeros(p.shape, dtype=torch.bool)
                 for p in ts.params.flat()]
    for t in range(6):
        batch = _batch(ja.obs_dim, 100 + t)
        learn, sync, dec = t != 2, t % 2 == 0, t % 3 == 0
        if learn:  # an element once off by a cancellation stays exempt
            _, grads, scales = learner_kernel.td_gradients(
                from_jax.batch_from_jax(batch), ts.params,
                ts.target_params, ta.config.gamma, with_scales=True)
            cancelled = [c | m for c, m in zip(
                cancelled, learner_kernel.cancellations(grads, scales))]
        js = jlearn({k: jnp.asarray(v) for k, v in batch.items()}, js,
                    jnp.array(learn), jnp.array(sync), jnp.array(dec),
                    ja.config, interpret=True)
        eps_before = ts.epsilon.clone()
        ts, loss = learner_kernel.learn_tick_fused(
            from_jax.batch_from_jax(batch), ts, learn, sync, dec, ta.config)
        assert (float(loss) >= 0) == learn and (learn or float(loss) == -1)
        adam = js.opt_state[0]
        assert ts.opt_state.count == int(adam.count), t
        assert np.float32(ts.epsilon.item()) == np.asarray(js.epsilon), t
        assert torch.equal(ts.epsilon, eps_before) != dec
        for name, ours, ref in (
                ("params", ts.params.flat(), _flax_leaves(js.params)),
                ("target", ts.target_params.flat(),
                 _flax_leaves(js.target_params)),
                ("mu", ts.opt_state.mu, _flax_leaves(adam.mu)),
                ("nu", ts.opt_state.nu, _flax_leaves(adam.nu))):
            outliers += assert_leaves_close(ours, ref, cancelled,
                                            f"t={t} {name}")
    assert ts.opt_state.count == 5
    # Cancellations are rare: a handful of elements at most.
    assert outliers <= 8, outliers


def test_td_adam_plain_tracks_autograd_learner():
    """The plain learner against the port's autograd ``train_step_t``
    (optax's pow bias corrections and (1-b2)·g²) over 4 steps."""
    _, ta = _agents((16, 16))
    s_ref = ta.init_state(torch.Generator().manual_seed(3))
    s_td = ta.init_state(torch.Generator().manual_seed(3))
    for step in range(4):
        batch = from_jax.batch_from_jax(_batch(ta.obs_dim, 20 + step))
        s_ref, ref_loss = ta.train_step_t(s_ref, batch)
        s_td, loss = learner_kernel.learn_tick_fused(
            batch, s_td, True, False, False, ta.config)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for a, b in zip(s_td.params.flat(), s_ref.params.flat()):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=0, atol=1e-5)
    assert s_td.opt_state.count == s_ref.opt_state.count == 4


@pytest.mark.parametrize("tau", [1.0, 0.25])
def test_update_target_and_decay_epsilon(tau):
    ja, ta = _agents((16, 16), tau=tau, epsilon_decay=0.5, epsilon_end=0.3)
    js = ja.init_state(jax.random.PRNGKey(1))
    ts = from_jax.dqn_state_from_jax(jax.device_get(js))
    for step in range(3):
        js = ja.update_target(ja.decay_epsilon(js))
        ts = ta.update_target(ta.decay_epsilon(ts))
        for o, r in zip(ts.target_params.flat(),
                        _flax_leaves(js.target_params)):
            np.testing.assert_array_equal(o.detach().numpy(), r)
        assert np.float32(ts.epsilon.item()) == np.asarray(js.epsilon), step
    assert float(ts.epsilon) == pytest.approx(0.3)
    if tau == 1.0:
        for o, p in zip(ts.target_params.flat(), ts.params.flat()):
            assert torch.equal(o, p)


def test_learner_flags_off_write_nothing():
    """Every flag off: nothing moves and the loss is the -1 sentinel."""
    _, ta = _agents((16,))
    st = ta.init_state(torch.Generator().manual_seed(0))
    before = [t.detach().clone() for t in
              st.params.flat() + st.target_params.flat()
              + st.opt_state.mu + st.opt_state.nu + [st.epsilon]]
    st, loss = learner_kernel.learn_tick_fused(
        from_jax.batch_from_jax(_batch(ta.obs_dim, 0)), st, False, False,
        False, ta.config)
    assert float(loss) == -1.0 and st.opt_state.count == 0
    after = (st.params.flat() + st.target_params.flat() + st.opt_state.mu
             + st.opt_state.nu + [st.epsilon])
    assert all(torch.equal(a, b) for a, b in zip(after, before))


# --- the CUDA wrapper, without a launch ------------------------------------

def _wrapper_inputs(hidden=(16, 16)):
    _, ta = _agents(hidden)
    st = ta.init_state(torch.Generator().manual_seed(0))
    batch = from_jax.batch_from_jax(_batch(ta.obs_dim, 1))
    wide = torch.zeros((ta.obs_dim, 2 * BATCH))  # the gather's layout
    wide[:, :BATCH], wide[:, BATCH:] = batch["obs"], batch["next_obs"]
    batch["obs"], batch["next_obs"] = wide[:, :BATCH], wide[:, BATCH:]
    kw = dict(learn=True, sync_target=True, decay_eps=True,
              epsilon=st.epsilon, gamma=0.9, lr=1e-3, tau=0.25,
              eps_decay=0.99, eps_end=0.01, b1=0.9, b2=0.999, adam_eps=1e-8)
    args = [batch, st.params, st.target_params, st.opt_state.mu,
            st.opt_state.nu, 7]
    return args, kw


def test_learner_args_block():
    """The launch's argument block, filled on host tensors: pointers (the
    batch's column slices read in place through their row stride), the
    flags and the hyperparameters rounded to f32."""
    (batch, params, target, mu, nu, count), kw = _wrapper_inputs()
    block, loss = learner_kernel._learner_args(
        batch, params, target, mu, nu, count, **kw)
    assert block.x == batch["obs"].data_ptr()
    assert block.xn == batch["next_obs"].data_ptr()
    assert block.xn - block.x == 4 * BATCH
    assert (block.x_ld, block.xn_ld) == (2 * BATCH, 2 * BATCH)
    assert block.actions == batch["actions"].data_ptr()
    assert [block.w[i] for i in range(3)] == [
        w.data_ptr() for w in params.kernels]
    assert [block.tb[i] for i in range(3)] == [
        b.data_ptr() for b in target.biases]
    assert block.mw[0] == mu[0].data_ptr() and block.vb[2] == nu[5].data_ptr()
    assert block.w[3] is None
    assert block.loss == loss.data_ptr() and block.eps == kw[
        "epsilon"].data_ptr()
    assert (block.batch, block.count) == (BATCH, 7)
    assert (block.learn, block.sync, block.decay) == (1, 1, 1)
    assert block.one_minus_b1 == np.float32(1 - 0.9)
    assert block.one_minus_b2 == np.float32(1 - 0.999)
    assert block.one_minus_tau == np.float32(0.75)
    assert block.two_over_batch == 0.25 and block.inv_batch == 0.125
    assert block.gamma == np.float32(0.9) and block.lr == np.float32(1e-3)
    kw.update(decay_eps=False, epsilon=None)
    block, _ = learner_kernel._learner_args(
        batch, params, target, mu, nu, count, **kw)
    assert block.eps is None and block.decay == 0


@pytest.mark.parametrize("case", [
    "dtype", "shape", "device", "contiguous", "columns", "actions_dtype",
    "target_widths", "leaves", "batch", "count", "epsilon"])
def test_learner_args_reject(case):
    args, kw = _wrapper_inputs()
    batch, params, target, mu, nu, _ = args
    if case == "dtype":
        mu[1] = mu[1].double()
    elif case == "shape":
        nu[0] = nu[0][:-1]
    elif case == "device":
        batch["rewards"] = batch["rewards"].to("meta")
    elif case == "contiguous":
        mu[0] = mu[0].t().contiguous().t()
    elif case == "columns":
        batch["obs"] = batch["obs"].t().contiguous().t()
    elif case == "actions_dtype":
        batch["actions"] = batch["actions"].long()
    elif case == "target_widths":
        args[2] = DQN(DQNConfig(hidden_layers=(16, 8)),
                      EnvParams(grid_size=9, n_drones=4),
                      device="cpu").make_net()
    elif case == "leaves":
        args[3] = mu[:-2]
    elif case == "batch":
        big = learner_kernel.MAX_BATCH + 1
        batch.update({k: v[..., :1].expand(*v.shape[:-1], big).contiguous()
                      for k, v in batch.items()})
    elif case == "count":
        args[5] = -1
    elif case == "epsilon":
        kw["epsilon"] = None
    with pytest.raises(ValueError):
        learner_kernel._learner_args(*args, **kw)


def test_learner_kernel_limits_and_build_config():
    """Shared memory at the bench batch, the batch limit, and the learner
    library keyed by the net widths alone."""
    assert learner_kernel.smem_bytes((294, 128, 64, 5), 8) == 4 * (
        (294 + 2 * 197) * 9 + 16)
    assert not learner_kernel.kernel_problems((294, 128, 64, 5), 8)
    assert learner_kernel.kernel_problems((294, 128, 64, 5), 200)
    assert learner_kernel.kernel_problems((294, 16, 4), 8)
    source, defines = _build.learner_config((294, 128, 64, 5))
    d = dict(defines)
    assert source == "td_adam.cu" and d["DR_NLAYERS"] == "3"
    assert (d["DR_DIM0"], d["DR_DIM2"], d["DR_DIM4"]) == ("294", "64", "0")
    assert not any(k in d for k in ("DR_GRID", "DR_NDRONES"))
    lib = _build.library_path(_build.learner_config((294, 128, 64, 5)))
    tick = _build.library_path(_build.tick_config(
        EnvParams(grid_size=9, n_drones=4), (294, 128, 64, 5)))
    assert lib.endswith("libtd_adam.so") and tick.endswith("libfull_tick.so")
    assert lib != tick and lib.startswith(_build.BUILD_DIR)
    with pytest.raises(ValueError):
        _build.library_path(("nope.cu", defines))
