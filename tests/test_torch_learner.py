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

import copy

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
    # The Adam count, read by the kernel through a pointer.
    assert block.batch == BATCH and block.count == block.counts.data_ptr()
    assert block.counts.dtype == torch.int32 and block.counts.tolist() == [7]
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
    """One CTA's shared memory, the launch plans, the limits, and the
    learner library keyed by the net widths alone."""
    widths = (294, 128, 64, 5)
    # (128,64) on 16 CTAs: slices of 8, 4 and 1 units; W, target, mu, nu
    # and their biases staged; delta; rows of stride 9: split-K partials
    # in doubles (8 segments x 2 nets x 8 units, fewer than the 2 x 16 x
    # 8 receive slots), activations (2 x 197), own gradients (8 + 4 + 1),
    # the batch.
    staged = 4 * ((294 * 8 + 8) + (128 * 4 + 4) + (64 + 4))
    rows = 2 * 256 + 2 * 197 + (8 + 4 + 1) + 2 * 294
    assert learner_kernel.smem_bytes(widths, 8) == 4 * (
        staged + 256 + rows * 9)
    assert learner_kernel.smem_bytes(widths, 8, staged=False) == (
        4 * (staged + 256 + (rows - 2 * 294) * 9))
    assert learner_kernel.smem_bytes(widths, 8, params_staged=False) == (
        4 * (256 + rows * 9))
    # In tiles: a double accumulator for each own kernel and bias element.
    acc = 2 * (295 * 8 + 129 * 4 + 65 * 1) + 2
    assert learner_kernel.smem_bytes(widths, 43, False, True) == 4 * (
        staged + acc + 256 + (rows - 2 * 294) * 43)
    plan = learner_kernel.batch_plan
    assert plan(widths, 8) == (8, True, True,
                               learner_kernel.smem_bytes(widths, 8))
    # Batch 256 in six tiles of 43 columns (ceil(256 / 6)); (16,16) reads
    # the whole batch from device memory, (512,) its params too.
    assert plan(widths, 256)[:3] == (43, False, True)
    assert plan((294, 16, 16, 5), 256)[:3] == (256, False, True)
    assert plan((294, 512, 5), 8)[:3] == (8, True, False)
    assert plan((294, 512, 5), 256)[:3] == (11, False, False)
    for bsz in (1, 49, 50, 84, 256):
        assert not learner_kernel.kernel_problems(widths, bsz)
    assert learner_kernel.kernel_problems(widths, 257)
    assert learner_kernel.kernel_problems((294, 16, 4), 8)
    assert "shared memory" in learner_kernel.kernel_problems(
        (294, 2048, 5), 256)[0]
    source, defines = _build.learner_config(widths)
    d = dict(defines)
    assert source == "td_adam.cu" and d["DR_NLAYERS"] == "3"
    assert (d["DR_DIM0"], d["DR_DIM2"], d["DR_DIM4"]) == ("294", "64", "0")
    assert not any(k in d for k in ("DR_GRID", "DR_NDRONES"))
    lib = _build.library_path(_build.learner_config(widths))
    tick = _build.library_path(_build.tick_config(
        EnvParams(grid_size=9, n_drones=4), widths))
    assert lib.endswith("libtd_adam.so") and tick.endswith("libfull_tick.so")
    assert lib != tick and lib.startswith(_build.BUILD_DIR)
    with pytest.raises(ValueError):
        _build.library_path(("nope.cu", defines))


@pytest.mark.parametrize("hidden", [
    (16, 16), (128, 64), (8,), (32, 16), (100,), (256,), (512,), (768,),
    (1024,), (256, 256), (512, 512)])
def test_learner_kernel_takes_the_one_block_limits(hidden):
    """Every batch that the one-block learner kernel took (the batch and
    every layer's activation and gradient rows at stride B | 1 in one
    block's shared memory) the cluster kernel takes too, and one hidden
    layer of up to 1,024 units or two of up to 512 take every batch of
    1..256."""
    widths = (294, *hidden, 5)
    every_batch = max(hidden) <= (1024 if len(hidden) == 1 else 512)
    for bsz in range(1, learner_kernel.MAX_BATCH + 1):
        one_block = 4 * ((294 + 2 * sum(widths[1:])) * (bsz | 1)
                         + 2 * bsz) <= learner_kernel.MAX_SMEM_BYTES
        if one_block or every_batch:
            assert not learner_kernel.kernel_problems(widths, bsz), bsz


@pytest.mark.parametrize("width", [1, 3, 5, 8, 16, 17, 32, 48, 63, 64, 65,
                                   100, 128, 256, 294, 512])
def test_cluster_split_owns_every_unit_once(width):
    """Every output unit of a layer has exactly one owning CTA, the slices
    are contiguous and in rank order, at most one unit apart (or equal
    16-byte slices where 4 x CLUSTER divides the width), and the 5
    actions go one to a CTA."""
    cluster = learner_kernel.CLUSTER
    split = learner_kernel.cluster_split(width)
    assert len(split) == cluster
    owners = np.zeros(width, dtype=int)
    for lo, hi in split:
        owners[lo:hi] += 1
    assert (owners == 1).all()
    assert split[0][0] == 0 and split[-1][1] == width
    assert all(a[1] == b[0] for a, b in zip(split, split[1:]))
    sizes = [hi - lo for lo, hi in split]
    if width % (4 * cluster) == 0:
        assert len(set(sizes)) == 1 and sizes[0] % 4 == 0
        assert all(lo % 4 == 0 for lo, _ in split)
    else:
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(
            sizes, reverse=True)
    if width == 5:
        assert sizes[:5] == [1] * 5


@pytest.mark.parametrize("bsz", [1, 8])
def test_loss_slack_bounds_a_q_perturbation(bsz):
    """``loss_slack(q_rel)`` bounds the change of the TD loss when the
    online and the target Q-values move by a relative ``q_rel`` in either
    direction (the output layers scaled), to first order."""
    _, ta = _agents((16, 16))
    st = ta.init_state(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(ta.obs_dim, 5,
                                                       bsz).items()}
    q_rel = 1e-3
    slack = learner_kernel.loss_slack(batch, st.params, st.target_params,
                                      0.9, q_rel)
    loss0, _ = learner_kernel.td_gradients(batch, st.params,
                                           st.target_params, 0.9)
    assert slack > 0
    for online, target in ((1 + q_rel, 1 - q_rel), (1 - q_rel, 1 + q_rel)):
        nets = []
        for net, f in ((st.params, online), (st.target_params, target)):
            net = copy.deepcopy(net)
            with torch.no_grad():
                net.kernels[-1].mul_(f)
                net.biases[-1].mul_(f)
            nets.append(net)
        loss1, _ = learner_kernel.td_gradients(batch, *nets, 0.9)
        assert abs(float(loss1) - float(loss0)) <= 1.01 * slack + 1e-5
