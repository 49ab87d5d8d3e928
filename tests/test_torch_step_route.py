"""The jnp engine's env step and observation as one launch of the step
kernel (B5 with its observation, ``train.step_route``), on the CPU.

The kernel's function: ``step_kernel.step_batch_fused`` with ``collect``
on CPU tensors runs its plain version (``step_batch_plain``: the port's
``core.step_batch`` and ``observe_batch``), held bitwise to JAX's
``vmap(core.step)(split(step_key, E))`` and ``core.observe_batch`` over 3
ticks of actions drawn with numpy (episode ends among them), at 1, 7 and
64 envs, window and global, collecting 1 and 4 drones, the step key as
int64 words and as a chunk row's int32 words. JAX's plain core, not its
Pallas kernel in interpret mode, keeps the file short.

The route: ``step_problems`` accepts a CUDA device (passed by argument)
at any env count from 1, and names each limit it refuses (the CPU, the
observation's 256 cells and 32 drones, fewer packets than drones,
``collect_drones`` beyond the drones, no env); ``step_kernel.
kernel_problems`` stays the JAX package's gate, 8 envs included.

The trainer: the jnp engine's chunk with the route forced to the kernel
(``step_problems`` patched to find nothing, so that the wrapper runs its
plain version here) against the plain route from one carry: one
wrapper call a tick, every output and carry tensor bitwise; the CLI logs
and returns its route.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu.env import core as jcore
from dronerl_tpu.env.types import EnvParams as JParams
from dronerl_tpu_torch import replay, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.interop import from_jax, train_state_io
from dronerl_tpu_torch.ops import step_kernel

FIELDS = ("ground", "air_x", "air_y", "carrying_package", "charge")
KW = dict(grid_size=9, n_drones=4)
TICKS = 3


ENVS = (1, 7, 64)


def _row_state(states) -> EnvState:
    return EnvState(*(from_jax.tensor(np.asarray(getattr(states, f)))
                      for f in FIELDS))


def _words(r) -> np.ndarray:
    return r.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_ticks(wrapper: str, k: int):
    """JAX's TICKS ticks at every count of ENVS: {E: [(state, step key
    words, actions, (state', rewards, dones, obs)), ...]}. The counts run
    as one vmap over their envs side by side (each env's step is its own,
    so env e of count E steps with row e of split(step_key_E, E), as a
    vmap over E envs alone steps it), which compiles JAX's ops once rather
    than for each count."""
    jp = JParams(**KW, wrapper=wrapper)
    r = np.random.default_rng(10 * k + len(wrapper))
    states = jcore.reset_batch(jnp.asarray(_words(r)), jp, sum(ENVS))
    step = jax.vmap(jcore.step, in_axes=(0, 0, 0, None))
    offsets = np.cumsum((0,) + ENVS)
    ticks = {num_envs: [] for num_envs in ENVS}
    for _ in range(TICKS):
        words = [_words(r) for _ in ENVS]
        actions = r.integers(0, 5, (sum(ENVS), jp.n_drones)).astype(np.int32)
        keys = jnp.concatenate([jax.random.split(jnp.asarray(w), num_envs)
                                for w, num_envs in zip(words, ENVS)])
        out = step(keys, states, jnp.asarray(actions), jp)
        obs = jcore.observe_batch(out[0], jp, k)
        for i, num_envs in enumerate(ENVS):
            part = functools.partial(
                jax.tree.map, lambda x, a=offsets[i], b=offsets[i + 1]:
                np.asarray(x[a:b]))
            ticks[num_envs].append((
                part(states), words[i], actions[offsets[i]:offsets[i + 1]],
                (*part(out), part(obs).reshape(num_envs, k, -1))))
        states = out[0]
    return ticks


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("wrapper", ["window", "global"])
@pytest.mark.parametrize("num_envs", ENVS)
def test_step_with_observation_matches_jax(num_envs, wrapper, k):
    tp = EnvParams(**KW, wrapper=wrapper)
    ticks = _jax_ticks(wrapper, k)[num_envs]
    tstates = _row_state(ticks[0][0])
    ends = 0
    for t, (_, words, actions, (jst, jrew, jdone, jobs)) in enumerate(ticks):
        # The int64 words of a host key, or a chunk row's int32 words.
        key = (torch.from_numpy(words.astype(np.int64)) if t % 2 == 0
               else torch.from_numpy(words.view(np.int32).copy()))
        tst, trew, tdone, tobs = step_kernel.step_batch_fused(
            key, tstates, torch.from_numpy(actions), tp, k)
        for f in FIELDS:
            assert np.array_equal(getattr(jst, f),
                                  getattr(tst, f).numpy()), (t, f)
        assert np.array_equal(jrew, trew.numpy()), t
        assert np.array_equal(jdone, tdone.numpy()), t
        assert tobs.shape == (num_envs, k, int(np.prod(tp.obs_shape)))
        assert tobs.dtype == torch.float32
        assert np.array_equal(jobs, tobs.numpy()), t
        ends += int(jdone.sum())
        tstates = tst
    if num_envs == 64:  # crashes end episodes within a few random ticks
        assert ends > 0


@pytest.mark.parametrize("case,kw,num_envs,k,device,reason", [
    ("card", KW, 1, 1, "cuda", None),
    ("card7", KW, 7, 4, "cuda", None),
    ("global", dict(KW, wrapper="global"), 64, 2, "cuda", None),
    ("cpu", KW, 1, 1, "cpu", "cpu device"),
    ("cells", dict(grid_size=17, n_drones=4), 1, 1, "cuda",
     "289 cells > 256"),
    ("drones", dict(grid_size=16, n_drones=33), 1, 1, "cuda",
     "n_drones=33 > 32"),
    ("packets", dict(KW, packets_factor=0), 1, 1, "cuda",
     "num_packets < n_drones"),
    ("collect", KW, 1, 5, "cuda", "collect_drones=5"),
    ("envs", KW, 0, 1, "cuda", "num_envs=0 < 1"),
])
def test_step_route(case, kw, num_envs, k, device, reason):
    tp = EnvParams(**kw)
    problems = train.step_problems(tp, num_envs, k, device)
    if reason is None:
        assert problems == [] and train.step_route(
            tp, num_envs, k, device) == train.KERNEL
    else:
        assert len(problems) == 1 and reason in problems[0], problems
        route = train.step_route(tp, num_envs, k, device)
        assert route.startswith(train.PLAIN) and reason in route
    # The JAX package's gate keeps its 8 envs.
    if case in ("card", "card7"):
        assert not step_kernel.supports(tp, num_envs)
        assert step_kernel.supports(tp, 8)


def _jnp_engine(num_envs: int, k: int):
    tp = EnvParams(**KW)
    agent = DQN(DQNConfig(hidden_layers=(16, 16), epsilon_decay_every=2,
                          target_update_interval=3, gamma=0.9), tp,
                device="cpu")
    buf = replay.ReplayBuffer(16 * num_envs * k, 8, uniform_pushes=True)
    return (train.build_train_step(agent, buf, tp, num_envs, 5,
                                   collect_drones=k),
            train.init_jnp_carry(agent, tp, num_envs, buf, rng.PRNGKey(0),
                                 collect_drones=k))


@pytest.mark.parametrize("num_envs,k", [(1, 1), (4, 2)])
def test_kernel_route_jnp_chunk_matches_plain(num_envs, k, monkeypatch):
    ref_tick, ref_carry = _jnp_engine(num_envs, k)
    assert ref_tick.env_step.startswith(train.PLAIN)
    monkeypatch.setattr(train, "step_problems", lambda *a, **kw: [])
    calls = []
    fused = step_kernel.step_batch_fused

    def counted(key, *args):
        calls.append(key.dtype)
        return fused(key, *args)

    monkeypatch.setattr(step_kernel, "step_batch_fused", counted)
    tick, carry = _jnp_engine(num_envs, k)
    assert tick.env_step == train.KERNEL
    ticks = 12
    carry, outs = train.Chunk(tick)(carry, ticks)
    ref_carry, ref_outs = train.Chunk(ref_tick)(ref_carry, ticks)
    # One call a tick, the step key read as the row's int32 words.
    assert calls == [torch.int32] * ticks
    for name, a, b in zip(("rewards", "epsilon", "loss"), outs, ref_outs):
        assert torch.equal(a, b), name
    assert bool((outs[2] >= 0).any())
    got, want = (train_state_io.leaves(c) for c in (carry, ref_carry))
    assert got[1] == want[1] and set(got[0]) == set(want[0])
    for path, t in want[0].items():
        assert torch.equal(got[0][path], t), path


def test_cli_records_the_route(tmp_path):
    metrics = train.main(["--device", "cpu", "--num_envs", "2",
                          "--num_steps", "3", "--skip_final_eval",
                          "--run_dir", str(tmp_path)])
    assert metrics["engine"] == "jnp"
    assert metrics["env_step"].startswith(train.PLAIN)
    assert "cpu device" in metrics["env_step"]
