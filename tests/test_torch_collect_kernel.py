"""The tick kernels' wrappers and builds with ``collect`` > 1 and the
fast-RNG round counts: the ``-D`` sets, the argument blocks and what the
wrappers refuse, on the host; on a card, B1, B3 and B4 against their
plain versions.

No JAX here, as tests/test_torch_kernel.py: the ``gpu`` tests run on a
machine with a card by

    python -m pytest tests/test_torch_collect_kernel.py -q --noconftest

and skip without one.
"""

import pytest
import torch

from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.ops import _build, fused_tick

E = 128
CHARGE_ATOL = 1.3e-7
KW = dict(grid_size=9, n_drones=4)
WIDTHS = (294, 16, 16, 5)


def test_build_defines_collect_and_rounds():
    """k and the round counts are defines only where they are not 1 / 20:
    the default build keeps its set; each choice is a library of its
    own."""
    tp = EnvParams(**KW)
    base = _build.tick_defines(tp, WIDTHS)
    assert _build.tick_defines(tp, WIDTHS, 1, 20, None) == base
    assert _build.tick_defines(tp, WIDTHS, 1, 20, 20) == base
    assert _build.env_defines(tp, 1, 20) == _build.env_defines(tp)
    assert not any(k in dict(base) for k in (
        "DR_COLLECT", "DR_RNG_ROUNDS", "DR_ACTOR_ROUNDS"))
    cases = {(4, 20, None): {"DR_COLLECT": "4"},
             (1, 20, 8): {"DR_ACTOR_ROUNDS": "8"},
             (1, 8, None): {"DR_RNG_ROUNDS": "8"},
             (1, 8, 8): {"DR_RNG_ROUNDS": "8"},
             (2, 8, 12): {"DR_COLLECT": "2", "DR_RNG_ROUNDS": "8",
                          "DR_ACTOR_ROUNDS": "12"}}
    for (k, rr, ar), extra in cases.items():
        d = dict(_build.tick_defines(tp, WIDTHS, k, rr, ar))
        assert {key: d.pop(key) for key in extra} == extra
        assert d == dict(base)
    env = dict(_build.env_defines(tp, 2, 8))
    assert (env.pop("DR_COLLECT"), env.pop("DR_RNG_ROUNDS")) == ("2", "8")
    assert env == dict(_build.env_defines(tp))
    paths = {_build.library_path(_build.tick_config(tp, WIDTHS, *c))
             for c in cases} | {_build.library_path(
                 _build.tick_config(tp, WIDTHS))}
    assert len(paths) == len(cases)  # (1, 8, 8) is (1, 8, None)


def _inputs(k, dtype=torch.bfloat16, device="cpu", num_envs=E, wrapper=
            "window", hidden=(16, 16)):
    tp = EnvParams(wrapper=wrapper, **KW)
    st = DQN(DQNConfig(hidden_layers=hidden), tp, device=device).init_state(
        torch.Generator().manual_seed(0))
    state = core.reset_batch(rng.PRNGKey(0).to(device), tp, num_envs)
    obs = core.observe_batch(state, tp, k).reshape(num_envs, -1).t()
    ring = torch.zeros((obs.shape[0], 2 * num_envs), dtype=dtype,
                       device=device)
    ring[:, :num_envs] = obs.to(dtype)
    return tp, st.params.flat(), fused_tick.to_tstate(state), ring, obs


def test_kernel_args_blocks_collect():
    """B1, B3 and B4's blocks take k row groups of observations and
    refuse another row count, k outside [1, n_drones] and round counts
    the JAX kernels do not take."""
    tp, chain, ts, ring, obs = _inputs(4)
    eps, key = torch.tensor(0.5), rng.PRNGKey(2)
    block, _ = fused_tick._kernel_args(key, ts, ring, 0, E, chain, eps,
                                       False, tp, collect=4, rng_rounds=8,
                                       actor_rng_rounds=None)
    assert block.obs_in == block.obs_out == ring.data_ptr()
    assert (block.in_ld, block.out_ld) == (2 * E, 2 * E)
    obs = obs.contiguous()
    _, outs = fused_tick._full_args(key, ts, obs, chain, eps, False, tp,
                                    collect=4)
    assert outs[4].shape == obs.shape == (4 * 294, E)
    actions = torch.zeros((4, E), dtype=torch.int32)
    _, outs = fused_tick._env_tick_args(key, ts, actions, tp, 3, 8)
    assert tuple(outs[3].shape) == (3 * 294, E)
    for kw, match in ((dict(collect=2), "obs_in"),
                      (dict(collect=5), "collect=5"),
                      (dict(collect=4, rng_rounds=6), "rng_rounds=6"),
                      (dict(collect=4, actor_rng_rounds=0),
                       "actor_rng_rounds=0")):
        with pytest.raises(ValueError, match=match):
            fused_tick._kernel_args(key, ts, ring, 0, E, chain, eps, False,
                                    tp, **kw)
    with pytest.raises(ValueError, match="rng_rounds=24"):
        fused_tick._env_tick_args(key, ts, actions, tp, 1, 24)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _near_tie(q, rel=1e-5):
    top2 = q.topk(2, dim=0).values
    return (top2[0] - top2[1]) <= rel * q.abs().amax(dim=0)


def _assert_obs(a, b):
    a = a.float().reshape(-1, 6, a.shape[-1])
    b = b.float().reshape(-1, 6, b.shape[-1])
    ch = torch.arange(6, device=a.device) != 4
    assert torch.equal(a[:, ch], b[:, ch])
    assert float((a[:, 4] - b[:, 4]).abs().max()) <= CHARGE_ATOL


MODES = [(20, None), (20, 8), (8, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("num_envs", [E, 100])
@pytest.mark.parametrize("rounds", MODES, ids=["off", "actor", "full"])
@pytest.mark.parametrize("wrapper,k", [("window", 4), ("global", 2)])
def test_collect_kernels_match_plain_on_card(wrapper, k, rounds, num_envs):
    """B1 (bf16 ring), B3 and B4 with k drones collected and the round
    counts against their plain versions, 3 ticks with a reset at tick 1,
    ε = 0.5: env outputs and every row group bitwise (charge within
    1.3e-7), actions equal outside near ties."""
    dev = _card()
    tp, chain, ts0, ring, obs = _inputs(k, device=dev, num_envs=num_envs,
                                        wrapper=wrapper)
    kw = dict(collect=k, rng_rounds=rounds[0], actor_rng_rounds=rounds[1])
    eps = torch.tensor(0.5, device=dev)
    for launch in ("ring", "full", "tick"):
        ts, o, r = ts0, obs.contiguous(), ring.clone()
        key = rng.PRNGKey(3)
        for t in range(3):
            key, step_key = rng.split(key, 2)
            if launch == "ring":
                read, write = (t % 2) * num_envs, ((t + 1) % 2) * num_envs
                rp = r.clone()
                out = fused_tick.full_tick_fused_ring(
                    step_key, ts, r, read, write, chain, eps, t == 1, tp,
                    **kw)
                ref = fused_tick.full_tick_ring_plain(
                    step_key, ts, rp, read, write, chain, eps, t == 1, tp,
                    actions_override=out[3], **kw)
                _assert_obs(r, rp)
                obs_in = rp
            elif launch == "full":
                read, obs_in = 0, o
                out = fused_tick.full_tick_fused(step_key, ts, o, chain, eps,
                                                 t == 1, tp, **kw)
                ref = fused_tick.full_tick_plain(
                    step_key, ts, o, chain, eps, t == 1, tp,
                    actions_override=out[3], **kw)
                _assert_obs(out[4], ref[4])
                o = out[4]
            else:
                actions = rng.randint(step_key.to(dev), (4, num_envs), 0, 5)
                out = fused_tick.tick_fused(step_key, ts, actions, tp, k,
                                            rounds[0])
                ref = fused_tick.tick_plain(step_key, ts, actions, tp, k,
                                            rounds[0])
                _assert_obs(out[3], ref[3])
            for a, b in zip(out[0] + out[1:3], ref[0] + ref[1:3]):
                assert torch.equal(a, b), (launch, t)
            if launch != "tick":
                keys = rng.split(step_key.to(dev), num_envs + 2, rounds[0])
                act, q = fused_tick.plain_actions(
                    keys[num_envs], obs_in, read, chain, eps, tp, num_envs,
                    fused_tick.actor_rounds(*rounds))
                differ = (act != out[3]).any(dim=0)
                assert not bool((differ & ~_near_tie(q)).any()), (launch, t)
            ts = out[0]
