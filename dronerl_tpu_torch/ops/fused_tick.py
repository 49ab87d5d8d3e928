"""The training tick's env side: one kernel launch per tick.

Counterpart of ``dronerl_tpu/ops/fused_tick.py``, with its two kernels
and three launches:

* :func:`full_tick_fused_ring` (B1, the ring engine): per-env threefry
  keys, the ε-greedy actor (a matmul chain: a dense net's layers or a
  conv net's im2col lowering, :func:`flatten_net_params`) reading the
  replay ring at ``read_slot``, the physics, respawns and observation
  (the window, or with ``wrapper="global"`` the whole board), the
  periodic reset, and the write of the next observation into the ring at
  ``write_slot`` (in place; other slots keep their contents). With
  ``td_hparams`` (the in-kernel TD path) a second launch on the same
  stream, the learner kernel of ``ops/learner_kernel.py``, runs the TD(0)
  + Adam step that the TPU kernel runs on its grid step 0.
* :func:`full_tick_fused` (B3, the full engine): the same kernel with the
  observation read from ``obs_t`` (obs_dim, E) f32 and the next one
  written into a new array; or, given a ``replay.StreamReplay``'s storage
  and the push's start slot, the tick's transitions pushed into the
  replay by the same launch and the next observation written over
  ``obs_t``.
* :func:`tick_fused` (B4, the fused engine): the physics, respawns and
  observation with actions from the caller; no actor, no reset.

State is feature-major (field, env): ground (C, E) int8, drone fields
(N, E). On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/full_tick.cu`` for B1 and B3, ``csrc/env_kernel.cu`` for B4, both
one warp per env on ``csrc/env_warp.cuh``); on CPU tensors it runs its
plain version
(:func:`full_tick_ring_plain`, :func:`full_tick_plain`,
:func:`tick_plain`), the same function in plain PyTorch.

Key contract (as ``dronerl_tpu/ops/fused_tick.py``'s docstring): with
``S = split(step_key, E + 2)``, env e steps with key ``S[e]``, the actor
draws its (N+1, E) uniform field from ``S[E]`` (row 0 gates exploration,
rows 1..N are random actions ``floor(u * NUM_ACTIONS)``), and the
periodic reset is ``core.reset_batch(S[E+1], params, E)``. :func:`tick_fused`
steps env e with row e of ``split(step_key, E)``, which is ``S[e]``.

With ``collect`` = k (``collect_drones``) the next observation is the
first k drones' observations stacked as row groups, drone-major: (k ·
obs_dim, E), where the actor reads rows ``[0, obs_dim)``, drone 0's. With
``rng_rounds`` < 20 (the fast-RNG mode, ``--fast_rng``) every in-kernel
hash of the env side (the per-env keys and splits, the spawn fields, the
reset chain) runs that many threefry rounds, and ``actor_rng_rounds`` (by
default ``rng_rounds``) those of the actor's uniform field, as the JAX
kernels' arguments of those names do.

The observation's charge channel (``charge / 100``) may differ from the
JAX package by 1 ULP, where XLA turns the divide into a reciprocal
multiply; every other output is bit-identical.
"""

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from dronerl_tpu_torch import replay as replay_mod
from dronerl_tpu_torch import rng
from dronerl_tpu_torch.agents.dqn import DenseQNet, QNet, chain_forward_t
from dronerl_tpu_torch.constants import NUM_ACTIONS, NUM_OBS_CHANNELS
from dronerl_tpu_torch.env import core
from dronerl_tpu_torch.env.types import EnvParams, EnvState
from dronerl_tpu_torch.ops import _build, conv2mat, draws, learner_kernel
from dronerl_tpu_torch.ops.learner_kernel import check_tensor
from dronerl_tpu_torch.utils.graphs import upload

# Limits of the CUDA kernel (csrc/full_tick.cu), as the JAX package's
# fused_tick.supports() states them for the TPU kernel.
MAX_CELLS = 256
MAX_DRONES = 32
MAX_LAYERS = _build.MAX_LAYERS
# The JAX kernel's cap on the actor's weight chain: half its raised VMEM
# limit of 100 MiB (dronerl_tpu/ops/fused_tick.py _net_weight_vmem_budget).
CHAIN_BUDGET = 100 * 1024 * 1024 // 2
# A block's shared memory on the H100 (csrc/full_tick.cu, Layout).
SMEM_LIMIT = 232448


class TState(NamedTuple):
    """EnvState in feature-major layout (leading axis = field)."""

    ground: torch.Tensor    # (C, E) int8
    air_x: torch.Tensor     # (N, E) int32
    air_y: torch.Tensor     # (N, E) int32
    carrying: torch.Tensor  # (N, E) int8
    charge: torch.Tensor    # (N, E) float32


def to_tstate(state: EnvState) -> TState:
    num_envs = state.ground.shape[0]
    return TState(
        ground=state.ground.reshape(num_envs, -1).t().contiguous(),
        air_x=state.air_x.t().contiguous(),
        air_y=state.air_y.t().contiguous(),
        carrying=state.carrying_package.to(torch.int8).t().contiguous(),
        charge=state.charge.t().contiguous(),
    )


def from_tstate(tstate: TState, params: EnvParams) -> EnvState:
    g = params.grid_size
    num_envs = tstate.ground.shape[1]
    return EnvState(
        ground=tstate.ground.t().reshape(num_envs, g, g),
        air_x=tstate.air_x.t(),
        air_y=tstate.air_y.t(),
        carrying_package=tstate.carrying.t() != 0,
        charge=tstate.charge.t(),
    )


def obs_rows(params: EnvParams) -> int:
    """Rows of one observation (the flattened window)."""
    h, w, _ = params.obs_shape
    return h * w * NUM_OBS_CHANNELS


def actor_rounds(rng_rounds: int, actor_rng_rounds: Optional[int]) -> int:
    """The actor's round count: ``actor_rng_rounds``, else ``rng_rounds``."""
    return rng_rounds if actor_rng_rounds is None else actor_rng_rounds


def tick_problems(params: EnvParams, collect: int, rng_rounds: int,
                  actor_rng_rounds: Optional[int] = None) -> List[str]:
    """What the tick kernels do not take of the drones collected and the
    round counts (the JAX kernels' own ranges)."""
    problems = []
    if not 1 <= collect <= params.n_drones:
        problems.append(f"collect={collect} outside [1, n_drones="
                        f"{params.n_drones}]")
    for name, r in (("rng_rounds", rng_rounds),
                    ("actor_rng_rounds", actor_rounds(rng_rounds,
                                                      actor_rng_rounds))):
        if r not in rng.ROUNDS:
            problems.append(f"{name}={r} (a multiple of 4 in [4, 20])")
    return problems


def chain_widths(chain: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    """(in, hidden..., out) of a matmul chain ``[W0, b0, W1, b1, ...]``."""
    return (chain[0].shape[0], *(w.shape[1] for w in chain[0::2]))


def chain_problems(widths: Sequence[int]) -> List[str]:
    """The JAX kernel's guard on the actor's weight chain (f32 weights and
    biases over :data:`CHAIN_BUDGET`), in its words."""
    weight_bytes = 4 * sum(i * o + o for i, o in zip(widths, widths[1:]))
    if weight_bytes <= CHAIN_BUDGET:
        return []
    return [f"conv_matmul weight chain is {weight_bytes / 2**20:.1f} MB "
            f"(f32) > {CHAIN_BUDGET / 2**20:.0f} MB in-kernel budget: the "
            "im2col matrices for this conv config are too large for the "
            "tick kernel's actor; use the fused engine without "
            "--conv_matmul (conv actor outside the kernel) instead"]


def kernel_problems(params: EnvParams, num_envs: int,
                    widths: Optional[Sequence[int]] = None) -> list:
    """What the CUDA tick kernels (B1, B3, B4) do not take in this
    configuration; with the actor chain's ``widths`` (B1, B3), also what
    they do not take of it."""
    problems = []
    if params.wrapper not in ("window", "global"):
        problems.append(f"wrapper={params.wrapper!r} (window or global)")
    if params.num_cells > MAX_CELLS:
        problems.append(f"{params.num_cells} cells > {MAX_CELLS}")
    if params.n_drones > MAX_DRONES:
        problems.append(f"n_drones={params.n_drones} > {MAX_DRONES}")
    if params.num_packets < params.n_drones:
        problems.append("num_packets < n_drones")
    if widths is not None:
        if len(widths) - 1 > MAX_LAYERS:
            problems.append(f"{len(widths) - 1} layers > {MAX_LAYERS}")
        problems += chain_problems(widths)
    if num_envs < 1:
        problems.append("num_envs < 1")
    return problems


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def tick_layout(params: EnvParams, widths: Sequence[int],
                obs_bf16: bool) -> Dict[str, object]:
    """The full tick kernel's block for an env, the actor chain's
    ``widths`` and the observation type, as ``Layout`` in
    ``csrc/full_tick.cu`` computes it: ``smem_bytes`` of dynamic shared
    memory and ``variant``, the first that fits a block's shared memory
    of "shared" (everything in it), "device" (the hidden activations in a
    scratch of ``scratch_bytes`` a block in device memory) and
    "device_obs" (the observation read from and written to device memory
    too). Blocks of 64 envs; a tensor-core layer runs its output n-tiles
    of 8 in passes of up to 16 (4 a warp) and stages its weights k-chunk
    by k-chunk; the first layer's activations replace the observation
    tile where it runs in one pass."""
    eb, frag_bytes, pass_tiles = 64, 3 * 64 * 4, 4 * 4
    n_layers = len(widths) - 1
    mma_layers = 1 if n_layers == 1 else n_layers - 1

    def n_tiles(layer):  # (all n-tiles, n-tiles a pass)
        nt = _up16(widths[layer + 1]) // 8
        return nt, min(nt, pass_tiles)

    def chunk(layer, budget):
        ksteps = _up16(widths[layer]) // 16
        return min(ksteps, max(1, budget // (n_tiles(layer)[1] * frag_bytes)))

    def act_bytes(parity):
        return max([_up16(eb * (widths[layer + 1] + 4) * 4)
                    for layer in range(parity, mma_layers, 2)], default=0)

    stride, size = (72, 2) if obs_bf16 else (68, 4)
    obs_bytes = _up16(obs_rows(params)) * stride * size
    budget = 24576 if obs_bf16 else 12288
    w_bytes = max(chunk(layer, budget) * n_tiles(layer)[1] * frag_bytes
                  for layer in range(mma_layers))
    n, c = params.n_drones, params.num_cells
    tail = (w_bytes + _up16(c * eb) + 5 * n * eb * 4 + 14 * eb * 4
            + 2 * _up16(n * eb) + _up16(eb) + 32)
    acts = act_bytes(0) + act_bytes(1)
    nt0, ntp0 = n_tiles(0)
    shared = (max(obs_bytes, acts) if nt0 == ntp0 else obs_bytes + acts) + tail
    if shared <= SMEM_LIMIT:
        return {"smem_bytes": shared, "variant": "shared", "scratch_bytes": 0}
    if obs_bytes + tail <= SMEM_LIMIT:
        return {"smem_bytes": obs_bytes + tail, "variant": "device",
                "scratch_bytes": acts}
    return {"smem_bytes": tail, "variant": "device_obs",
            "scratch_bytes": acts}


def flatten_net_params(net: QNet, net_spec=None) -> List[torch.Tensor]:
    """A Q-net → the tick kernels' actor chain ``[W0, b0, W1, b1, ...]``
    (``dronerl_tpu/ops/fused_tick.py::_flatten_net_params``): a dense net's
    own parameters, or with a conv ``net_spec`` (``DQN.net_spec``) the
    im2col lowering of ``ops/conv2mat.py``, checked against the JAX
    kernel's budget before it is built."""
    if net_spec is None:
        return net.flat()
    widths = [net_spec[0][1] * net_spec[0][2] * net_spec[0][3]]
    dense_i = 0
    for spec in net_spec:
        if spec[0] == "conv":
            _, h, w, _, co, k, s, p, _ = spec
            ho, wo = conv2mat.conv_out_hw(h, w, k, s, p)
            widths.append(ho * wo * co)
        else:
            widths.append(net.kernels[dense_i].shape[1])
            dense_i += 1
    problems = chain_problems(widths)
    if problems:
        raise ValueError(problems[0])
    return conv2mat.effective_dense_params(net, net_spec)


# --- plain version ---------------------------------------------------------

@rng.plain_draws()
def actor_uniforms(actor_key: torch.Tensor, n: int, num_envs: int,
                   rounds: int = 20):
    """(N+1, E) uniforms from the actor key (Threefry-2x32-``rounds``):
    row 0 gates exploration, rows 1..N give random actions. Returns (u,
    random_actions (N, E))."""
    u_act = rng.uniform(actor_key, (n + 1, num_envs), rounds)
    rand = torch.floor(u_act[1:] * float(NUM_ACTIONS)).to(torch.int32)
    return u_act, rand.clamp(0, NUM_ACTIONS - 1)


@rng.plain_draws()
def plain_actions(actor_key: torch.Tensor, obs_ring: torch.Tensor,
                  read_slot: int, chain: Sequence[torch.Tensor],
                  epsilon: torch.Tensor, params: EnvParams, num_envs: int,
                  rounds: int = 20):
    """The ε-greedy actor of the plain version: ``(actions (N, E) int32,
    q (A, E))``. Greedy is the lowest-index argmax of the Q forward of the
    actor ``chain`` on drone 0's rows of the ring's observations at
    ``read_slot``, cast to f32; the uniforms at ``rounds``."""
    u_act, rand = actor_uniforms(actor_key, params.n_drones, num_envs,
                                 rounds)
    with torch.no_grad():
        obs_t = obs_ring[:obs_rows(params), read_slot:read_slot + num_envs]
        q = chain_forward_t(chain, obs_t.to(torch.float32))
    greedy = torch.argmax(q, dim=0).to(torch.int32)  # first max wins
    a0 = torch.where(u_act[0] < epsilon, rand[0], greedy)
    return torch.cat([a0[None], rand[1:]], dim=0), q


# --- plain mirrors of the full tick kernel's two mechanisms ------------------
# Nothing on the card's path calls these: the CPU tests hold them against
# jax.lax.top_k and the f32 forward, so that the kernel's choices of key
# and operand split are checked where the kernel cannot run.

def packed_pick_order(u23: torch.Tensor, valid: torch.Tensor,
                      k: int) -> torch.Tensor:
    """The spawn picks of ``csrc/env_warp.cuh`` (``pick_next``): ``k``
    rounds over (B, C) 23-bit uniforms ``u23`` and a (B, C) bool candidate
    mask, C <= 512. Each round takes the largest packed key of the
    untaken candidates, or, when none is left, the lowest untaken cell.
    Up to 256 cells the key is ``2**31 | u << 8 | (255 - c)`` and 0 means
    no candidate is left; above, it is ``u << 9 | (511 - c)``, where 0 is
    a real key (u = 0 at cell 511), so a round has a candidate while its
    index is below the candidates' count. Returns (B, k) int64 cells,
    which are ``top_k(where(valid, u, -inf), k)``'s indices."""
    b, c = u23.shape
    idx = torch.arange(c, device=u23.device)
    zero = torch.zeros((), dtype=torch.int64, device=u23.device)
    if c <= 256:
        key = torch.where(valid, (1 << 31) | (u23.long() << 8) | (255 - idx),
                          zero)
    else:
        key = torch.where(valid, (u23.long() << 9) | (511 - idx), zero)
        n_valid = valid.sum(dim=1)
    taken = torch.zeros((b, c), dtype=torch.bool, device=u23.device)
    rows = torch.arange(b, device=u23.device)
    cells = []
    for s in range(k):
        best = torch.where(taken, 0, key).amax(dim=1)
        lowest = torch.where(taken, c, idx).amin(dim=1)
        if c <= 256:
            cell = torch.where(best > 0, 255 - (best & 255), lowest)
        else:
            cell = torch.where(s < n_valid, 511 - (best & 511), lowest)
        taken[rows, cell] = True
        cells.append(cell)
    return torch.stack(cells, dim=1)


def bf16_pieces(x: torch.Tensor):
    """``x`` f32 as three bf16 pieces (hi, mid, lo, each returned as the
    f32 it is, rounded to nearest even as ``__float2bfloat16_rn``): their
    sum keeps 24 significant bits, the differences are exact in f32."""
    p1 = x.to(torch.bfloat16).float()
    r = x - p1
    p2 = r.to(torch.bfloat16).float()
    return p1, p2, (r - p2).to(torch.bfloat16).float()


_EXACT_TERMS = ((0, 2), (0, 1), (0, 0))
_SPLIT_TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _split_product(x: torch.Tensor, w: torch.Tensor, exact_x: bool):
    """``x @ w`` as the tensor-core loop sums it: bf16 pieces of ``w`` (and
    of ``x`` unless it is exact in bf16), each product exact in f32, the
    terms of order <= 2**-16 added in f32, smallest first."""
    ws = bf16_pieces(w)
    xs = (x,) if exact_x else bf16_pieces(x)
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i, j in (_EXACT_TERMS if exact_x else _SPLIT_TERMS):
        out = out + xs[i] @ ws[j]
    return out


def split_forward_t(chain: Sequence[torch.Tensor], obs_t: torch.Tensor,
                    exact_obs: bool) -> torch.Tensor:
    """The full tick kernel's Q forward in plain PyTorch: (obs_dim, E) →
    (num_actions, E). Every layer but the last (all of a one-layer net)
    runs as the tensor-core loop does, on bf16 pieces summed in f32: W's
    three pieces times the observation where it is exact in bf16
    (``exact_obs``, the bf16 ring), else the six products of the two
    three-piece splits (B3's f32 observations, the hidden activations).
    The output layer is f32."""
    n = len(chain) // 2
    h = obs_t.float().t()
    for idx, (w, b) in enumerate(zip(chain[0::2], chain[1::2])):
        w, b = w.detach().float(), b.detach().float()
        if idx < max(n - 1, 1):
            h = _split_product(h, w, exact_obs and idx == 0) + b
        else:
            h = h @ w + b
        if idx < n - 1:
            h = torch.relu(h)
    return h.t()


def _env_tick_plain(env_keys, tstate: TState, actions: torch.Tensor,
                    reset_key: Optional[torch.Tensor], params: EnvParams,
                    collect: int = 1, rounds: int = 20):
    """``core.step_batch`` of every env with its key (E, 2) and actions
    (N, E); then, with ``reset_key``, ``core.reset_batch``; then the first
    ``collect`` drones' observations, drone-major; every draw at
    ``rounds``. Returns ``(tstate', rewards (N, E), dones (N, E) bool,
    obs (collect · obs_dim, E) f32)``."""
    num_envs = tstate.ground.shape[1]
    state = from_tstate(tstate, params)
    stepped, rewards, dones = core.step_batch(
        env_keys, state, actions.t(), params, rounds)
    if reset_key is not None:
        stepped = core.reset_batch(reset_key, params, num_envs, rounds)
    obs = core.observe_batch(stepped, params, collect).reshape(
        num_envs, collect * obs_rows(params)).t()
    return (to_tstate(stepped), rewards.t().contiguous(),
            dones.t().contiguous(), obs)


def _plain_tick_actions(keys, obs, read_slot, chain, epsilon, params,
                        actions_override, rounds):
    num_envs = keys.shape[0] - 2
    if actions_override is not None:
        return actions_override.to(device=obs.device, dtype=torch.int32)
    return plain_actions(keys[num_envs], obs, read_slot, chain,
                         epsilon, params, num_envs, rounds)[0]


@rng.plain_draws()
def full_tick_ring_plain(
    step_key: torch.Tensor,
    tstate: TState,
    obs_ring: torch.Tensor,
    read_slot: int,
    write_slot: int,
    chain: Sequence[torch.Tensor],
    epsilon: torch.Tensor,
    do_reset: bool,
    params: EnvParams,
    actions_override: Optional[torch.Tensor] = None,
    collect: int = 1,
    rng_rounds: int = 20,
    actor_rng_rounds: Optional[int] = None,
):
    """The ring launch's function in plain PyTorch, on any device.

    ``actions_override`` (N, E) replaces the actor's actions (the env
    side is then checked bitwise against the kernel's, independently of
    near-tie Q-values). Writes the ring (collect · obs_dim rows) in place;
    returns ``(tstate', rewards (N, E), dones (N, E) bool, actions (N, E)
    int32, obs_ring)``.
    """
    num_envs = tstate.ground.shape[1]
    keys = rng.split(step_key.to(tstate.ground.device), num_envs + 2,
                     rng_rounds)
    actions = _plain_tick_actions(
        keys, obs_ring, read_slot, chain, epsilon, params, actions_override,
        actor_rounds(rng_rounds, actor_rng_rounds))
    tstate, rewards, dones, obs = _env_tick_plain(
        keys[:num_envs], tstate, actions,
        keys[num_envs + 1] if do_reset else None, params, collect,
        rng_rounds)
    obs_ring[:obs.shape[0], write_slot:write_slot + num_envs] = obs.to(
        obs_ring.dtype)
    return tstate, rewards, dones, actions.contiguous(), obs_ring


@rng.plain_draws()
def full_tick_plain(
    step_key: torch.Tensor,
    tstate: TState,
    obs_t: torch.Tensor,
    chain: Sequence[torch.Tensor],
    epsilon: torch.Tensor,
    do_reset: bool,
    params: EnvParams,
    actions_override: Optional[torch.Tensor] = None,
    collect: int = 1,
    rng_rounds: int = 20,
    actor_rng_rounds: Optional[int] = None,
    replay=None,
):
    """:func:`full_tick_fused`'s function in plain PyTorch, on any device
    (``actions_override`` as in :func:`full_tick_ring_plain`). Returns
    ``(tstate', rewards (N, E), dones (N, E) bool, actions (N, E) int32,
    obs_t' (collect · obs_dim, E) f32)``; without ``replay`` ``obs_t`` is
    not written. With ``replay = (storage, start)`` the tick's transitions
    (:func:`replay.stream_push_batch`) are pushed into the StreamReplay's
    ``storage`` at ``start`` (``replay.push_many_t``) and ``obs_t'`` is
    ``obs_t``, overwritten."""
    num_envs = tstate.ground.shape[1]
    keys = rng.split(step_key.to(tstate.ground.device), num_envs + 2,
                     rng_rounds)
    actions = _plain_tick_actions(
        keys, obs_t, 0, chain, epsilon, params, actions_override,
        actor_rounds(rng_rounds, actor_rng_rounds))
    tstate, rewards, dones, obs = _env_tick_plain(
        keys[:num_envs], tstate, actions,
        keys[num_envs + 1] if do_reset else None, params, collect,
        rng_rounds)
    actions = actions.contiguous()
    if replay is None:
        return tstate, rewards, dones, actions, obs.contiguous()
    storage, start = replay
    replay_mod.push_many_t(
        replay_mod.ReplayState(storage, 0, 0),
        replay_mod.stream_push_batch(obs_t, actions, rewards, dones,
                                     collect),
        storage["obs"].shape[-1], start=start)
    obs_t.copy_(obs)
    return tstate, rewards, dones, actions, obs_t


@rng.plain_draws()
def tick_plain(step_key: torch.Tensor, tstate: TState,
               actions_t: torch.Tensor, params: EnvParams, collect: int = 1,
               rng_rounds: int = 20):
    """:func:`tick_fused`'s function in plain PyTorch, on any device:
    ``core.step_batch`` with row e of ``split(step_key, E)`` for env e and
    ``observe_batch``, feature-major. Returns ``(tstate', rewards (N, E),
    dones (N, E) bool, obs_t' (collect · obs_dim, E) f32)``."""
    num_envs = tstate.ground.shape[1]
    keys = rng.split(step_key.to(tstate.ground.device), num_envs, rng_rounds)
    actions = actions_t.to(device=tstate.ground.device, dtype=torch.int32)
    tstate, rewards, dones, obs = _env_tick_plain(
        keys, tstate, actions, None, params, collect, rng_rounds)
    return tstate, rewards, dones, obs.contiguous()


# --- the kernels' wrappers ---------------------------------------------------

_STATE_FIELDS = ("ground_in", "ax_in", "ay_in", "carry_in", "charge_in")
_OUT_FIELDS = ("ground_out", "ax_out", "ay_out", "carry_out", "charge_out")
_REWARD_FIELDS = [("pickup_reward", ctypes.c_float),
                  ("delivery_reward", ctypes.c_float),
                  ("crash_reward", ctypes.c_float),
                  ("charge_reward", ctypes.c_float)]


class _TickArgs(ctypes.Structure):
    """Mirror of ``TickArgs`` in csrc/full_tick.cu (field order matters)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "obs_in", "obs_out", *_STATE_FIELDS, "eps", "key", *_OUT_FIELDS,
        "rewards", "dones", "actions", "scratch", "push_obs",
        "push_actions", "push_rewards", "push_dones", "push_start")] + [
        ("w", ctypes.c_void_p * MAX_LAYERS),
        ("b", ctypes.c_void_p * MAX_LAYERS),
        ("in_ld", ctypes.c_longlong),
        ("read_col", ctypes.c_longlong),
        ("out_ld", ctypes.c_longlong),
        ("write_col", ctypes.c_longlong),
        ("push_ld", ctypes.c_longlong),
        ("num_envs", ctypes.c_int),
        ("obs_bf16", ctypes.c_int),
        ("do_reset", ctypes.c_int),
    ] + _REWARD_FIELDS


class EnvArgs(ctypes.Structure):
    """Mirror of ``EnvArgs`` in csrc/env_kernel.cu, the block of both its
    launches: B4 here and B5 in ``ops/step_kernel.py``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        *_STATE_FIELDS, "actions", *_OUT_FIELDS, "rewards", "dones",
        "obs_out", "key")] + [
        ("num_envs", ctypes.c_int),
    ] + _REWARD_FIELDS


def kernel_config(params: EnvParams, chain: Sequence[torch.Tensor],
                  collect: int = 1, rng_rounds: int = 20,
                  actor_rng_rounds: Optional[int] = None):
    """The full tick kernel's library (B1 and B3) for the actor ``chain``,
    the drones collected and the round counts: source and compile-time
    configuration (see ops/_build.py)."""
    return _build.tick_config(params, chain_widths(chain), collect,
                              rng_rounds, actor_rng_rounds)


def kernel_occupancy(config, obs_bf16: bool) -> Tuple[int, int, int]:
    """The full tick kernel's dynamic shared memory in bytes, its
    resident blocks per SM on the current card and its device-memory
    scratch in bytes a block (0: the activations stay in shared memory),
    for the library ``config`` (``kernel_config``) with bf16 (B1 on a bf16
    ring) or f32 observations."""
    lib = _build.load(config)
    names = ("full_tick_smem_bytes", "full_tick_blocks_per_sm",
             "full_tick_scratch_bytes")
    for name in names:
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    return tuple(getattr(lib, name)(int(obs_bf16)) for name in names)


def env_block_shape(config) -> Dict[str, int]:
    """The env kernel's block (B4 and B5) for the library ``config``
    (``_build.env_config``): envs and threads a block, dynamic shared
    memory in bytes, and resident blocks an SM on the current card of the
    feature-major tick (-1 where the env is beyond the tick's limits) and
    of the row-major step."""
    lib = _build.load(config)
    lib.env_block_shape.argtypes = [ctypes.c_void_p]
    lib.env_block_shape.restype = None
    out = (ctypes.c_int * 5)()
    lib.env_block_shape(out)
    return dict(zip(("envs", "threads", "smem_bytes", "tick_blocks_per_sm",
                     "step_blocks_per_sm"), out))


def prepare_kernel(params: EnvParams,
                   chain: Optional[Sequence[torch.Tensor]] = None,
                   in_kernel_td: bool = False, env_tick: bool = False,
                   collect: int = 1, rng_rounds: int = 20,
                   actor_rng_rounds: Optional[int] = None):
    """Build (or load) the CUDA kernels for this configuration before the
    first tick, so that the builds stay out of any timed region: the full
    tick kernel for the actor ``chain``, with ``in_kernel_td`` the learner
    kernel for it too (a dense net's chain), with ``env_tick`` the env
    tick kernel (B4); each for the drones collected and the round
    counts."""
    configs = []
    if chain is not None:
        configs.append(kernel_config(params, chain, collect, rng_rounds,
                                     actor_rng_rounds))
    if in_kernel_td:
        configs.append(_build.learner_config(chain_widths(chain)))
    if env_tick:
        configs.append(_build.env_config(params, collect, rng_rounds))
    _build.build(configs)
    return [_build.load(c) for c in configs]


def _check_state(tstate: TState, params: EnvParams, widths=None,
                 collect: int = 1, rng_rounds: int = 20,
                 actor_rng_rounds: Optional[int] = None):
    """Check a tick's state against the kernels' limits (with the actor
    chain's ``widths``, against the tick kernel's), the drones collected
    and the round counts; returns (device, num_envs)."""
    device = tstate.ground.device
    num_envs = tstate.ground.shape[1]
    problems = kernel_problems(params, num_envs, widths) + tick_problems(
        params, collect, rng_rounds, actor_rng_rounds)
    if problems:
        raise ValueError("the CUDA tick kernel does not take this "
                         "configuration: " + "; ".join(problems))
    check_tensor(tstate.ground, "ground", torch.int8,
                 (params.num_cells, num_envs), device)
    for name, t, dt in (("air_x", tstate.air_x, torch.int32),
                        ("air_y", tstate.air_y, torch.int32),
                        ("carrying", tstate.carrying, torch.int8),
                        ("charge", tstate.charge, torch.float32)):
        check_tensor(t, name, dt, (params.n_drones, num_envs), device)
    return device, num_envs


def _host_key_words(step_key) -> List[int]:
    """A host key (2,) as its two uint32 words."""
    if step_key.device.type != "cpu" or tuple(step_key.shape) != (2,):
        raise ValueError("step_key must be a host key of shape (2,)")
    return [int(v) & rng.MASK32 for v in step_key.tolist()]


def key_words(step_key: torch.Tensor, device) -> torch.Tensor:
    """``step_key`` (2,) as the int32 (2,) tensor on ``device`` whose two
    words the full tick kernel reads through ``TickArgs.key``. A key on
    ``device`` stays there: an int32 one is its own words, an int64 one
    (``rng``'s keys) is narrowed by a device op, so a CUDA graph holds no
    host value. A host key is copied over (an eager caller's)."""
    device = torch.device(device)
    if tuple(step_key.shape) != (2,):
        raise ValueError("step_key must be a key of shape (2,)")
    if step_key.device == device:
        if step_key.dtype == torch.int32 and step_key.is_contiguous():
            return step_key
        return step_key.to(torch.int32)
    words = [w - (1 << 32) if w >= 1 << 31 else w
             for w in _host_key_words(step_key)]
    return upload(words, torch.int32, device)


def _fill_env(a, tstate: TState, params: EnvParams):
    """Outputs of the env side and the block's state and reward fields.
    Returns ``(tstate', rewards, dones)``."""
    device = tstate.ground.device
    n, num_envs = tstate.air_x.shape
    out = TState(*(torch.empty_like(t) for t in tstate))
    rewards = torch.empty((n, num_envs), dtype=torch.float32, device=device)
    dones = torch.empty((n, num_envs), dtype=torch.bool, device=device)
    for name, t in zip(_STATE_FIELDS, tstate):
        setattr(a, name, t.data_ptr())
    for name, t in zip(_OUT_FIELDS, out):
        setattr(a, name, t.data_ptr())
    a.rewards, a.dones = rewards.data_ptr(), dones.data_ptr()
    a.num_envs = num_envs
    a.pickup_reward = params.pickup_reward
    a.delivery_reward = params.delivery_reward
    a.crash_reward = params.crash_reward
    a.charge_reward = params.charge_reward
    return out, rewards, dones


def _tick_args(step_key, tstate: TState, obs_in, read_slot: int, obs_out,
               write_slot: int, chain: Sequence[torch.Tensor], epsilon,
               do_reset: bool, params: EnvParams, collect: int = 1,
               rng_rounds: int = 20, actor_rng_rounds: Optional[int] = None):
    """Check the inputs of a full tick launch (B1 or B3), allocate its
    outputs and fill its argument block. The observation is read from
    ``obs_in``'s columns ``read_slot:read_slot+E`` (drone 0's rows) and
    the ``collect`` drones' next ones written into ``obs_out``'s
    ``write_slot:write_slot+E``; both hold collect · obs_dim rows. Where
    the activations do not fit the block's shared memory
    (``tick_layout``), the block holds its device-memory scratch. Returns
    ``(args, (tstate', rewards, dones, actions))``."""
    obs_dim = obs_rows(params)
    widths = chain_widths(chain)
    device, num_envs = _check_state(tstate, params, widths, collect,
                                    rng_rounds, actor_rng_rounds)
    if obs_in.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"obs dtype {obs_in.dtype} (float32 or bfloat16)")
    for name, obs, slot in (("obs_in", obs_in, read_slot),
                            ("obs_out", obs_out, write_slot)):
        check_tensor(obs, name, obs_in.dtype,
                     (collect * obs_dim, obs.shape[-1]), device)
        if not 0 <= slot <= obs.shape[-1] - num_envs:
            raise ValueError(f"slot {slot} out of {name}")
    check_tensor(epsilon, "epsilon", torch.float32, (), device)
    if widths[0] != obs_dim or widths[-1] != NUM_ACTIONS:
        raise ValueError(f"Q-net widths {widths}: expected {obs_dim} inputs "
                         f"and {NUM_ACTIONS} outputs")
    for i, (w, b) in enumerate(zip(chain[0::2], chain[1::2])):
        check_tensor(w, f"kernel_{i}", torch.float32,
                     (widths[i], widths[i + 1]), device)
        check_tensor(b, f"bias_{i}", torch.float32, (widths[i + 1],), device)
    layout = tick_layout(params, widths, obs_in.dtype == torch.bfloat16)

    a = _TickArgs()
    out, rewards, dones = _fill_env(a, tstate, params)
    a.key_words = key_words(step_key, device)  # kept alive with the block
    a.key = a.key_words.data_ptr()
    actions = torch.empty_like(tstate.air_x)
    a.obs_in, a.obs_out = obs_in.data_ptr(), obs_out.data_ptr()
    a.eps = epsilon.data_ptr()
    a.actions = actions.data_ptr()
    for i, (w, b) in enumerate(zip(chain[0::2], chain[1::2])):
        a.w[i] = w.data_ptr()
        a.b[i] = b.data_ptr()
    if layout["scratch_bytes"]:
        blocks = -(-num_envs // 64)
        a.keep = torch.empty(blocks * layout["scratch_bytes"] // 4,
                             dtype=torch.float32, device=device)
        a.scratch = a.keep.data_ptr()
    a.in_ld, a.read_col = obs_in.shape[-1], read_slot
    a.out_ld, a.write_col = obs_out.shape[-1], write_slot
    a.obs_bf16 = int(obs_in.dtype == torch.bfloat16)
    a.do_reset = int(bool(do_reset))
    return a, (out, rewards, dones, actions)


def _kernel_args(step_key, tstate: TState, obs_ring, read_slot: int,
                 write_slot: int, chain: Sequence[torch.Tensor], epsilon,
                 do_reset: bool, params: EnvParams, **rng_collect):
    """The ring launch's (B1) argument block: the ring is both the
    observation read and the one written, at columns that must not
    overlap unless they are equal; ``rng_collect`` the keywords
    ``collect``, ``rng_rounds`` and ``actor_rng_rounds`` of
    :func:`_tick_args`. Returns ``(args, (tstate', rewards, dones,
    actions))``."""
    num_envs = tstate.ground.shape[1]
    if read_slot != write_slot and abs(read_slot - write_slot) < num_envs:
        raise ValueError("the read and write columns overlap")
    return _tick_args(step_key, tstate, obs_ring, read_slot, obs_ring,
                      write_slot, chain, epsilon, do_reset, params,
                      **rng_collect)


def _push_start(start, device) -> torch.Tensor:
    """The push's start slot as the int32 0-d tensor on ``device`` whose
    word the kernel reads through ``TickArgs.push_start``: a row's word
    there stays as it is (a CUDA graph holds no host value), a host int
    is copied over (an eager caller's)."""
    if isinstance(start, torch.Tensor):
        if (start.dim() != 0 or start.dtype != torch.int32
                or start.device != torch.device(device)):
            raise ValueError("the push's start must be an int or a 0-d "
                             f"int32 tensor on {device}")
        return start
    return upload([int(start)], torch.int32, device)[0]


def _fill_push(a, replay, obs_dim: int, n: int, device) -> None:
    """The push's fields of a B3 argument block: ``replay = (storage,
    start)``, a StreamReplay's storage (obs (obs_dim, capacity) f32,
    actions int32, rewards f32, dones bool (capacity,)) and the push's
    start slot, a multiple of the push's ``n`` columns, as every
    StreamReplay cursor is (so that the push never wraps)."""
    storage, start = replay
    obs = storage["obs"]
    capacity = obs.shape[-1]
    if capacity % n != 0:
        raise ValueError(f"replay capacity {capacity} is not a multiple of "
                         f"the push's {n} columns")
    if isinstance(start, int) and start % n != 0:
        raise ValueError(f"push start {start} is not a multiple of {n}")
    check_tensor(obs, "replay obs", torch.float32, (obs_dim, capacity),
                 device)
    for name, dt in (("actions", torch.int32), ("rewards", torch.float32),
                     ("dones", torch.bool)):
        check_tensor(storage[name], f"replay {name}", dt, (capacity,),
                     device)
    a.start_word = _push_start(start, device)  # kept alive with the block
    a.push_start = a.start_word.data_ptr()
    a.push_obs = obs.data_ptr()
    a.push_actions = storage["actions"].data_ptr()
    a.push_rewards = storage["rewards"].data_ptr()
    a.push_dones = storage["dones"].data_ptr()
    a.push_ld = capacity


def _full_args(step_key, tstate: TState, obs_t, chain: Sequence[torch.Tensor],
               epsilon, do_reset: bool, params: EnvParams, replay=None,
               **rng_collect):
    """The obs launch's (B3) argument block: ``obs_t`` (collect · obs_dim,
    E) f32 is read and the next observation written into a new array of
    its shape; with ``replay = (storage, start)`` the push's fields filled
    (:func:`_fill_push`) and the next observation written over ``obs_t``
    (``rng_collect`` as :func:`_kernel_args`). Returns ``(args, (tstate',
    rewards, dones, actions, obs_t'))``."""
    num_envs = tstate.ground.shape[1]
    if obs_t.dtype != torch.float32 or obs_t.shape[-1] != num_envs:
        raise ValueError(f"obs_t must be float32 (obs_dim, {num_envs})")
    obs_next = torch.empty_like(obs_t) if replay is None else obs_t
    a, outs = _tick_args(step_key, tstate, obs_t, 0, obs_next, 0,
                         chain, epsilon, do_reset, params, **rng_collect)
    if replay is not None:
        _fill_push(a, replay, obs_rows(params),
                   rng_collect.get("collect", 1) * num_envs, obs_t.device)
    return a, outs + (obs_next,)


def _env_tick_args(step_key, tstate: TState, actions_t, params: EnvParams,
                   collect: int = 1, rng_rounds: int = 20):
    """The env tick launch's (B4) argument block, the key read by pointer
    (:func:`key_words`). Returns ``(args, (tstate', rewards, dones, obs_t'
    (collect · obs_dim, E)))``."""
    device, num_envs = _check_state(tstate, params, None, collect,
                                    rng_rounds)
    check_tensor(actions_t, "actions_t", torch.int32,
                 (params.n_drones, num_envs), device)
    a = EnvArgs()
    a.key_words = key_words(step_key, device)  # kept alive with the block
    a.key = a.key_words.data_ptr()
    out, rewards, dones = _fill_env(a, tstate, params)
    obs_next = torch.empty((collect * obs_rows(params), num_envs),
                           dtype=torch.float32, device=device)
    a.actions, a.obs_out = actions_t.data_ptr(), obs_next.data_ptr()
    return a, (out, rewards, dones, obs_next)


def _launch(config, entry: str, args, device):
    lib = _build.load(config)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: " + _build.error_string(lib, err))


def full_tick_fused_ring(
    step_key: torch.Tensor,
    tstate: TState,
    obs_ring: torch.Tensor,
    read_slot: int,
    write_slot: int,
    chain: Sequence[torch.Tensor],
    epsilon: torch.Tensor,
    do_reset: bool,
    params: EnvParams,
    collect: int = 1,
    td_hparams: Optional[Tuple[float, float, float, float, float]] = None,
    td_batch: Optional[Dict[str, torch.Tensor]] = None,
    td_aux=None,
    rng_rounds: int = 20,
    actor_rng_rounds: Optional[int] = None,
):
    """One training tick's env side, writing the next obs into the ring.

    ``step_key`` is a key (2,), on the host or on the ring's device
    (:func:`key_words`: the kernel reads its words by pointer);
    ``read_slot``/``write_slot`` are ring columns; ``chain`` is the actor's matmul chain
    (:func:`flatten_net_params`); ``do_reset`` is a host bool. The ring
    holds ``collect`` · obs_dim rows (the module docstring, as the round
    counts) and is written in place (only columns
    ``write_slot:write_slot+E``). Returns ``(tstate', rewards (N, E) f32,
    dones (N, E) bool, actions (N, E) int32, obs_ring)``.

    With ``td_hparams = (gamma, lr, b1, b2, eps)`` the TD(0) + Adam step
    runs too (dense nets only), on ``td_batch`` (obs / next_obs (obs_dim,
    B), actions / rewards / dones (B,)) with ``td_aux = (params,
    target_params, mu, nu, can_train, count)``, ``params`` the dense net
    whose parameters ``chain`` is, ``can_train`` a host bool and ``count``
    the Adam count (a host int, or an int32 tensor on the device that the
    learner kernel reads by pointer, ``learner_kernel.td_adam``). The return gains ``(params, mu, nu, loss)``:
    params and moments updated in place when ``can_train`` (the caller
    increments the count), untouched otherwise with loss -1. The actor
    reads the params as they were before the step, as the TPU kernel's
    actor reads its input params.

    CUDA tensors launch the kernels (and count the launches in
    ``full_tick_fused_ring.launches`` and ``learner_kernel.td_adam.
    launches``); CPU tensors run the plain versions. There is no
    fallback between the two. A call made while a CUDA graph captures
    records its launches into the graph; whoever replays the graph adds
    them to the counts (``train.Chunk``).
    """
    td = td_hparams is not None
    if td and (td_batch is None or td_aux is None):
        raise ValueError("in-kernel TD needs td_batch and td_aux")
    if td and not isinstance(td_aux[0], DenseQNet):
        raise ValueError("in-kernel TD supports dense networks only")
    rng_collect = dict(collect=collect, rng_rounds=rng_rounds,
                       actor_rng_rounds=actor_rng_rounds)
    if tstate.ground.is_cuda:
        args, outs = _kernel_args(step_key, tstate, obs_ring, read_slot,
                                  write_slot, chain, epsilon, do_reset,
                                  params, **rng_collect)
        _launch(kernel_config(params, chain, **rng_collect),
                "full_tick_ring_launch", args, tstate.ground.device)
        full_tick_fused_ring.launches += 1
        out = outs + (obs_ring,)
    else:
        out = full_tick_ring_plain(step_key, tstate, obs_ring, read_slot,
                                   write_slot, chain, epsilon, do_reset,
                                   params, **rng_collect)
    if not td:
        return out
    gamma, lr, b1, b2, adam_eps = td_hparams
    net, target_params, mu, nu, can_train, count = td_aux
    # The learner writes the params in place, so it goes after the tick
    # kernel's actor has read them: the next launch on the same stream.
    loss = learner_kernel.td_adam(
        td_batch, net, target_params, mu, nu, count,
        learn=bool(can_train), sync_target=False, decay_eps=False,
        epsilon=None, gamma=gamma, lr=lr, b1=b1, b2=b2, adam_eps=adam_eps)
    return out + (net, mu, nu, loss)


# Launches of B1: one a call on CUDA tensors, and one a replay of each
# launch that a captured CUDA graph holds (added by the graph's owner).
full_tick_fused_ring.launches = 0


def full_tick_fused(step_key: torch.Tensor, tstate: TState,
                    obs_t: torch.Tensor, chain: Sequence[torch.Tensor],
                    epsilon: torch.Tensor, do_reset: bool,
                    params: EnvParams, collect: int = 1,
                    rng_rounds: int = 20,
                    actor_rng_rounds: Optional[int] = None,
                    replay=None):
    """The whole env side of a full-engine tick (B3): the ε-greedy actor
    (the matmul ``chain``) on drone 0's rows of ``obs_t`` (collect ·
    obs_dim, E) f32, the physics and respawns, the reset when ``do_reset``
    (a host bool), and the next observation into a new array (the module
    docstring, as the round counts). Returns ``(tstate', rewards (N, E)
    f32, dones (N, E) bool, actions (N, E) int32, obs_t' (collect ·
    obs_dim, E) f32)``.

    With ``replay = (storage, start)``, a ``replay.StreamReplay``'s
    storage and the push's start slot (a host int, or a 0-d int32 tensor
    on the device that the kernel reads by pointer: a chunk row's word; a
    multiple of the push's collect · E columns, as every StreamReplay
    cursor is, so that the push does not wrap),
    the same launch pushes the tick's transitions into the storage, as
    ``StreamReplay.push_many`` of :func:`replay.stream_push_batch` at
    ``start`` would (the caller moves the replay's cursor and size), and
    writes the next observation over ``obs_t``: ``obs_t'`` is ``obs_t``.

    CUDA tensors launch the kernel (counted in ``full_tick_fused.
    launches``, and a captured launch once a replay by the graph's owner);
    CPU tensors run :func:`full_tick_plain`. Both count the calls that
    push in ``full_tick_fused.pushes``.
    """
    rng_collect = dict(collect=collect, rng_rounds=rng_rounds,
                       actor_rng_rounds=actor_rng_rounds)
    if not tstate.ground.is_cuda:
        outs = full_tick_plain(step_key, tstate, obs_t, chain, epsilon,
                               do_reset, params, replay=replay,
                               **rng_collect)
    else:
        args, outs = _full_args(step_key, tstate, obs_t, chain, epsilon,
                                do_reset, params, replay, **rng_collect)
        _launch(kernel_config(params, chain, **rng_collect),
                "full_tick_launch", args, tstate.ground.device)
        full_tick_fused.launches += 1
    if replay is not None:
        full_tick_fused.pushes += 1
    return outs


# Launches of B3, and the launches or plain calls among them that pushed
# into a StreamReplay (a captured one once a replay, added by the graph's
# owner).
full_tick_fused.launches = 0
full_tick_fused.pushes = 0


def tick_fused(step_key: torch.Tensor, tstate: TState,
               actions_t: torch.Tensor, params: EnvParams,
               collect: int = 1, rng_rounds: int = 20):
    """Step and observe every env with the caller's actions (B4):
    ``actions_t`` (N, E) int32, ``step_key`` a key (2,) on the host or on
    the state's device (:func:`key_words`: the kernel reads its words by
    pointer); the first
    ``collect`` drones' observations, every hash at ``rng_rounds``.
    Returns ``(tstate', rewards (N, E) f32, dones (N, E) bool, obs_t'
    (collect · obs_dim, E) f32)``.

    CUDA tensors launch the kernel (counted in ``tick_fused.launches``,
    and a captured launch once a replay by the graph's owner); CPU
    tensors run :func:`tick_plain`.
    """
    if not tstate.ground.is_cuda:
        return tick_plain(step_key, tstate, actions_t, params, collect,
                          rng_rounds)
    args, outs = _env_tick_args(step_key, tstate, actions_t, params,
                                collect, rng_rounds)
    _launch(_build.env_config(params, collect, rng_rounds), "tick_launch",
            args, tstate.ground.device)
    tick_fused.launches += 1
    return outs


tick_fused.launches = 0


# --- ring companions ---------------------------------------------------------

def ring_scalar_writes(a_ring, r_ring, d_ring, actions_t, rewards_t, dones_t,
                       read_slot: int, collect: int = 1):
    """Record this tick's scalars at the slot of its input obs (in place):
    drone 0's into flat (capacity,) rings for ``collect`` = 1, the first k
    drones' into (k, capacity) rings for k > 1."""
    num_envs = actions_t.shape[1]
    cols = slice(read_slot, read_slot + num_envs)
    drones = 0 if collect == 1 else slice(0, collect)
    a_ring[..., cols] = actions_t[drones]
    r_ring[..., cols] = rewards_t[drones]
    d_ring[..., cols] = dones_t[drones].to(torch.int8)
    return a_ring, r_ring, d_ring


def _ring_sample_shape(valid: int, base_step: int, num_envs: int,
                       capacity: int):
    """The sample's span ``max(valid, 1)`` and base slot (``base_step``'s
    slot of the ring)."""
    nb = capacity // num_envs
    return max(valid, 1), (base_step % nb) * num_envs


def ring_gather_batch(sample_key, ring, a_ring, r_ring, d_ring, valid: int,
                      base_step: int, *, num_envs: int, capacity: int,
                      batch_size: int, collect: int = 1,
                      obs_dim: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Uniform replay sample over ``valid`` columns from ``base_step``'s
    slot; next_obs is the column one env-batch later
    (:func:`ring_gather_batch_plain`'s function). On a CUDA ring one
    launch of the ring sample kernel (``draws.ring_sample``, counted in
    ``draws.ring_sample.launches``): it draws the indices from a
    ``sample_key`` (2,) on the ring's device (the ring chunk's graphs);
    a host key (the eager tick's) draws on the host, for far fewer
    launches than a device draw, and the kernel reads the offsets in
    place of the key. On a CPU ring the plain version."""
    if not ring.is_cuda:
        return ring_gather_batch_plain(
            sample_key, ring, a_ring, r_ring, d_ring, valid, base_step,
            num_envs=num_envs, capacity=capacity, batch_size=batch_size,
            collect=collect, obs_dim=obs_dim)
    span, base_slot = _ring_sample_shape(valid, base_step, num_envs,
                                         capacity)
    offsets = None
    if sample_key.device != ring.device:
        offsets = rng.randint(sample_key, (batch_size,), 0, span).to(
            ring.device, non_blocking=True)
    return draws.ring_sample(
        sample_key, ring, a_ring, r_ring, d_ring, span, base_slot,
        num_envs=num_envs, capacity=capacity, batch_size=batch_size,
        collect=collect, obs_dim=obs_dim, offsets=offsets)


def ring_gather_batch_plain(sample_key, ring, a_ring, r_ring, d_ring,
                            valid: int, base_step: int, *, num_envs: int,
                            capacity: int, batch_size: int, collect: int = 1,
                            obs_dim: Optional[int] = None,
                            offsets: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
    """The ring sample in plain PyTorch, on any device: ``batch_size``
    offsets in ``[0, max(valid, 1))`` drawn from ``sample_key`` (2,)
    (``jax.random.randint``) where the key lies and copied to the ring's
    device, or ``offsets`` given in their place (the same draw made by
    the caller); column ``(base_slot + offset) % capacity`` from
    ``base_step``'s slot, next_obs ``num_envs`` columns on. A
    (batch_size,) draw for ``collect`` = 1; for k > 1 a (k, batch_size //
    k) draw, row j's columns gathered from drone j's row group
    (``obs_dim`` rows) and scalar ring, the drones concatenated in
    order."""
    span, base_slot = _ring_sample_shape(valid, base_step, num_envs,
                                         capacity)
    k = collect
    device = ring.device
    shape = (batch_size,) if k == 1 else (k, batch_size // k)
    if offsets is None:
        offsets = rng.randint_plain(sample_key, shape, 0, span)
    raw = offsets.reshape(shape).to(device, non_blocking=True)
    phys = (base_slot + raw.to(torch.int64)) % capacity
    idx = torch.stack([phys, (phys + num_envs) % capacity])
    if k == 1:
        both = ring[:, idx.reshape(-1)].to(torch.float32)
        phys = idx[0]
        return {
            "obs": both[:, :batch_size],
            "next_obs": both[:, batch_size:],
            "actions": a_ring[phys],
            "rewards": r_ring[phys],
            "dones": d_ring[phys].to(torch.float32),
        }
    # Column c of the batch is drone c // (batch_size // k)'s: its rows of
    # the ring are that drone's row group. One gather of (obs_dim, 2 B),
    # obs then next_obs, as for k = 1.
    drone = torch.arange(batch_size, device=device) // (batch_size // k)
    rows = (torch.arange(obs_dim, device=device)[:, None]
            + drone * obs_dim).repeat(1, 2)
    both = ring[rows, idx.reshape(1, -1)].to(torch.float32)
    phys = idx[0].reshape(-1)
    return {
        "obs": both[:, :batch_size],
        "next_obs": both[:, batch_size:],
        "actions": a_ring[drone, phys],
        "rewards": r_ring[drone, phys],
        "dones": d_ring[drone, phys].to(torch.float32),
    }
