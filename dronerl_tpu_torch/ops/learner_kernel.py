"""The DQN learner's TD(0) + Adam step: one kernel launch per learner tick.

Counterpart of ``dronerl_tpu/ops/learner_kernel.py`` (``_learner_kernel``,
``learn_tick_fused``) and of the TD branch of
``dronerl_tpu/ops/fused_tick.py``'s ``_full_kernel`` (``td_hparams``). Both
TPU kernels compute one update: the online forward with its activations
kept, the target forward for the bootstrap, the hand-derived MSE backward
and Adam in optax's ``scale_by_adam`` formulas, with the bias corrections
as ``1 - exp(cf * log(beta))``. The learner kernel adds a hard or EMA
target sync and the ε decay, each under a flag. Here one hand-written
CUDA kernel (``csrc/td_adam.cu``) with three flags serves both:
:func:`learn_tick_fused` is B6, and ``fused_tick.full_tick_fused_ring``
with ``td_hparams`` launches the same kernel after the tick kernel for B2.
On the trainers' default path (``train.kernel_train_step``: learn alone,
on the batch gathered in the same tick) the kernel also stands for the
learner that XLA fuses outside the Pallas kernels
(``dronerl_tpu/train.py:533-541``, ``agents/dqn.py:295``).
The kernel is one thread-block cluster of :data:`CLUSTER` CTAs; each CTA
owns a slice of every layer's output units (:func:`cluster_split`) and
stages its slices and the batch in shared memory (:func:`smem_bytes`); a
batch whose rows do not fit beside them runs in tiles of columns
(:func:`batch_plan`).

The update is in place: params, target, Adam moments and ε are the port's
own tensors, written by the kernel (or by :func:`td_adam_plain` on the
CPU), as the TPU kernels alias every state array in and out. The Adam
count is the host ``int`` of ``AdamState.count``; the caller increments it.
The kernel reads the count from device memory: :func:`td_adam` takes the
int (copied over a launch) or an int32 tensor on the device (a CUDA
graph's launch reads each replay's count from it, checked by
:func:`check_count` where the host fills it).

On CUDA tensors :func:`td_adam` launches the kernel (and counts the launch
in ``td_adam.launches``); on CPU tensors it runs :func:`td_adam_plain`,
the same function in plain PyTorch, written with the kernel's formulas
rather than autograd. There is no fallback between the two.
"""

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from dronerl_tpu_torch.agents.dqn import (
    ADAM_B1, ADAM_B2, ADAM_EPS, DenseQNet, DQNConfig, DQNState)
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS, NUM_ACTIONS
from dronerl_tpu_torch.ops import _build
from dronerl_tpu_torch.utils.graphs import upload

# Limits and launch shape of the CUDA kernel (csrc/td_adam.cu).
MAX_LAYERS = _build.MAX_LAYERS
MAX_BATCH = 256
MAX_SMEM_BYTES = 232_448  # what one block may opt in to on an H100
CLUSTER = 16              # CTAs of the cluster (the non-portable size,
#                           faster than the portable 8: PERF.md §6)
MAX_CHAIN = 40            # the longest FMA chain of a forward (split-K)
DOT_FLOATS = 2            # the dot products accumulate in doubles


def net_widths(net: DenseQNet) -> Tuple[int, ...]:
    """(obs_dim, hidden..., num_actions) of a dense Q-net."""
    return (net.kernels[0].shape[0], *(w.shape[1] for w in net.kernels))


def cluster_split(width: int) -> List[Tuple[int, int]]:
    """The output units ``[lo, hi)`` each CTA of the cluster owns in a layer
    of ``width`` units (mirrors ``own_lo`` in csrc/td_adam.cu): widths that
    ``4 * CLUSTER`` divides in equal slices of whole 16-byte chunks, others
    unit by unit with the first ``width % CLUSTER`` ranks one unit more."""
    unit = 4 if width % (4 * CLUSTER) == 0 else 1
    per, extra = divmod(width // unit, CLUSTER)
    lo = [unit * (r * per + min(r, extra)) for r in range(CLUSTER + 1)]
    return list(zip(lo[:-1], lo[1:]))


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_bytes(widths: Sequence[int], tile: int, staged: bool = True,
               tiled: bool = False, params_staged: bool = True) -> int:
    """One CTA's shared memory for a launch whose batch tile holds
    ``tile`` columns (mirrors ``layout`` in csrc/td_adam.cu): with
    ``params_staged`` its slices of W, target, mu and nu and their biases
    (row stride the largest slice, each array rounded to 16 bytes), with
    ``tiled`` a double gradient accumulator for each of its kernel and
    bias elements, the TD errors (MAX_BATCH floats), then rows of the odd
    stride ``tile | 1``: the forward's split-K partials sharing rows with
    the backward's receive slots (doubles), every layer's online and
    target output, the own output gradients, and with ``staged`` the
    batch (x and xn)."""
    layers = list(zip(widths[:-1], widths[1:]))
    nmax = [max(hi - lo for lo, hi in cluster_split(o)) for _, o in layers]
    segs = [-(-i // MAX_CHAIN) for i, _ in layers]
    param_floats = sum(4 * (_round4(i * n) + _round4(n))
                       for (i, _), n in zip(layers, nmax)) * params_staged
    acc_floats = _round4(DOT_FLOATS * sum(
        (i + 1) * n for (i, _), n in zip(layers, nmax))) * tiled
    partial_rows = max(s * 2 * n for s, n in zip(segs, nmax))
    recv_rows = 2 * CLUSTER * max(nmax[:-1], default=0)
    rows = (DOT_FLOATS * max(partial_rows, recv_rows) + 2 * sum(widths[1:])
            + sum(nmax) + 2 * widths[0] * staged)
    return 4 * (param_floats + acc_floats + MAX_BATCH + rows * (tile | 1))


def params_staged(widths: Sequence[int],
                  limit: int = MAX_SMEM_BYTES) -> bool:
    """Whether the kernel stages its params (mirrors ``PS`` in
    csrc/td_adam.cu, a compile-time choice): when they fit beside the rows
    of a one-column tile with the gradient accumulators, so that every
    batch runs with them staged; else every launch reads them from device
    memory."""
    return smem_bytes(widths, 1, False, True, True) <= limit


class Plan(NamedTuple):
    """A launch's batch tile (0: nothing fits), whether the batch and the
    params are staged in shared memory, and its bytes a CTA."""
    tile: int
    staged: bool
    params_staged: bool
    smem_bytes: int


def batch_plan(widths: Sequence[int], batch: int,
               limit: int = MAX_SMEM_BYTES) -> Plan:
    """The launch at ``batch`` (mirrors ``plan`` in csrc/td_adam.cu), the
    first that fits ``limit`` bytes: the whole batch staged, the whole
    batch read from device memory, or the widest even split of the batch,
    the passes run tile after tile with gradient accumulators."""
    ps = params_staged(widths, limit)
    for staged in (True, False):
        need = smem_bytes(widths, batch, staged, False, ps)
        if need <= limit:
            return Plan(batch, staged, ps, need)
    for n in range(2, batch + 1):
        tile = -(-batch // n)
        need = smem_bytes(widths, tile, False, True, ps)
        if need <= limit:
            return Plan(tile, False, ps, need)
    return Plan(0, False, ps, 0)


def kernel_problems(widths: Sequence[int], batch: int) -> List[str]:
    """What the CUDA kernel does not take in this configuration."""
    problems = []
    if not 1 <= len(widths) - 1 <= MAX_LAYERS:
        problems.append(f"{len(widths) - 1} layers (1..{MAX_LAYERS})")
    if widths[-1] != NUM_ACTIONS:
        problems.append(f"{widths[-1]} outputs (expected {NUM_ACTIONS})")
    if not 1 <= batch <= MAX_BATCH:
        problems.append(f"batch {batch} (1..{MAX_BATCH})")
    elif not problems and batch_plan(widths, batch).tile == 0:
        need = smem_bytes(widths, 1, False, batch > 1,
                          params_staged(widths))
        problems.append(
            f"widths {tuple(widths)} at batch {batch} need {need} bytes of "
            f"shared memory a CTA of the {CLUSTER}-CTA cluster even in "
            f"tiles of one column (> {MAX_SMEM_BYTES})")
    return problems


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device,
                 row_stride: bool = False):
    """Raise unless ``t`` has this device, dtype and shape and is
    contiguous; with ``row_stride``, a (rows, cols) tensor may instead be
    a column slice of a wider one (unit column stride, row stride >=
    cols), which a kernel reads through its row stride."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if row_stride:
        if t.stride(1) != 1 or t.stride(0) < shape[1]:
            raise ValueError(f"{name} must have unit column stride and a "
                             f"row stride >= {shape[1]} (got {t.stride()})")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# --- plain version ---------------------------------------------------------

def td_gradients(batch: Dict[str, torch.Tensor], params: DenseQNet,
                 target: DenseQNet, gamma: float, with_scales: bool = False):
    """The TD(0) loss and its gradient, with the kernel's formulas.

    ``batch``: obs / next_obs (obs_dim, B) float32; actions (B,) int;
    rewards and dones (B,) float32. Returns ``(loss, grads)`` with
    ``grads`` in ``params.flat()`` order; with ``with_scales`` also the
    sums of the gradient's terms' magnitudes (``|a_prev| |gout|ᵀ`` for a
    kernel, ``Σ_b |gout|`` for a bias), which say where a gradient is a
    cancellation whose sign the summation order decides.
    """
    with torch.no_grad():
        x = batch["obs"].to(torch.float32)
        acts = [x]
        for idx, (w, b) in enumerate(zip(params.kernels, params.biases)):
            h = torch.matmul(w.t(), acts[-1]) + b[:, None]
            acts.append(torch.relu(h) if idx < params.n_layers - 1 else h)
        q = acts.pop()
        next_q = target.forward_t(batch["next_obs"].to(torch.float32))
        bsz = x.shape[1]
        rows = torch.arange(NUM_ACTIONS, device=x.device)[:, None]
        onehot = (rows == batch["actions"].to(torch.int64)[None, :]).to(
            torch.float32)
        taken = torch.sum(q * onehot, dim=0)
        bootstrap = next_q.max(dim=0).values
        tgt = batch["rewards"] + gamma * bootstrap * (1.0 - batch["dones"])
        delta = taken - tgt
        loss = torch.sum(delta * delta) * (1.0 / bsz)
        gout = onehot * (delta * (2.0 / bsz))
        n = params.n_layers
        grads: List[Optional[torch.Tensor]] = [None] * (2 * n)
        scales: List[Optional[torch.Tensor]] = [None] * (2 * n)
        for idx in range(n - 1, -1, -1):
            a_prev = acts[idx]
            grads[2 * idx] = torch.matmul(a_prev, gout.t())
            grads[2 * idx + 1] = torch.sum(gout, dim=1)
            if with_scales:
                scales[2 * idx] = torch.matmul(a_prev.abs(), gout.abs().t())
                scales[2 * idx + 1] = torch.sum(gout.abs(), dim=1)
            if idx > 0:
                gin = torch.matmul(params.kernels[idx], gout)
                gout = gin * (a_prev > 0)
    if with_scales:
        return loss, grads, scales
    return loss, grads


def cancellations(grads, scales, rel: float = 1e-5) -> List[torch.Tensor]:
    """Where a gradient is a cancellation: nonzero terms that sum to at
    most ``rel`` of their magnitudes (``scales`` from
    :func:`td_gradients`). There the summation order decides the last
    bits or the sign of ``g``, and Adam's first steps map a tiny ``g`` to
    about ±lr, so two correct learners may differ by that much."""
    return [(s > 0) & (g.abs() <= rel * s) for g, s in zip(grads, scales)]


def loss_slack(batch: Dict[str, torch.Tensor], params: DenseQNet,
               target: DenseQNet, gamma: float,
               q_rel: float = 2.0 ** -20) -> float:
    """How far two correct learners' TD losses may differ beyond their
    relative tolerance: the first-order change of the loss when every
    Q-value its TD errors read carries a relative error of ``q_rel`` (8
    f32 ULPs: a Q-value is an f32 sum of up to obs_dim products, which
    each learner sums in its own order), ``(2/B) Σ_b |δ_b| (|taken_b| +
    γ|boot_b|(1-d_b))·q_rel``. It matters where a TD error is a
    cancellation of its terms, as with one sample a batch."""
    with torch.no_grad():
        q = params.forward_t(batch["obs"].to(torch.float32))
        next_q = target.forward_t(batch["next_obs"].to(torch.float32))
        taken = q.gather(0, batch["actions"].to(torch.int64)[None, :])[0]
        boot = gamma * next_q.max(dim=0).values * (1.0 - batch["dones"])
        delta = taken - (batch["rewards"] + boot)
        slack = torch.sum(delta.abs() * (taken.abs() + boot.abs())) * (
            2.0 * q_rel / delta.shape[0])
    return float(slack)


def adam_corrections(count: int, b1: float, b2: float, device):
    """Adam's bias corrections ``1 - exp(cf * log(beta))`` in f32, with
    ``cf = count + 1`` (the TPU kernels' exp/log form)."""
    cf = torch.tensor(float(count + 1), dtype=torch.float32, device=device)
    return tuple(
        1.0 - torch.exp(cf * torch.log(
            torch.tensor(beta, dtype=torch.float32, device=device)))
        for beta in (b1, b2))


def td_adam_plain(batch, params: DenseQNet, target: DenseQNet,
                  mu: List[torch.Tensor], nu: List[torch.Tensor], count: int,
                  *, learn: bool, sync_target: bool, decay_eps: bool,
                  epsilon: Optional[torch.Tensor], gamma: float, lr: float,
                  tau: float = 1.0, eps_decay: float = 1.0,
                  eps_end: float = 0.0, b1: float = ADAM_B1,
                  b2: float = ADAM_B2,
                  adam_eps: float = ADAM_EPS) -> torch.Tensor:
    """The learner kernel's function in plain PyTorch, on any device.

    With ``learn``: the TD(0) gradient (:func:`td_gradients`), then Adam in
    the kernel's expression order, ``m = b1·m + (1-b1)·g``, ``v = b2·v +
    ((1-b2)·g)·g``, ``p -= lr·((m/bc1) / (sqrt(v/bc2) + eps))`` (optax
    computes ``(1-b2)·g²``). With ``sync_target``: ``target = tau·p +
    (1-tau)·target``, ``p`` the updated params when learning and the input
    params otherwise. With ``decay_eps``: ``ε = max(ε·decay, end)``.

    Updates params, mu, nu, target and ε in place; a flag that is off
    leaves its tensors untouched. ``count`` is the Adam count before the
    step (the caller increments it). Returns the loss, or
    ``NO_TRAIN_LOSS`` (-1) when ``learn`` is off.
    """
    device = params.kernels[0].device
    leaves = params.flat()
    loss = torch.tensor(NO_TRAIN_LOSS, dtype=torch.float32, device=device)
    with torch.no_grad():
        if learn:
            loss, grads = td_gradients(batch, params, target, gamma)
            bc1, bc2 = adam_corrections(count, b1, b2, device)
            for p, m_ref, v_ref, g in zip(leaves, mu, nu, grads):
                m = b1 * m_ref + (1 - b1) * g
                v = b2 * v_ref + (1 - b2) * g * g
                upd = (m / bc1) / (torch.sqrt(v / bc2) + adam_eps)
                p.copy_(p - lr * upd)
                m_ref.copy_(m)
                v_ref.copy_(v)
        if sync_target:
            for t, p in zip(target.flat(), leaves):
                t.copy_(tau * p + (1.0 - tau) * t)
        if decay_eps:
            epsilon.copy_(torch.clamp(epsilon * eps_decay, min=eps_end))
    return loss


# --- the kernel's wrapper ----------------------------------------------------

class _LearnArgs(ctypes.Structure):
    """Mirror of ``LearnArgs`` in csrc/td_adam.cu (field order matters)."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("xn", ctypes.c_void_p),
        ("x_ld", ctypes.c_longlong), ("xn_ld", ctypes.c_longlong),
        ("actions", ctypes.c_void_p), ("rewards", ctypes.c_void_p),
        ("dones", ctypes.c_void_p)] + [
        (name, ctypes.c_void_p * MAX_LAYERS)
        for name in ("w", "b", "tw", "tb", "mw", "mb", "vw", "vb")] + [
        ("loss", ctypes.c_void_p), ("eps", ctypes.c_void_p),
        ("count", ctypes.c_void_p)] + [
        (name, ctypes.c_int)
        for name in ("batch", "learn", "sync", "decay")] + [
        (name, ctypes.c_float)
        for name in ("gamma", "lr", "b1", "b2", "one_minus_b1",
                     "one_minus_b2", "adam_eps", "tau", "one_minus_tau",
                     "eps_decay", "eps_end", "inv_batch", "two_over_batch")]


def check_count(count: int) -> int:
    """``count`` if the kernel's int32 Adam count holds it (and the
    increment after it), else ValueError."""
    if not 0 <= count < 2**31 - 1:
        raise ValueError(f"Adam count {count} out of int32")
    return count


def count_tensor(count, device) -> torch.Tensor:
    """The Adam count as the int32 tensor the kernel reads: a host int
    checked and copied to ``device``, or a tensor of one int32 on
    ``device`` as it is (its values were checked where they were
    written)."""
    if isinstance(count, torch.Tensor):
        check_tensor(count.reshape(()), "count", torch.int32, (), device)
        return count
    return upload([check_count(int(count))], torch.int32, device)


def _learner_args(batch, params: DenseQNet, target: DenseQNet, mu, nu,
                  count, *, learn: bool, sync_target: bool,
                  decay_eps: bool, epsilon, gamma: float, lr: float,
                  tau: float, eps_decay: float, eps_end: float, b1: float,
                  b2: float, adam_eps: float):
    """Check the inputs, allocate the loss and fill the launch's argument
    block. Returns ``(args, loss)``."""
    device = params.kernels[0].device
    widths = net_widths(params)
    bsz = batch["actions"].shape[0]
    problems = kernel_problems(widths, bsz)
    if problems:
        raise ValueError("the CUDA learner kernel does not take this "
                         "configuration: " + "; ".join(problems))
    if net_widths(target) != widths:
        raise ValueError(f"target widths {net_widths(target)} != {widths}")
    shapes = [tuple(p.shape) for p in params.flat()]
    groups = (("param", params.flat()), ("target", target.flat()),
              ("mu", mu), ("nu", nu))
    for name, leaves in groups:
        if len(leaves) != len(shapes):
            raise ValueError(f"{name} has {len(leaves)} leaves, expected "
                             f"{len(shapes)}")
        for i, (t, shape) in enumerate(zip(leaves, shapes)):
            check_tensor(t, f"{name}_{i}", torch.float32, shape, device)
    # obs and next_obs may be the replay gather's column slices of one
    # (obs_dim, 2B) tensor: read in place, not copied.
    for name in ("obs", "next_obs"):
        check_tensor(batch[name], name, torch.float32, (widths[0], bsz),
                     device, row_stride=True)
    check_tensor(batch["actions"], "actions", torch.int32, (bsz,), device)
    check_tensor(batch["rewards"], "rewards", torch.float32, (bsz,), device)
    check_tensor(batch["dones"], "dones", torch.float32, (bsz,), device)
    if decay_eps:
        if epsilon is None:
            raise ValueError("decay_eps needs epsilon")
        check_tensor(epsilon, "epsilon", torch.float32, (), device)
    counts = count_tensor(count, device)

    loss = torch.empty((), dtype=torch.float32, device=device)
    a = _LearnArgs()
    a.x, a.xn = batch["obs"].data_ptr(), batch["next_obs"].data_ptr()
    a.x_ld, a.xn_ld = batch["obs"].stride(0), batch["next_obs"].stride(0)
    a.actions = batch["actions"].data_ptr()
    a.rewards = batch["rewards"].data_ptr()
    a.dones = batch["dones"].data_ptr()
    for (wname, bname), leaves in zip(
            (("w", "b"), ("tw", "tb"), ("mw", "mb"), ("vw", "vb")),
            (params.flat(), target.flat(), mu, nu)):
        w_ptrs, b_ptrs = getattr(a, wname), getattr(a, bname)
        for i in range(len(leaves) // 2):
            w_ptrs[i] = leaves[2 * i].data_ptr()
            b_ptrs[i] = leaves[2 * i + 1].data_ptr()
    a.loss = loss.data_ptr()
    a.eps = epsilon.data_ptr() if decay_eps else None
    a.counts = counts  # kept alive with the block
    a.batch, a.count = bsz, counts.data_ptr()
    a.learn, a.sync, a.decay = (int(bool(f)) for f in (learn, sync_target,
                                                       decay_eps))
    # Python floats reach the kernel rounded to f32, as the plain version's
    # scalar operands do (``1 - b1`` is rounded after the subtraction).
    a.gamma, a.lr, a.b1, a.b2 = gamma, lr, b1, b2
    a.one_minus_b1, a.one_minus_b2 = 1 - b1, 1 - b2
    a.adam_eps, a.tau, a.one_minus_tau = adam_eps, tau, 1.0 - tau
    a.eps_decay, a.eps_end = eps_decay, eps_end
    a.inv_batch, a.two_over_batch = 1.0 / bsz, 2.0 / bsz
    return a, loss


def kernel_config(params: DenseQNet):
    """The learner kernel's library for this net (see ops/_build.py)."""
    return _build.learner_config(net_widths(params))


def launch_shape(config, batch: int) -> Dict[str, int]:
    """A built learner library's launch at ``batch``: the cluster's CTAs,
    threads a CTA, dynamic shared memory a CTA, whether the batch is
    staged, how many such clusters the card holds at once, the batch
    columns a tile, and whether the params are staged."""
    lib = _build.load(config)
    lib.td_adam_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.td_adam_info.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    err = lib.td_adam_info(batch, out)
    if err != 0:
        raise RuntimeError("td_adam_info failed: "
                           + _build.error_string(lib, err))
    return dict(zip(("cluster", "threads", "smem_bytes", "staged",
                     "max_active_clusters", "tile", "params_staged"),
                    (int(v) for v in out)))


def td_adam(batch, params: DenseQNet, target: DenseQNet, mu, nu, count,
            *, learn: bool, sync_target: bool, decay_eps: bool,
            epsilon: Optional[torch.Tensor], gamma: float, lr: float,
            tau: float = 1.0, eps_decay: float = 1.0, eps_end: float = 0.0,
            b1: float = ADAM_B1, b2: float = ADAM_B2,
            adam_eps: float = ADAM_EPS) -> torch.Tensor:
    """:func:`td_adam_plain`'s function: one kernel launch on CUDA tensors
    (counted in ``td_adam.launches``), the plain version on CPU tensors.
    ``count``: a host int, or an int32 tensor of one element on the
    params' device (:func:`count_tensor`). The launch goes on the current
    stream and does not synchronise; the loss is a device tensor the
    kernel writes."""
    kw = dict(learn=learn, sync_target=sync_target, decay_eps=decay_eps,
              epsilon=epsilon, gamma=gamma, lr=lr, tau=tau,
              eps_decay=eps_decay, eps_end=eps_end, b1=b1, b2=b2,
              adam_eps=adam_eps)
    if not params.kernels[0].is_cuda:
        if isinstance(count, torch.Tensor):
            count = int(count)  # a host tensor: no device to wait for
        return td_adam_plain(batch, params, target, mu, nu, count, **kw)
    args, loss = _learner_args(batch, params, target, mu, nu, count, **kw)
    lib = _build.load(kernel_config(params))
    stream = torch.cuda.current_stream(loss.device).cuda_stream
    err = lib.td_adam_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError("td_adam kernel launch failed: "
                           + _build.error_string(lib, err))
    td_adam.launches += 1
    return loss


# Launches of the learner kernel: one a call on CUDA tensors, and one a
# replay of each launch that a captured CUDA graph holds (added by the
# graph's owner, ``train.Chunk``).
td_adam.launches = 0


def learn_tick_fused(batch, ag_state: DQNState, learn_flag: bool,
                     target_flag: bool, eps_flag: bool,
                     config: DQNConfig) -> Tuple[DQNState, torch.Tensor]:
    """One learner tick (port of ``dronerl_tpu.ops.learner_kernel.
    learn_tick_fused``): the TD(0) + Adam step, the target sync and the ε
    decay, each under its host flag, in one launch on CUDA tensors.

    ``batch``: obs / next_obs (obs_dim, B) float32 (a column slice with
    unit column stride is read in place), actions (B,) int32, rewards and
    dones (B,) float32. Updates ``ag_state`` in place and increments its
    Adam count when ``learn_flag``. Returns ``(ag_state, loss)``; the JAX
    function returns the state alone, and its kernel computes no loss.
    """
    adam = ag_state.opt_state
    loss = td_adam(
        batch, ag_state.params, ag_state.target_params, adam.mu, adam.nu,
        adam.count, learn=bool(learn_flag), sync_target=bool(target_flag),
        decay_eps=bool(eps_flag), epsilon=ag_state.epsilon,
        gamma=config.gamma, lr=config.learning_rate, tau=config.tau,
        eps_decay=config.epsilon_decay, eps_end=config.epsilon_end)
    if learn_flag:
        adam.count += 1
    return ag_state, loss
