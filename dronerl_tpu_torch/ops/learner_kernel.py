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

The update is in place: params, target, Adam moments and ε are the port's
own tensors, written by the kernel (or by :func:`td_adam_plain` on the
CPU), as the TPU kernels alias every state array in and out. The Adam
count is the host ``int`` of ``AdamState.count``; the caller increments it.

On CUDA tensors :func:`td_adam` launches the kernel (and counts the launch
in ``td_adam.launches``); on CPU tensors it runs :func:`td_adam_plain`,
the same function in plain PyTorch, written with the kernel's formulas
rather than autograd. There is no fallback between the two.
"""

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dronerl_tpu_torch.agents.dqn import (
    ADAM_B1, ADAM_B2, ADAM_EPS, DenseQNet, DQNConfig, DQNState)
from dronerl_tpu_torch.constants import NO_TRAIN_LOSS, NUM_ACTIONS
from dronerl_tpu_torch.ops import _build

# Limits of the CUDA kernel (csrc/td_adam.cu).
MAX_LAYERS = _build.MAX_LAYERS
MAX_BATCH = 256
MAX_SMEM_BYTES = 232_448  # what one block may opt in to on an H100


def net_widths(net: DenseQNet) -> Tuple[int, ...]:
    """(obs_dim, hidden..., num_actions) of a dense Q-net."""
    return (net.kernels[0].shape[0], *(w.shape[1] for w in net.kernels))


def smem_bytes(widths: Sequence[int], batch: int) -> int:
    """The kernel's shared memory for one launch (mirrors ``smem_bytes`` in
    csrc/td_adam.cu): the batch rows and every layer's output and output
    gradient, each row padded to an odd stride, plus two rows of B."""
    out_rows = sum(widths[1:])
    return 4 * ((widths[0] + 2 * out_rows) * (batch | 1) + 2 * batch)


def kernel_problems(widths: Sequence[int], batch: int) -> List[str]:
    """What the CUDA kernel does not take in this configuration."""
    problems = []
    if not 1 <= len(widths) - 1 <= MAX_LAYERS:
        problems.append(f"{len(widths) - 1} layers (1..{MAX_LAYERS})")
    if widths[-1] != NUM_ACTIONS:
        problems.append(f"{widths[-1]} outputs (expected {NUM_ACTIONS})")
    if not 1 <= batch <= MAX_BATCH:
        problems.append(f"batch {batch} (1..{MAX_BATCH})")
    elif smem_bytes(widths, batch) > MAX_SMEM_BYTES:
        problems.append(f"batch {batch} needs {smem_bytes(widths, batch)} "
                        f"bytes of shared memory (> {MAX_SMEM_BYTES})")
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
        ("loss", ctypes.c_void_p), ("eps", ctypes.c_void_p)] + [
        (name, ctypes.c_int)
        for name in ("batch", "count", "learn", "sync", "decay")] + [
        (name, ctypes.c_float)
        for name in ("gamma", "lr", "b1", "b2", "one_minus_b1",
                     "one_minus_b2", "adam_eps", "tau", "one_minus_tau",
                     "eps_decay", "eps_end", "inv_batch", "two_over_batch")]


def _learner_args(batch, params: DenseQNet, target: DenseQNet, mu, nu,
                  count: int, *, learn: bool, sync_target: bool,
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
    if not 0 <= count < 2**31 - 1:
        raise ValueError(f"Adam count {count} out of int32")

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
    a.batch, a.count = bsz, count
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


def td_adam(batch, params: DenseQNet, target: DenseQNet, mu, nu, count: int,
            *, learn: bool, sync_target: bool, decay_eps: bool,
            epsilon: Optional[torch.Tensor], gamma: float, lr: float,
            tau: float = 1.0, eps_decay: float = 1.0, eps_end: float = 0.0,
            b1: float = ADAM_B1, b2: float = ADAM_B2,
            adam_eps: float = ADAM_EPS) -> torch.Tensor:
    """:func:`td_adam_plain`'s function: one kernel launch on CUDA tensors
    (counted in ``td_adam.launches``), the plain version on CPU tensors.
    The launch goes on the current stream and does not synchronise; the
    loss is a device tensor the kernel writes."""
    kw = dict(learn=learn, sync_target=sync_target, decay_eps=decay_eps,
              epsilon=epsilon, gamma=gamma, lr=lr, tau=tau,
              eps_decay=eps_decay, eps_end=eps_end, b1=b1, b2=b2,
              adam_eps=adam_eps)
    if not params.kernels[0].is_cuda:
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
