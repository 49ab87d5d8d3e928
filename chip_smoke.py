#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no phase carries on after one):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build the fused tick kernel (ops/csrc/full_tick.cu) from the sources,
   both nets' configurations at once;
3. hold the kernel against its plain PyTorch version on the card, at the
   bench width (65,536 envs, grid 9, 4 drones, window radius 3), for the
   (16,16) and (128,64) nets and f32 and bf16 rings, over 8 ticks with a
   reset tick: env outputs bitwise (the charge channel within 1.3e-7),
   actions equal wherever the plain Q-values are not a near tie;
4. drive the trainer's main path (``dronerl_tpu_torch.train``) at the
   bench configuration for both nets: the kernel's launch count must equal
   the ticks, losses be finite, params move and ε decay; report obs/s, the
   kernel's time per launch and its plain version's;
5. print the kernel table line, the card line, and the result line last.

It imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

GRID, DRONES, RADIUS = 9, 4, 3
NUM_ENVS = 65536
CAPACITY = 131072          # the bench's ring: max(ceil(1e5 / E) * E, 2E)
BATCH = 8
RESET_EVERY = 100
NETS = ((16, 16), (128, 64))
COMPARE_TICKS = 8
COMPARE_RESET_TICK = 4
WARMUP_TICKS = 10
REPEATS = 3
TICKS_PER_REPEAT = 100
TIMED_LAUNCHES = 20
PLAIN_LAUNCHES = 3
CHARGE_ATOL = 1.3e-7
NEAR_TIE = 1e-5
# H100 SXM published peaks: HBM bytes/s and
# f32 FLOP/s on the CUDA cores. Integer hash operations are counted at
# the f32 rate too, a rate no lower than the card's int32 rate, so the
# bound stays a lower bound.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
OPS_PER_HASH = 79          # threefry2x32-20: 20 rounds x 3 + 5 x 3 + 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dronerl_tpu_torch")):
        fail("the dronerl_tpu_torch package is not beside this script")
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dronerl_tpu_torch import rng
    from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
    from dronerl_tpu_torch.env import core
    from dronerl_tpu_torch.env.types import EnvParams
    from dronerl_tpu_torch.ops import _build, fused_tick
    from dronerl_tpu_torch.train import build_train_step_ring, init_ring_carry

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # --- 2. build ------------------------------------------------------------
    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    obs_dim = fused_tick.obs_rows(params)
    configs = [_build.tick_defines(params, (obs_dim, *h, 5)) for h in NETS]
    t0 = time.perf_counter()
    built = _build.build(configs)
    log(f"built {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s (per build: "
        f"{[round(s, 1) for s in built.values()]})")
    for hidden, cfg in zip(NETS, configs):
        ptxas = [ln.strip() for ln in _build.build_log(cfg).splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"ptxas {hidden}: " + " | ".join(ptxas))

    def make_agent(hidden, seed):
        cfg = DQNConfig(hidden_layers=hidden, epsilon_decay_every=5,
                        target_update_interval=10, gamma=0.9)
        agent = DQN(cfg, params, device=device)
        return agent, agent.init_state(torch.Generator().manual_seed(seed))

    def fresh_env(seed, dtype):
        state = core.reset_batch(rng.PRNGKey(seed).to(device), params,
                                 NUM_ENVS)
        ring = torch.zeros((obs_dim, 2 * NUM_ENVS), dtype=dtype,
                           device=device)
        ring[:, :NUM_ENVS] = core.observe_batch(state, params, 1).reshape(
            NUM_ENVS, obs_dim).t().to(dtype)
        return fused_tick.to_tstate(state), ring

    # --- 3. kernel against its plain version ------------------------------
    max_err = {}
    for hidden in NETS:
        max_err[hidden] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"net {hidden} ring {str(dtype)[6:]}"
            _, ag = make_agent(hidden, 1)
            tstate, ring = fresh_env(2, dtype)
            eps = torch.tensor(0.5, device=device)
            key = rng.PRNGKey(3)
            near_ties = 0
            for t in range(COMPARE_TICKS):
                key, step_key = rng.split(key, 2)
                read, write = (t % 2) * NUM_ENVS, ((t + 1) % 2) * NUM_ENVS
                do_reset = t == COMPARE_RESET_TICK
                ring_plain = ring.clone()
                out_k = fused_tick.full_tick_fused_ring(
                    step_key, tstate, ring, read, write, ag.params, eps,
                    do_reset, params)
                out_p = fused_tick.full_tick_ring_plain(
                    step_key, tstate, ring_plain, read, write, ag.params,
                    eps, do_reset, params, actions_override=out_k[3])
                torch.cuda.synchronize()
                for name, a, b in zip(
                        fused_tick.TState._fields, out_k[0], out_p[0]):
                    if not torch.equal(a, b):
                        fail(f"{tag} tick {t}: state {name} differs")
                for name, i in (("rewards", 1), ("dones", 2)):
                    if not torch.equal(out_k[i], out_p[i]):
                        fail(f"{tag} tick {t}: {name} differ")
                obs_k = ring[:, write:write + NUM_ENVS].float().reshape(
                    -1, 6, NUM_ENVS)
                obs_p = ring_plain[:, write:write + NUM_ENVS].float(
                ).reshape(-1, 6, NUM_ENVS)
                ch = torch.arange(6, device=device) != 4
                if not torch.equal(obs_k[:, ch], obs_p[:, ch]):
                    fail(f"{tag} tick {t}: observation channels differ")
                charge_err = float((obs_k[:, 4] - obs_p[:, 4]).abs().max())
                max_err[hidden] = max(max_err[hidden], charge_err)
                if charge_err > CHARGE_ATOL:
                    fail(f"{tag} tick {t}: charge channel off by "
                         f"{charge_err}")
                if not torch.equal(ring[:, read:read + NUM_ENVS],
                                   ring_plain[:, read:read + NUM_ENVS]):
                    fail(f"{tag} tick {t}: the read columns changed")
                keys = rng.split(step_key.to(device), NUM_ENVS + 2)
                act_p, q = fused_tick.plain_actions(
                    keys[NUM_ENVS], ring_plain, read, ag.params, eps, params,
                    NUM_ENVS)
                top2 = q.topk(2, dim=0).values
                tie = (top2[0] - top2[1]) <= NEAR_TIE * q.abs().amax(dim=0)
                differ = (out_k[3] != act_p).any(dim=0)
                if bool((differ & ~tie).any()):
                    fail(f"{tag} tick {t}: {int((differ & ~tie).sum())} "
                         "actions differ outside near ties")
                near_ties += int(tie.sum())
                tstate = out_k[0]
            log(f"kernel == plain: {tag}, {COMPARE_TICKS} ticks (reset at "
                f"{COMPARE_RESET_TICK}); env bitwise, charge <= "
                f"{CHARGE_ATOL}; near-tie envs {near_ties}")

    # --- 4. the main path --------------------------------------------------
    kernels = []
    for hidden in NETS:
        agent, _ = make_agent(hidden, 0)
        tick = build_train_step_ring(agent, params, NUM_ENVS, CAPACITY,
                                     BATCH, RESET_EVERY)
        carry = init_ring_carry(agent, params, NUM_ENVS, CAPACITY,
                                rng.PRNGKey(0), obs_dtype=torch.bfloat16)
        p0 = [p.detach().clone() for p in carry[3].params.flat()]
        fused_tick.prepare_kernel(params, carry[3].params)
        torch.cuda.synchronize()

        fused_tick.full_tick_fused_ring.launches = 0
        losses, seconds = [], []
        for _ in range(WARMUP_TICKS):
            carry, (rewards, eps, loss) = tick(carry)
            losses.append(loss)
        torch.cuda.synchronize()
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(TICKS_PER_REPEAT):
                carry, (rewards, eps, loss) = tick(carry)
                losses.append(loss)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = fused_tick.full_tick_fused_ring.launches
        ticks = WARMUP_TICKS + REPEATS * TICKS_PER_REPEAT
        if launches != ticks:
            fail(f"net {hidden}: {launches} kernel launches in {ticks} ticks")
        if carry[-1] != ticks:
            fail(f"net {hidden}: step counter {carry[-1]} != {ticks}")
        losses = torch.stack(losses)
        if not bool(torch.isfinite(losses).all()) or bool((losses < 0).any()):
            fail(f"net {hidden}: a loss is not finite or a tick did not train")
        if not bool(torch.isfinite(rewards).all()):
            fail(f"net {hidden}: non-finite rewards")
        if all(torch.equal(a, b) for a, b in zip(p0, carry[3].params.flat())):
            fail(f"net {hidden}: the params did not move")
        if not float(eps) < 1.0:
            fail(f"net {hidden}: epsilon did not decay")
        tick_s = statistics.median(seconds) / TICKS_PER_REPEAT
        log(f"main path net {hidden}: {ticks} ticks, {launches} launches, "
            f"loss {float(losses[-1]):.5f}, eps {float(eps):.4f}, "
            f"obs/s {NUM_ENVS / tick_s:.1f} (median of {REPEATS} x "
            f"{TICKS_PER_REPEAT} ticks; tick {1e3 * tick_s:.4f} ms; "
            f"repeats {[round(s, 4) for s in seconds]} s) on {card}")
        ms, plain_ms, bound_ms, bound_by = time_kernel(
            torch, fused_tick, rng, agent, carry, hidden, card)
        kernels.append({
            "name": "full_tick_ring_" + "x".join(str(h) for h in hidden),
            "route": "cuda",
            "source": "dronerl_tpu_torch/ops/csrc/full_tick.cu",
            "replaces": "dronerl_tpu/ops/fused_tick.py:757 (_full_kernel)",
            "launches": launches,
            "max_abs_err": max_err[hidden],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def time_kernel(torch, fused_tick, rng, agent, carry, hidden, card):
    """Time one tick's kernel launch and its plain version on the main
    path's shapes, after its run (ε = 0: every env runs the greedy actor,
    the most work a tick can need), and work out the kernel's bound."""
    params = agent.env_params
    _rng, (tstate, ring), _s, ag, _aux, _step = carry
    n, c = params.n_drones, params.num_cells
    eps = torch.tensor(0.0, device=ring.device)
    args = (rng.PRNGKey(7), tstate, ring, 0, NUM_ENVS, ag.params, eps,
            False, params)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(fn, count):
        fn(*args)
        torch.cuda.synchronize()
        start.record()
        for _ in range(count):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / count

    ms = timed(fused_tick.full_tick_fused_ring, TIMED_LAUNCHES)
    plain_ms = timed(fused_tick.full_tick_ring_plain, PLAIN_LAUNCHES)

    widths = (ring.shape[0], *hidden, 5)
    weight_bytes = 4 * sum(i * o + o for i, o in zip(widths, widths[1:]))
    state_bytes = NUM_ENVS * (c + n * (4 + 4 + 1 + 4))
    out_bytes = NUM_ENVS * n * (4 + 1 + 4)
    total_bytes = (2 * ring.shape[0] * NUM_ENVS * ring.element_size()
                   + 2 * state_bytes + out_bytes + weight_bytes + 4)
    flops = NUM_ENVS * 2 * sum(i * o for i, o in zip(widths, widths[1:]))
    hashes = NUM_ENVS * (4 + (n + 1) + 2 * c)
    ops = flops + OPS_PER_HASH * hashes
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    log(f"kernel net {hidden}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms; "
        f"bound {max(t_bytes, t_ops):.4f} ms (bytes {total_bytes} -> "
        f"{t_bytes:.4f} ms, ops {ops} = {flops} f32 + {OPS_PER_HASH} x "
        f"{hashes} hash -> {t_ops:.4f} ms); on {card}")
    return ms, plain_ms, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


if __name__ == "__main__":
    main()
