"""What the harness reads from the program's carry, one module an engine
name (the traffic file's ``engine``): ``answers(carry, step, num_envs) ->
{name: host tensor (..., E)}`` with the reference engine's names after a
tick, and ``snapshot(carry) -> dict``, the state that the reference's
``trainer.resume`` takes (device copies in the reference's layout);
``learner(carry) -> (online, target, adam mu, epsilon)``, the learner
state's leaves."""

import math

import torch


def learner(carry):
    """The learner state of every engine's carry (slot 3): the online and
    target nets' leaves, Adam's first moments and epsilon."""
    state = carry[3]
    return (state.params.flat(), state.target_params.flat(),
            state.opt_state.mu, state.epsilon)


def state_answers(tstate):
    """The env state, feature-major, on the host."""
    return {"ground": tstate.ground.cpu(), "air_x": tstate.air_x.cpu(),
            "air_y": tstate.air_y.cpu(), "carrying": tstate.carrying.cpu(),
            "charge": tstate.charge.cpu()}


def snapshot(carry, tstate, replay: dict) -> dict:
    """The carry's key chain, step, env state (env-major), learner state
    and ``replay`` (the engine's), copied on the device."""
    state = carry[3]
    adam = state.opt_state
    own = lambda ts: [t.detach().clone() for t in ts]  # noqa: E731
    cells, e = tstate.ground.shape
    g = math.isqrt(cells)
    return {
        "rng": [int(v) for v in carry[0].tolist()], "step": int(carry[-1]),
        "state": {"ground": tstate.ground.t().reshape(e, g, g).clone(),
                  "air_x": tstate.air_x.t().clone(),
                  "air_y": tstate.air_y.t().clone(),
                  "carrying": tstate.carrying.t().to(torch.bool),
                  "charge": tstate.charge.t().clone()},
        "learner": {"params": own(state.params.flat()),
                    "target": own(state.target_params.flat()),
                    "mu": own(adam.mu), "nu": own(adam.nu),
                    "count": int(adam.count),
                    "epsilon": state.epsilon.detach().clone()},
        "replay": replay}
