"""The full engine's carry ``(rng, tstate, obs_t, learner, replay,
step)``: after tick ``step`` the next observations are ``obs_t`` and the
tick's push (its input observations with drone 0's scalars) is the
env-batch before the replay's cursor."""

from portbench import engines
from portbench.engines import learner, state_answers  # noqa: F401


def answers(carry, step: int, num_envs: int) -> dict:
    tstate, obs_t, replay = carry[1], carry[2], carry[4]
    storage = replay.storage
    capacity = storage["obs"].shape[-1]
    start = (replay.cursor - num_envs) % capacity
    cols = slice(start, start + num_envs)
    return {**state_answers(tstate), "obs": obs_t.float().cpu(),
            "action": storage["actions"][cols].cpu(),
            "reward": storage["rewards"][cols].cpu(),
            "done": storage["dones"][cols].cpu()}


def snapshot(carry) -> dict:
    tstate, obs_t, replay = carry[1], carry[2], carry[4]
    return engines.snapshot(carry, tstate, {
        "obs_t": obs_t.clone(), "cursor": replay.cursor, "size": replay.size,
        **{k: v.clone() for k, v in replay.storage.items()}})
