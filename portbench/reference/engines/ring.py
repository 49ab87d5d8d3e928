"""The ring engine: the replay is a ring of whole env-batches of
observations (``ring_obs_dtype``), written in place by the tick; each
tick's drone-0 action, reward and done sit at the slot of its input
observation, and a trained tick samples the complete columns uniformly,
its next observations one env-batch later."""

import math

import torch

from portbench.reference import env, threefry, trainer


class Engine:
    def __init__(self, flags: dict, p: env.Params, state: env.State, ring,
                 actions, rewards, dones):
        self.flags, self.p, self.state = flags, p, state
        self.ring, self.actions, self.rewards, self.dones = (
            ring, actions, rewards, dones)
        self.e = state.ground.shape[0]
        self.nb = ring.shape[1] // self.e

    @classmethod
    def from_seed(cls, flags: dict, p: env.Params, key) -> "Engine":
        e, device = flags["num_envs"], key.device
        capacity = max(math.ceil(flags["memory_size"] / e) * e, 2 * e)
        state = env.reset_all(key, p, e)
        ring = torch.zeros((p.obs_dim, capacity),
                           dtype=getattr(torch, flags["ring_obs_dtype"]),
                           device=device)
        ring[:, :e] = env.observe(state, p).to(ring.dtype)
        return cls(flags, p, state, ring,
                   torch.zeros(capacity, dtype=torch.int32, device=device),
                   torch.zeros(capacity, dtype=torch.float32, device=device),
                   torch.zeros(capacity, dtype=torch.int8, device=device))

    @classmethod
    def from_snapshot(cls, flags: dict, p: env.Params, snap: dict,
                      device) -> "Engine":
        r = {k: v.to(device, copy=True) for k, v in snap["replay"].items()}
        return cls(flags, p, trainer.state_from_snapshot(snap, device),
                   r["ring"], r["actions"], r["rewards"], r["dones"])

    def tick(self, step: int, step_key, sample_key, learner):
        e, nb, ring, batch = self.e, self.nb, self.ring, self.flags[
            "batch_size"]
        capacity = ring.shape[1]
        slot = step % nb
        read, write = slot * e, ((slot + 1) % nb) * e
        self.state, actions, rewards, dones, ties = trainer.env_tick(
            step_key, self.state, ring[:, read:read + e].float(), learner,
            self.p, self.flags, step)
        ring[:, write:write + e] = env.observe(self.state,
                                               self.p).to(ring.dtype)
        self.actions[read:read + e] = actions[0]
        self.rewards[read:read + e] = rewards[:, 0]
        self.dones[read:read + e] = dones[:, 0].to(torch.int8)
        loss = None
        valid = min(step + 1, nb - 1)
        if valid * e >= batch:
            base = 0 if valid < nb - 1 else (slot + 2) % nb
            off = threefry.randint(sample_key, (batch,), 0,
                                   max(valid * e, 1))
            phys = ((base % nb) * e + off.long()) % capacity
            nxt = (phys + e) % capacity
            loss = learner.train({
                "obs": ring[:, phys].float(), "next_obs": ring[:, nxt].float(),
                "actions": self.actions[phys], "rewards": self.rewards[phys],
                "dones": self.dones[phys].float()})
        answers = {**trainer.state_answers(self.state),
                   "obs": ring[:, write:write + e].float(),
                   "action": self.actions[read:read + e],
                   "reward": self.rewards[read:read + e],
                   "done": self.dones[read:read + e].to(torch.bool)}
        return answers, loss, ties
