"""The full engine: each tick pushes its input observations (f32) with
drone 0's action, reward and done into a stream replay of whole
env-batches at its cursor; once the replay holds a batch of transitions
whose successors are stored, a tick samples them uniformly from the
oldest slot (slot 0 until the replay is full, then the cursor), each
next observation one env-batch later in ring order."""

import math

import torch

from portbench.reference import env, threefry, trainer


class Engine:
    def __init__(self, flags: dict, p: env.Params, state: env.State, obs_t,
                 storage: dict, cursor: int, size: int):
        self.flags, self.p, self.state, self.obs_t = flags, p, state, obs_t
        self.storage, self.cursor, self.size = storage, cursor, size
        self.e = state.ground.shape[0]

    @classmethod
    def from_seed(cls, flags: dict, p: env.Params, key) -> "Engine":
        e, device = flags["num_envs"], key.device
        capacity = max(math.ceil(flags["memory_size"] / e) * e, 2 * e)
        state = env.reset_all(key, p, e)
        zeros = lambda *shape, dtype: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=device)
        return cls(flags, p, state, env.observe(state, p), {
            "obs": zeros(p.obs_dim, capacity, dtype=torch.float32),
            "actions": zeros(capacity, dtype=torch.int32),
            "rewards": zeros(capacity, dtype=torch.float32),
            "dones": zeros(capacity, dtype=torch.bool)}, 0, 0)

    @classmethod
    def from_snapshot(cls, flags: dict, p: env.Params, snap: dict,
                      device) -> "Engine":
        r = snap["replay"]
        storage = {k: r[k].to(device, copy=True)
                   for k in ("obs", "actions", "rewards", "dones")}
        return cls(flags, p, trainer.state_from_snapshot(snap, device),
                   r["obs_t"].to(device, copy=True), storage,
                   int(r["cursor"]), int(r["size"]))

    def tick(self, step: int, step_key, sample_key, learner):
        e, st, batch = self.e, self.storage, self.flags["batch_size"]
        capacity = st["obs"].shape[1]
        self.state, actions, rewards, dones, ties = trainer.env_tick(
            step_key, self.state, self.obs_t, learner, self.p, self.flags,
            step)
        cols = slice(self.cursor, self.cursor + e)
        st["obs"][:, cols] = self.obs_t
        st["actions"][cols] = actions[0]
        st["rewards"][cols] = rewards[:, 0]
        st["dones"][cols] = dones[:, 0]
        self.cursor = (self.cursor + e) % capacity
        self.size = min(self.size + e, capacity)
        self.obs_t = env.observe(self.state, self.p)
        loss = None
        if self.size - e >= batch:
            base = self.cursor if self.size == capacity else 0
            off = threefry.randint(sample_key, (batch,), 0,
                                   max(self.size - e, 1)).long()
            phys = (base + off) % capacity
            nxt = (phys + e) % capacity
            loss = learner.train({
                "obs": st["obs"][:, phys], "next_obs": st["obs"][:, nxt],
                "actions": st["actions"][phys],
                "rewards": st["rewards"][phys],
                "dones": st["dones"][phys].float()})
        answers = {**trainer.state_answers(self.state), "obs": self.obs_t,
                   "action": st["actions"][cols], "reward": st["rewards"][cols],
                   "done": st["dones"][cols]}
        return answers, loss, ties
