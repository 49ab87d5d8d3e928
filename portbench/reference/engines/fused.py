"""The fused engine: the full engine's stream replay, with the actor and
the periodic reset outside the env tick, in the order of the JAX
trainer's ``build_train_step_fused``. Each tick splits the engine's own
chain six ways, ``rng, k_rand, k_act, k_step, k_sample, k_reset =
split(rng, 6)``, and then:

1. every drone's random action, ``randint(k_rand, (N, E), 0, 5)``;
2. drone 0's epsilon-greedy action over it: ``k_act`` splits into an
   explore key and an action key; an env explores where
   ``uniform(explore, (E,)) < epsilon``, taking ``randint(action, (E,),
   0, 5)``, else it takes the lowest-index argmax of the online net's
   Q-values on its input observation;
3. every env's step, env e with row e of ``split(k_step, E)``;
4. the push of the input observations (f32) with drone 0's action, reward
   and done at the replay's cursor, a whole env-batch;
5. once the replay holds a batch of transitions whose successors are
   stored, a batch drawn with ``k_sample`` as the full engine draws it,
   and the TD step;
6. on every ``reset_env_every``-th tick (tick 0 among them), after the
   step: every env reset with ``env.reset_all(k_reset)``, and the next
   observation is the fresh world's.

The schedules follow the tick (``trainer.drive``); the program applies
them before the reset, and neither reads what the other writes.

Departures from the program: the keys that ``trainer.drive`` hands
``tick`` (its three-way ``KeyChain``) are not used; the chain starts from
the seed's key (``from_seed``) or from the snapshot's ``rng``
(``from_snapshot``), as the program's does. The actor's conv runs as
``nets/conv.py``'s patches times the kernel, not as cuDNN's convolution,
so its f32 sums run in another order: a greedy choice on a near tie of
the reference's Q-values (``trainer.NEAR_TIE``) is flagged, as the ring
reference flags it, and the env leaves the comparison from that tick.
"""

import torch

from portbench.reference import env, threefry, trainer
from portbench.reference.engines import full

KEYS = 6    # the chain's key and the tick's five


def act(key, obs_t, learner: trainer.Learner):
    """Drone 0's epsilon-greedy actions (E,) int32 from ``key`` and the
    observations ``obs_t`` (D, E), and ``ties`` (E,): where it chose
    greedily on a near tie."""
    explore_key, action_key = threefry.split(key, 2)
    e = obs_t.shape[1]
    with torch.no_grad():
        q = learner.net.forward_t(learner.params, obs_t,
                                  learner.actor_matmul, learner.flags)
    top = q.topk(2, dim=0).values
    explore = threefry.uniform(explore_key, (e,)) < learner.epsilon
    ties = ~explore & (top[0] - top[1]
                       < trainer.NEAR_TIE * q.abs().amax(dim=0))
    random = threefry.randint(action_key, (e,), 0, env.NUM_ACTIONS)
    greedy = torch.argmax(q, dim=0).to(torch.int32)
    return torch.where(explore, random, greedy), ties


class Engine(full.Engine):
    words = None    # the chain's key: two Python ints

    @classmethod
    def from_seed(cls, flags: dict, p: env.Params, key) -> "Engine":
        engine = super().from_seed(flags, p, key)
        engine.words = tuple(int(v) & threefry.MASK32 for v in key.tolist())
        return engine

    @classmethod
    def from_snapshot(cls, flags: dict, p: env.Params, snap: dict,
                      device) -> "Engine":
        engine = super().from_snapshot(flags, p, snap, device)
        engine.words = tuple(int(v) & threefry.MASK32 for v in snap["rng"])
        return engine

    def keys(self, device):
        """The tick's five keys; the chain moves on."""
        self.words, *keys = threefry.split_host(*self.words, KEYS)
        return [torch.tensor(k, dtype=torch.int64, device=device)
                for k in keys]

    def tick(self, step: int, step_key, sample_key, learner):
        e, p, st = self.e, self.p, self.storage
        batch, capacity = self.flags["batch_size"], st["obs"].shape[1]
        k_rand, k_act, k_step, k_sample, k_reset = self.keys(
            self.obs_t.device)
        actions = threefry.randint(k_rand, (p.n_drones, e), 0,
                                   env.NUM_ACTIONS)
        actions[0], ties = act(k_act, self.obs_t, learner)
        self.state, rewards, dones = env.step(
            threefry.split(k_step, e), self.state, actions.t(), p)
        cols = slice(self.cursor, self.cursor + e)
        st["obs"][:, cols] = self.obs_t
        st["actions"][cols] = actions[0]
        st["rewards"][cols] = rewards[:, 0]
        st["dones"][cols] = dones[:, 0]
        self.cursor = (self.cursor + e) % capacity
        self.size = min(self.size + e, capacity)
        self.obs_t = env.observe(self.state, p)
        loss = None
        if self.size - e >= batch:
            base = self.cursor if self.size == capacity else 0
            off = threefry.randint(k_sample, (batch,), 0,
                                   max(self.size - e, 1)).long()
            phys = (base + off) % capacity
            nxt = (phys + e) % capacity
            loss = learner.train({
                "obs": st["obs"][:, phys], "next_obs": st["obs"][:, nxt],
                "actions": st["actions"][phys],
                "rewards": st["rewards"][phys],
                "dones": st["dones"][phys].float()})
        if step % self.flags["reset_env_every"] == 0:
            self.state = env.reset_all(k_reset, p, e)
            self.obs_t = env.observe(self.state, p)
        answers = {**trainer.state_answers(self.state), "obs": self.obs_t,
                   "action": st["actions"][cols], "reward": st["rewards"][cols],
                   "done": st["dones"][cols]}
        return answers, loss, ties
