"""Tick kernel B4: the least time of its work over its device ms, in %.

B4 steps every env with the actions it is given and writes the next
observation; it runs no actor. Its work, by ``roofline.env_bound``:

- bytes: the state read and written once, 2 E (C + 13 N) (the ground's
  C cells a byte each; a drone's x and y, int32, its carry flag, a byte,
  and its charge, f32); the actions read, 4 N E; the rewards (f32) and
  dones (a byte) written, 5 N E; the next f32 observation written, 4 D
  E;
- operations: the hashes of an env, 4 for its key's splits and 2 C spawn
  scores, at 79 operations each (Threefry at 20 rounds), priced at the
  f32 rate; no actor draws.

At grid 9 (C 81), 4 drones, D 294 and 65,536 envs that is (2 x 133 + 36 +
1,176) B = 1,478 B an env, 96.9 MB, 0.0289 ms at 3.35 TB/s, against
0.0128 ms of hashes: bound by bytes."""

from portbench import roofline
from portbench.metrics import b4_ms_per_tick


def bound_ms(ctx) -> float:
    e, c = ctx.num_envs, ctx.cells
    return roofline.env_bound(ctx.n_drones, c, 4 * ctx.net.obs_dim * e,
                              hashes_per_env=4 + 2 * c, num_envs=e)[0]


def read(ctx):
    ms = b4_ms_per_tick.read(ctx)
    if not ms:
        return None
    return bound_ms(ctx) / ms * 100
