"""The port's StreamReplay against the JAX package's, bitwise.

Same pushes (data from a numpy seed) into both buffers: storage, cursor,
size, ``can_sample`` and samples drawn with the same key are equal after
every push, from a cold buffer through the wrap once full. The generic
``push_many_t`` is held to JAX's on pushes that wrap the ring. The
reset-corruption count of ``tests/test_replay.py`` holds for the port's
buffer too: the documented approximation is kept, not fixed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu import replay as jreplay
from dronerl_tpu_torch import replay
from dronerl_tpu_torch.interop import from_jax

OBS_DIM = 6


def _templates():
    jt = {"obs": jnp.zeros((OBS_DIM,), jnp.float32),
          "actions": jnp.array(0, jnp.int32),
          "rewards": jnp.array(0.0, jnp.float32),
          "dones": jnp.array(False, jnp.bool_)}
    tt = {"obs": torch.zeros(OBS_DIM),
          "actions": torch.zeros((), dtype=torch.int32),
          "rewards": torch.zeros(()),
          "dones": torch.zeros((), dtype=torch.bool)}
    return jt, tt


def _push_batch(r, n):
    return {"obs": r.random((OBS_DIM, n)).astype(np.float32),
            "actions": r.integers(0, 5, n).astype(np.int32),
            "rewards": r.choice([-1.0, 0.0, 1.0], n).astype(np.float32),
            "dones": r.random(n) < 0.3}


def _assert_state_equal(jstate, tstate, tag):
    assert (int(jstate.cursor), int(jstate.size)) == (tstate.cursor,
                                                      tstate.size), tag
    for k, v in jstate.storage.items():
        assert (np.asarray(v) == tstate.storage[k].numpy()).all(), (tag, k)


@pytest.mark.parametrize("stride,batch_size", [(4, 3), (8, 16)])
def test_stream_replay_matches_jax(stride, batch_size):
    """Cold buffer, filling, full, wrapped twice: state, can_sample and a
    sample after every push."""
    capacity = 5 * stride
    jbuf = jreplay.StreamReplay(capacity, batch_size, stride)
    tbuf = replay.StreamReplay(capacity, batch_size, stride)
    jt, tt = _templates()
    js, ts = jbuf.init(jt), tbuf.init(tt)
    r = np.random.default_rng(stride)
    key = jax.random.PRNGKey(0)
    for t in range(12):
        if t:
            items = _push_batch(r, stride)
            js = jbuf.push_many(js, {k: jnp.asarray(v)
                                     for k, v in items.items()})
            ts = tbuf.push_many(ts, {k: torch.from_numpy(np.asarray(v))
                                     for k, v in items.items()})
        _assert_state_equal(js, ts, t)
        assert bool(jbuf.can_sample(js)) == tbuf.can_sample(ts), t
        key, sample_key = jax.random.split(key)
        jb = jbuf.sample(sample_key, js)
        tb = tbuf.sample(torch.from_numpy(
            np.asarray(sample_key).astype(np.int64)), ts)
        assert set(jb) == set(tb)
        for k in jb:
            assert (np.asarray(jb[k]) == tb[k].numpy()).all(), (t, k)


def test_push_many_t_wrapping_matches_jax():
    """Pushes of 4 slots into a 10-slot ring: the third and later wrap."""
    jt, tt = _templates()
    js, ts = jreplay.init_t(jt, 10), replay.init_t(tt, 10)
    r = np.random.default_rng(1)
    for t in range(6):
        items = _push_batch(r, 4)
        js = jreplay.push_many_t(js, {k: jnp.asarray(v)
                                      for k, v in items.items()}, 10)
        ts = replay.push_many_t(ts, {k: torch.from_numpy(np.asarray(v))
                                     for k, v in items.items()}, 10)
        _assert_state_equal(js, ts, t)


def test_replay_state_from_jax():
    jt, _ = _templates()
    jbuf = jreplay.StreamReplay(12, 2, 4)
    js = jbuf.push_many(jbuf.init(jt), {
        k: jnp.asarray(v) for k, v in _push_batch(
            np.random.default_rng(2), 4).items()})
    ts = from_jax.replay_state_from_jax(jax.device_get(js))
    _assert_state_equal(js, ts, 0)
    assert isinstance(ts.cursor, int) and isinstance(ts.size, int)
    assert ts.storage["dones"].dtype == torch.bool


def test_stream_replay_guards():
    with pytest.raises(ValueError, match="multiple"):
        replay.StreamReplay(10, 2, 4)
    with pytest.raises(ValueError, match="two steps"):
        replay.StreamReplay(4, 2, 4)
    buf = replay.StreamReplay(8, 2, 4)
    state = buf.init({"obs": torch.zeros(2)})
    with pytest.raises(ValueError, match="stride-sized"):
        buf.push_many(state, {"obs": torch.zeros(2, 3)})


def test_stream_replay_reset_corruption_count():
    """tests/test_replay.py's count on the port's buffer: exactly the
    transitions recorded on a reset tick pair with a post-reset next_obs,
    1 in R of the resident ones, and their done stays False."""
    stride, reset_every, n_ticks = 4, 5, 40
    capacity = stride * 20
    buf = replay.StreamReplay(capacity, 8, stride)
    state = buf.init({"obs": torch.zeros(2),  # [tick, is_post_reset]
                      "actions": torch.zeros((), dtype=torch.int32),
                      "rewards": torch.zeros(()),
                      "dones": torch.zeros((), dtype=torch.bool)})
    post_reset = False
    for tick in range(n_ticks):
        obs = torch.stack([torch.full((stride,), float(tick)),
                           torch.full((stride,), float(post_reset))])
        state = buf.push_many(state, {
            "obs": obs,
            "actions": torch.full((stride,), tick % 5, dtype=torch.int32),
            "rewards": torch.zeros(stride),
            "dones": torch.zeros(stride, dtype=torch.bool)})
        post_reset = tick % reset_every == 0

    valid = state.size - stride
    base = state.cursor if state.size == capacity else 0
    phys = (base + np.arange(valid)) % capacity
    nxt = (phys + stride) % capacity
    obs = state.storage["obs"].numpy()
    resident_ticks = obs[0, phys].reshape(-1, stride)[:, 0]
    expected = int(np.sum(resident_ticks % reset_every == 0)) * stride
    corrupted = obs[1, nxt]
    assert int(corrupted.sum()) == expected
    assert abs(corrupted.sum() / valid - 1 / reset_every) < 0.06
    assert not state.storage["dones"].numpy()[phys][corrupted > 0].any()
    # A sample's next_obs is its obs one tick later.
    batch = buf.sample(torch.tensor([0, 3], dtype=torch.int64), state)
    assert torch.equal(batch["next_obs"][0], batch["obs"][0] + 1)
