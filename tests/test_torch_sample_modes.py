"""The replay engines' samples as one launch each (``draws.stream_sample``,
``draws.buffer_sample``): their plain versions against JAX, on the CPU.

On CPU storage ``StreamReplay.sample_batch`` and ``ReplayBuffer.
sample_batch`` run their plain versions (``sample`` with the dones as
f32), which are held here, bitwise, to the JAX package's
``StreamReplay.sample`` and ``ReplayBuffer.sample`` (the dones cast to f32,
as its trainers cast them) after every push of the same data from a
numpy seed, from a cold buffer through two wraps, with the same key; the
bound and base given as a chunk row's int32 words too. The
ReplayBuffer's feature-major batch (the learner kernel's) equals its
row-major batch transposed. The kernels' argument blocks mirror
``csrc/draws.cu``'s struct; the card holds the kernels to these plain
versions (``tests/test_torch_kernel.py``, ``chip_smoke.py`` phase 2b).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dronerl_tpu import replay as jreplay
from dronerl_tpu_torch import replay
from dronerl_tpu_torch.ops import draws

OBS_DIM = 6


def _host_key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _push(r, n, slots_last: bool, next_obs: bool):
    obs_shape = (OBS_DIM, n) if slots_last else (n, OBS_DIM)
    items = {"obs": r.random(obs_shape).astype(np.float32),
             "actions": r.integers(0, 5, n).astype(np.int32),
             "rewards": r.choice([-1.0, 0.0, 1.0, -0.1], n).astype(
                 np.float32),
             "dones": r.random(n) < 0.3}
    if next_obs:
        items["next_obs"] = r.random(obs_shape).astype(np.float32)
    return items


def _templates(next_obs: bool):
    jt = {"obs": jnp.zeros((OBS_DIM,), jnp.float32),
          "actions": jnp.array(0, jnp.int32),
          "rewards": jnp.array(0.0, jnp.float32),
          "dones": jnp.array(False, jnp.bool_)}
    tt = {"obs": torch.zeros(OBS_DIM),
          "actions": torch.zeros((), dtype=torch.int32),
          "rewards": torch.zeros(()),
          "dones": torch.zeros((), dtype=torch.bool)}
    if next_obs:
        jt["next_obs"], tt["next_obs"] = jt["obs"], tt["obs"]
    return jt, tt


def _assert_batch(jb, tb, tag):
    jb = dict(jb, dones=np.asarray(jb["dones"]).astype(np.float32))
    assert set(jb) == set(tb), tag
    for name, want in jb.items():
        got = tb[name]
        assert got.dtype == {"actions": torch.int32}.get(
            name, torch.float32), (tag, name)
        assert np.array_equal(np.asarray(want), got.numpy()), (tag, name)


@pytest.mark.parametrize("stride,batch_size", [(4, 3), (8, 16)])
def test_stream_sample_plain_matches_jax(stride, batch_size):
    """StreamReplay: cold, filling, full and wrapped twice."""
    capacity = 5 * stride
    jbuf = jreplay.StreamReplay(capacity, batch_size, stride)
    tbuf = replay.StreamReplay(capacity, batch_size, stride)
    jt, tt = _templates(False)
    js, ts = jbuf.init(jt), tbuf.init(tt)
    r = np.random.default_rng(stride)
    key = jax.random.PRNGKey(1)
    cursor = size = 0
    for t in range(12):
        if t:
            words = tbuf.push_words(cursor, size, stride)
            cursor, size = words.cursor, words.size
            items = _push(r, stride, True, False)
            js = jbuf.push_many(js, {k: jnp.asarray(v)
                                     for k, v in items.items()})
            ts = tbuf.push_many(ts, {k: torch.from_numpy(np.asarray(v))
                                     for k, v in items.items()})
        key, sample_key = jax.random.split(key)
        want = jbuf.sample(sample_key, js)
        _assert_batch(want, tbuf.sample_batch(_host_key(sample_key), ts), t)
        if t:  # the row's words, as a chunk's tick hands them over
            got = tbuf.sample_batch(
                _host_key(sample_key), ts,
                bound=torch.tensor(words.bound, dtype=torch.int32),
                base=torch.tensor(words.base, dtype=torch.int32))
            _assert_batch(want, got, (t, "words"))


@pytest.mark.parametrize("capacity,batch_size,push", [(16, 3, 4), (24, 8, 6)])
def test_buffer_sample_plain_matches_jax(capacity, batch_size, push):
    """ReplayBuffer of whole transitions: cold (the bound below the batch
    size too), filling and wrapped; row-major and feature-major."""
    jbuf = jreplay.ReplayBuffer(capacity, batch_size, uniform_pushes=True)
    tbuf = replay.ReplayBuffer(capacity, batch_size, uniform_pushes=True)
    jt, tt = _templates(True)
    js, ts = jbuf.init(jt), tbuf.init(tt)
    r = np.random.default_rng(capacity)
    key = jax.random.PRNGKey(2)
    for t in range(1, 3 * capacity // push + 1):
        items = _push(r, push, False, True)
        js = jbuf.push_many(js, {k: jnp.asarray(v) for k, v in items.items()})
        ts = tbuf.push_many(ts, {k: torch.from_numpy(np.asarray(v))
                                 for k, v in items.items()})
        assert (int(js.cursor), int(js.size)) == (ts.cursor, ts.size), t
        key, sample_key = jax.random.split(key)
        want = jbuf.sample(sample_key, js)
        rows = tbuf.sample_batch(_host_key(sample_key), ts)
        _assert_batch(want, rows, t)
        cols = tbuf.sample_batch(
            _host_key(sample_key), ts,
            bound=torch.tensor(ts.size, dtype=torch.int32),
            feature_major=True)
        for name in ("obs", "next_obs"):
            assert cols[name].shape == (OBS_DIM, batch_size)
            assert torch.equal(cols[name], rows[name].t()), (t, name)
        for name in ("actions", "rewards", "dones"):
            assert torch.equal(cols[name], rows[name]), (t, name)


def test_replay_sample_args_mirror_the_source():
    """The replays' modes fill the ring sample's block: the words'
    pointers, next_rows and the two layout flags follow ring_bf16 in
    csrc/draws.cu's RingSampleArgs (8-byte pointers, 4-byte flags)."""
    fields = [name for name, _ in draws._RingSampleArgs._fields_]
    assert fields[-6:] == ["ring_bf16", "bound", "base", "next_rows",
                           "rows_in", "rows_out"]
    assert draws._RingSampleArgs.next_rows.offset == 160
    assert draws._RingSampleArgs.rows_out.offset == 172
    assert ctypes.sizeof(draws._RingSampleArgs) == 176


@pytest.mark.parametrize("which", ["stream", "buffer"])
def test_sample_wrappers_refuse_cpu_storage(which):
    """The kernels' wrappers take CUDA storage only; the replays' own
    ``sample_batch`` is what runs the plain version on the CPU."""
    tbuf = (replay.StreamReplay(8, 2, 4) if which == "stream"
            else replay.ReplayBuffer(8, 2))
    ts = tbuf.init(_templates(which == "buffer")[1])
    key = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA storage"):
        if which == "stream":
            draws.stream_sample(key, ts.storage, 1, 0, stride=4,
                                batch_size=2)
        else:
            draws.buffer_sample(key, ts.storage, 1, batch_size=2,
                                feature_major=True)
