"""The jnp, full and fused engines' chunks (``train.Chunk``) on the CPU.

Each engine's chunk makes one table of per-tick words at its entry (the
keys, the Adam count and bias corrections, the push's start slot, the
sample's bound and base) and runs its ticks from those rows; on a card
each row feeds one CUDA graph replay. Here, without JAX:

* ``rng.randint`` with its upper bound as a 0-d tensor equals the int
  bound bitwise, on the host's Python-int hash and on the tensor hash a
  card runs, for spans 1 (the cold sample) to 2**31 - 1;
* ``ReplayBuffer`` (aligned and not) and ``StreamReplay`` pushed and
  sampled through their words (``push_words``, ``start=``, ``bound=``,
  ``base=``) equal the host-int path bitwise, before the replay is full,
  at the wrap and after it;
* each engine's chunk (jnp with one and two drones collected, full,
  fused) equals as many eager ticks bitwise across two chunks with a
  train state saved and restored between them: every carry tensor, the
  replay's cursor and size, rng, step, the Adam count and the outputs;
* the eager tick takes its push's start and its replay sample's key,
  bound and base from its row's host copy (slices, the host draw), the
  words the device row holds;
* the signatures do not grow with the replay's capacity; a sharded
  trainer's tick is refused; the CLI's jnp, full and fused runs complete
  across chunk boundaries.
"""

import copy

import numpy as np
import pytest
import torch

from dronerl_tpu_torch import replay, rng, train
from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
from dronerl_tpu_torch.env.types import EnvParams
from dronerl_tpu_torch.interop import train_state_io
from dronerl_tpu_torch.parallel import distributed

TP = EnvParams(grid_size=9, n_drones=4)
AGENT_KW = dict(hidden_layers=(16, 16), epsilon_decay_every=2,
                target_update_interval=2, gamma=0.9)


@pytest.mark.parametrize("span", [1, 3, 5, 65537, 100000, 2**31 - 1])
def test_randint_device_bound_equals_int_bound(span, monkeypatch):
    """A 0-d int32 or int64 bound draws the int bound's words, bitwise, on
    the host hash and on the tensor hash (``_HOST_COUNTS`` 0, as a key on
    the card)."""
    for seed in range(4):
        key = rng.split(rng.PRNGKey(seed), 3)[1 + seed % 2]
        want = rng.randint(key, (8,), 0, span)
        for dtype in (torch.int32, torch.int64):
            bound = torch.tensor(span, dtype=dtype)
            assert torch.equal(rng.randint(key, (8,), 0, bound), want)
            with monkeypatch.context() as m:
                m.setattr(rng, "_HOST_COUNTS", 0)
                assert torch.equal(rng.randint(key, (2, 4), 0, bound),
                                   want.reshape(2, 4))
        assert int(want.min()) >= 0 and int(want.max()) < span
    with pytest.raises(ValueError, match="0-d integer"):
        rng.randint(key, (8,), 0, torch.tensor([span]))


def _fill(kind, g, n):
    obs = torch.rand((n, 3) if kind == "row" else (3, n), generator=g)
    return {"obs": obs,
            "actions": torch.randint(0, 5, (n,), generator=g,
                                     dtype=torch.int32),
            "dones": torch.rand((n,), generator=g) < 0.3}


@pytest.mark.parametrize("kind", ["aligned", "unaligned", "stream"])
def test_replay_words_equal_the_host_ints(kind):
    """Ten pushes of 4 (a capacity of 12: full after three, the first
    wrap at the fourth; 14 unaligned, whose pushes wrap mid-push), each
    followed by a sample: the storage and the samples through the words
    equal the host-int path's, and the words' cursor and size its."""
    cap = 14 if kind == "unaligned" else 12
    if kind == "stream":
        buf = replay.StreamReplay(cap, 5, stride=4)
    else:
        buf = replay.ReplayBuffer(cap, 5, uniform_pushes=kind == "aligned")
    template = {"obs": torch.zeros(3),
                "actions": torch.zeros((), dtype=torch.int32),
                "dones": torch.zeros((), dtype=torch.bool)}
    host, dev = buf.init(template), buf.init(template)
    cursor, size = 0, 0
    g = torch.Generator().manual_seed(0)
    for t in range(10):
        batch = _fill("col" if kind == "stream" else "row", g, 4)
        words = buf.push_words(cursor, size, 4)
        host = buf.push_many(host, batch)
        dev = buf.push_many(dev, batch,
                            start=torch.tensor(words.start,
                                               dtype=torch.int32))
        cursor, size = words.cursor, words.size
        assert (host.cursor, host.size) == (cursor, size), t
        for name in host.storage:
            assert torch.equal(host.storage[name], dev.storage[name]), t
        key = rng.split(rng.PRNGKey(t), 2)[1]
        extra = ({"base": torch.tensor(words.base, dtype=torch.int32)}
                 if kind == "stream" else {})
        want = buf.sample(key, host)
        got = buf.sample(key, dev, bound=torch.tensor(words.bound,
                                                      dtype=torch.int32),
                         **extra)
        for name in want:
            assert torch.equal(want[name], got[name]), (t, name)
    if kind == "stream":
        with pytest.raises(ValueError, match="stride-sized"):
            buf.push_words(0, 0, 3)


def _engine(engine, k=1):
    """(tick, fresh(seed)) of an engine at a small size: jnp at 4 envs and
    memory 64 (full after 16 / k ticks), reset every 5; full and fused at
    128 envs over a StreamReplay of 3 env-batches, reset every 3."""
    agent = DQN(DQNConfig(**AGENT_KW), TP, device="cpu")
    if engine == "jnp":
        buf = replay.ReplayBuffer(64, 8, uniform_pushes=True)
        tick = train.build_train_step(agent, buf, TP, 4, 5, k)
        return tick, lambda seed: train.init_jnp_carry(
            agent, TP, 4, buf, rng.PRNGKey(seed), k)
    buf = replay.StreamReplay(3 * 128, 8, stride=128)
    build = {"full": train.build_train_step_full,
             "fused": train.build_train_step_fused}[engine]
    tick = build(agent, buf, TP, 128, 3)
    return tick, lambda seed: train.init_stream_carry(
        agent, TP, 128, buf, rng.PRNGKey(seed))


def _assert_carries_equal(a, b):
    ta, na = train_state_io.leaves(a)
    tb, nb = train_state_io.leaves(b)
    assert na == nb and set(ta) == set(tb)
    for path in ta:
        assert torch.equal(ta[path], tb[path]), path


@pytest.mark.parametrize("engine,k,length", [
    ("jnp", 1, 9), ("jnp", 2, 5), ("full", 1, 3), ("fused", 1, 3)],
    ids=["jnp", "jnp_k2", "full", "fused"])
def test_chunk_equals_eager_ticks_across_a_resume(engine, k, length,
                                                  tmp_path):
    """Two chunks of ``length`` ticks with a train state saved after the
    first and restored into a fresh carry before the second, against as
    many eager ticks from the same carry: every carry tensor, its numbers
    (step, Adam count, cursor, size) and every output bitwise; the replay
    wraps within the run."""
    tick, fresh = _engine(engine, k)
    chunk = train.Chunk(tick)
    carry = fresh(0)
    eager = copy.deepcopy(carry)
    outs = []
    for _ in range(2):
        carry, out = chunk(carry, length)
        outs.append(out)
        path = str(tmp_path / "state.safetensors")
        train_state_io.save(path, carry)
        carry = train_state_io.restore(path, fresh(1))
    ref = []
    for _ in range(2 * length):
        eager, out = tick(eager)
        ref.append(out)
    _assert_carries_equal(carry, eager)
    for i, name in enumerate(("rewards", "epsilon", "loss")):
        got = torch.cat([o[i] for o in outs])
        want = torch.stack([o[i] for o in ref])
        assert torch.equal(got, want), name
    trained = int((torch.stack([o[2] for o in ref]) >= 0).sum())
    capacity = 64 if engine == "jnp" else 3 * 128
    pushed = 2 * length * (4 * k if engine == "jnp" else 128)
    assert pushed > capacity  # the replay wrapped
    assert carry[-1] == 2 * length and carry[3].opt_state.count == trained
    assert (carry[4].cursor, carry[4].size) == (pushed % capacity, capacity)
    assert chunk.graphs == 0  # the CPU captures nothing


@pytest.mark.parametrize("engine", ["jnp", "full", "fused"])
def test_eager_tick_takes_its_replay_words_from_the_host_row(engine):
    """The eager tick hands the body its row's host copy, from which the
    push takes an int start (slices) and the replay sample a host key and
    int bound and base (the host draw, as the ring's eager tick's); they
    equal the words of the row on the device."""
    tick, fresh = _engine(engine)
    seen = []
    body = tick.body

    def spy(carry, row, sig, host=None):
        seen.append((row, host))
        return body(carry, row, sig, host)

    tick.body = spy
    carry = fresh(0)
    for _ in range(3):
        carry, _ = tick(carry)
    index = 1 if engine == "full" else 3
    for row, host in seen:
        assert isinstance(host, np.ndarray)
        assert torch.equal(row, torch.from_numpy(host))
        key = tick.layout.keys(row)[index]
        got = tick.layout.replay_words(row, key, host, index)
        want = tick.layout.replay_words(row, key, None, index)
        assert got[1].device.type == "cpu" and torch.equal(got[1], want[1])
        ints = got[:1] + got[2:]
        assert all(isinstance(w, int) for w in ints)
        assert ints == tuple(int(w) for w in want[:1] + want[2:])


def _signatures(engine, memory, ticks):
    agent = DQN(DQNConfig(hidden_layers=(8,), epsilon_decay_every=5,
                          target_update_interval=10), TP, device="cpu")
    if engine == "jnp":
        buf = replay.ReplayBuffer(memory, 8, uniform_pushes=True)
        tick = train.build_train_step(agent, buf, TP, 1, 100)
    else:
        push = 128
        buf = replay.StreamReplay(max(-(-memory // push) * push, 2 * push),
                                  8, stride=push)
        tick = train.build_train_step_full(agent, buf, TP, 128, 100)
    chain = train.HostChain(rng.PRNGKey(0), 0, 0, 0, 0)
    keys = tick.keys.table(chain.rng, ticks)[1]
    sigs = set()
    for t in range(ticks):
        _, sig, chain = tick.walk(chain, t, keys[t])
        sigs.add(sig)
    return sigs


@pytest.mark.parametrize("engine", ["jnp", "full"])
def test_signatures_do_not_grow_with_the_memory(engine):
    """The CLI's schedule (reset every 100, sync every 10, decay every 5)
    over 300 ticks: the same signatures at memory 64 and 100,000 (the
    replay's cursor and size are words, not signature values), at most
    2 · 2 · 2 · 3."""
    small, big = (_signatures(engine, m, 300) for m in (64, 100_000))
    assert small == big and len(big) <= 2 * 2 * 2 * 3
    assert all(isinstance(v, (bool, type(None)))
               for sig in big for v in sig)


def test_chunk_refuses_a_sharded_tick():
    """A chunk walks its ticks' keys as a table: a tick whose keys have
    none is refused. The sharded trainers' keys (``shard_keys``) have one,
    so a chunk takes a tick built with them or with a process group; on
    the CPU it runs them as eager rows, decided from the device alone
    (the group is not asked for its backend)."""
    agent = DQN(DQNConfig(hidden_layers=(8,)), TP, device="cpu")
    buf = replay.ReplayBuffer(64, 8)
    bare = train.host_keys(5)
    with pytest.raises(ValueError, match="table"):
        train.Chunk(train.build_train_step(
            agent, buf, TP, 4, 5, keys=lambda key, step: bare(key, step)))
    sharded = train.Chunk(train.build_train_step(
        agent, buf, TP, 4, 5, keys=distributed.shard_keys(0, 5, range(5))))
    grouped = train.Chunk(train.build_train_step_ring(agent, TP, 128, 256, 8,
                                                      3, group=object()))
    chunk = train.Chunk(train.build_train_step(agent, buf, TP, 4, 5,
                                               keys=train.host_keys(5)))
    assert not (sharded.graphed or grouped.graphed or chunk.graphed)
    assert (grouped.capture_mode, chunk.capture_mode) == ("thread_local",
                                                          "global")


def test_host_key_table_equals_the_tick_keys():
    """``host_keys(n).table`` (the chain on Python ints, the ticks' keys on
    numpy words) equals ``n + 1``-way splits tick by tick."""
    keys = train.host_keys(5)
    key = rng.PRNGKey(7)
    end, table = keys.table(key, 6)
    for t in range(6):
        key, tick_keys = keys(key, t)
        assert table[t].astype("int64").tolist() == tick_keys.tolist()
    assert torch.equal(end, key)


@pytest.mark.parametrize("argv,engine", [
    (["--num_envs", "4", "--num_steps", "20", "--max_scan_steps", "8"],
     "jnp"),
    (["--num_envs", "128", "--num_steps", "3", "--memory_size", "1024",
      "--max_scan_steps", "2"], "full"),
    (["--num_envs", "128", "--num_steps", "3", "--memory_size", "1024",
      "--network_type", "conv", "--max_scan_steps", "2"], "fused")],
    ids=["jnp", "full", "fused"])
def test_cli_runs_the_engine_chunks_on_cpu(argv, engine, tmp_path):
    """The CPU runs of the verify notes for the three engines, as chunks
    of ``--max_scan_steps`` ticks: they complete and train."""
    metrics = train.main(["--device", "cpu", *argv, "--skip_final_eval",
                          "--run_dir", str(tmp_path)])
    assert metrics["engine"] == engine and metrics["device"] == "cpu"
    assert metrics["trained_ticks"] > 0
    assert metrics["epsilon"] < 1.0
