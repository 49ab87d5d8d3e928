"""The comparison that decides ``correct``, shown to fail: the controls
(the reference in TF32, or with only its actor's Q forward in TF32, put
in the program's place) and faults planted in the program's timed path
underneath a whole run. Each must come out not correct; the sound
program must hold to the reference."""

import functools

import pytest
import torch

from portbench import calibrate, check, run
from portbench.reference import env as ref_env, trainer
from portbench.tests.conftest import tiny_cell

CELLS = ["dense16.ring.e65536", "dense128x64.ring.e65536",
         "dense16.stream.e65536", "dense128x64.stream.e65536",
         "conv8d16.ring.e65536"]


def _judged(cell, rows, kinds):
    for row in rows:
        if row["kind"] in kinds:
            correct, _ = check.judge(row, cell.limits)
            assert correct == (row["kind"] == "program"), row


@pytest.mark.parametrize("workload", CELLS)
def test_reference_holds_to_the_program_and_the_control_fails(workload):
    cell = tiny_cell(workload)
    rows = calibrate.readings(cell, [11, 12], {11}, "cpu",
                              emit=lambda line: None, chunks=4)
    # At this size few envs act greedily: the actor's control has its own
    # test below.
    _judged(cell, rows, ("program", "control", "half_batch"))


@pytest.mark.parametrize("workload", CELLS)
def test_actor_control_fails(workload):
    """The actor's Q forward alone in TF32 parts some env of 4,096 that
    all act greedily, in the start or in the late ticks."""
    cell = tiny_cell(workload)
    envs = 4096
    cell.flags.update(num_envs=envs, epsilon_start=0.01,
                      memory_size=cell.flags["memory_size"] // 128 * envs)
    rows = calibrate.readings(cell, [11], {11}, "cpu",
                              emit=lambda line: None, chunks=1)
    _judged(cell, rows, ("program", "actor_control"))
    assert {r["kind"] for r in rows} >= {"program", "actor_control"}


def _state_unchanged(monkeypatch):
    from dronerl_tpu_torch import train

    real = train.learner_step

    def still(agent, route, ag_state, batch, row, layout, group=None,
              row_major=False):
        saved = [p.detach().clone() for p in ag_state.params.flat()]
        ag_state, loss = real(agent, route, ag_state, batch, row, layout,
                              group, row_major)
        with torch.no_grad():
            for p, s in zip(ag_state.params.flat(), saved):
                p.copy_(s)
        return ag_state, loss

    monkeypatch.setattr(train, "learner_step", still)


def _one_leaf_unchanged(monkeypatch):
    # The output layer's kernel keeps its value: five of six leaves move
    # as they should, so the median leaf's gap does not see it.
    from dronerl_tpu_torch import train

    real = train.learner_step

    def still(agent, route, ag_state, batch, row, layout, group=None,
              row_major=False):
        leaf = ag_state.params.flat()[-2]
        saved = leaf.detach().clone()
        ag_state, loss = real(agent, route, ag_state, batch, row, layout,
                              group, row_major)
        with torch.no_grad():
            ag_state.params.flat()[-2].copy_(saved)
        return ag_state, loss

    monkeypatch.setattr(train, "learner_step", still)


def _half_batch(monkeypatch):
    from dronerl_tpu_torch import train

    real = train.learner_step

    def half(agent, route, ag_state, batch, row, layout, group=None,
             row_major=False):
        n = batch["actions"].shape[0] // 2
        axis = 0 if row_major else -1
        batch = {k: v.narrow(axis if v.dim() > 1 else 0, 0, n)
                 for k, v in batch.items()}
        return real(agent, route, ag_state, batch, row, layout, group,
                    row_major)

    monkeypatch.setattr(train, "learner_step", half)


def _reward_altered(monkeypatch):
    from dronerl_tpu_torch.ops import fused_tick

    for name in ("full_tick_fused_ring", "full_tick_fused"):
        real = getattr(fused_tick, name)

        # Wrapped, so that the launch and push counters the kernels keep
        # on their functions are there to count.
        @functools.wraps(real)
        def altered(*args, _real=real, **kwargs):
            out = list(_real(*args, **kwargs))
            out[1] = out[1] + 1.0        # every drone's reward
            if kwargs.get("replay") is not None:
                # B3 pushed drone 0's rewards into the StreamReplay itself,
                # at the push's first env-batch of columns.
                storage, start = kwargs["replay"]
                e = out[1].shape[-1]
                storage["rewards"][int(start):int(start) + e] += 1.0
            return tuple(out)

        monkeypatch.setattr(fused_tick, name, altered)


def _schedules_skipped(monkeypatch):
    from dronerl_tpu_torch.agents.dqn import DQN

    monkeypatch.setattr(DQN, "apply_schedules",
                        lambda self, state, step, done, flags=None: state)


@pytest.mark.parametrize("fault", [_state_unchanged, _one_leaf_unchanged,
                                   _half_batch, _reward_altered,
                                   _schedules_skipped],
                         ids=["state_unchanged", "one_leaf_unchanged",
                              "half_batch", "reward_altered",
                              "schedules_skipped"])
@pytest.mark.parametrize("workload", ["dense16.ring.e65536",
                                      "dense16.stream.e65536",
                                      "conv8d16.ring.e65536"])
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run.run_cell(workload, 2**31 + 41, 0.1, False, "cpu",
                       tiny_cell(workload))
    assert out["correct"] is False, out["checks"]


def test_charge_fraction_is_ieee_division():
    # The kernels divide charge by 100 in IEEE f32; the reference rounds
    # the f64 quotient once, which is the same for every charge 0..100.
    c = torch.arange(0, 101, dtype=torch.int32)
    want = (c.numpy().astype("float32") / 100).astype("float32")
    got = ((c.double() / 100.0).float()).numpy()
    assert (got == want).all()


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.14159265])
    r = trainer.tf32_round(x)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert r[0] == x[0]
    assert abs(float(r[2]) - 3.14159265) < 2**-9


def test_reference_env_refuses_the_global_view():
    with pytest.raises(NotImplementedError):
        ref_env.Params(wrapper="global").obs_dim


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(workload, card):
    """On the card at the cell's own size, three seeds: the controls and
    the half-batch fault fail the limits, the program holds."""
    cell = run.load_cell(workload)
    rows = calibrate.readings(cell, [101, 102, 103], {101, 102, 103}, card,
                              emit=lambda line: None)
    _judged(cell, rows, ("program", *(k for k, _ in calibrate.PLANTED)))
