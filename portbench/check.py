"""The comparison that decides ``correct``: the program's readings of
two runs of training ticks against the reference's, as six numbers a
run, each held to the cell's limit (``limits/<workload>.json``):

- ``start``: the first ticks from the seed until 3 have trained, which
  set-up drives through the run's own chunk; the reference starts from
  the seed alone.
- ``late``: 3 trained ticks after the window, through the window's own
  graphs, at the epsilon, replay and nets the window left; the reference
  resumes from a snapshot of the program's state taken before them.

The numbers of a run:

- ``env_diff``: the share of (env, tick) pairs whose answer differs in
  anything: the state, the next observation, drone 0's action, reward or
  done. The env side is exact arithmetic; an env leaves the count from
  the tick on which drone 0 chose greedily on a near tie of the
  reference's Q-values (``trainer.NEAR_TIE``), where f32 sums in another
  order may choose either and the env then follows another path.
- ``loss_gap``: the largest relative gap of a trained tick's TD loss.
- ``grad_gap``: the first gradient as the optimizer got it (worked out
  from Adam's first moments before and after the tick), by the worst
  leaf: the gap of the two norms over the larger of the reference leaf's
  norm and the median leaf's.
- ``update_gap``: the online net's change over the run, by the median
  leaf: the gap of the two norms over the larger of the reference leaf's
  and the median leaf's, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone
  under Adam). Not the worst leaf: a hidden unit whose pre-activation
  sits on ReLU's kink for a sample gets a gradient of 0 on one side and a
  tiny one on the other, which Adam scales up, so the worst leaf's gap
  has a tail that no limit below the control's readings holds.
- ``update_parted``: the worst of the same leaves by the share of its
  elements whose change differs from the reference's by more than
  ``PART`` of the leaf's RMS change in the reference. A unit on the kink
  parts its own row or column, a few per cent of a leaf; a leaf whose
  update is skipped or wrong parts nearly all of it, which the median
  leaf's gap does not see where only one or two leaves are wrong.
- ``eps_gap``: the largest relative gap of epsilon after a tick.
"""

import statistics

import torch

NUMBERS = ("env_diff", "loss_gap", "grad_gap", "update_gap",
           "update_parted", "eps_gap")
PHASES = ("start", "late")
NAMES = tuple(f"{phase}_{n}" for phase in PHASES for n in NUMBERS)
STILL = 1e-3      # of the median leaf's gradient norm
PART = 1e-2       # of a leaf's RMS change in the reference


def env_diff(program_ticks, reference_ticks, ties) -> float:
    parted = 0
    total = 0
    tied = None
    for got, want, tie in zip(program_ticks, reference_ticks, ties,
                              strict=True):
        tied = tie if tied is None else tied | tie
        differs = None
        for name, ref in want.items():
            out = got[name].to(ref.dtype).reshape(-1, ref.shape[-1])
            d = (out != ref.reshape(-1, ref.shape[-1])).any(dim=0)
            differs = d if differs is None else differs | d
        parted += int((differs & ~tied).sum())
        total += int((~tied).sum())
    return parted / total


def _norms(leaves):
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def leaf_gaps(got, want, keep=None) -> list:
    """Each kept leaf's gap of norms, over the larger of the reference
    leaf's norm and the median leaf's (of the leaves kept)."""
    g, w = _norms(got), _norms(want)
    keep = range(len(w)) if keep is None else keep
    scale = statistics.median(w[i] for i in keep)
    return [abs(g[i] - w[i]) / max(w[i], scale, 1e-30) for i in keep]


def parted_share(got, want, keep) -> float:
    """The worst kept leaf's share of elements whose value differs from
    the reference's by more than ``PART`` of the reference leaf's RMS."""
    worst = 0.0
    for i in keep:
        g, w = got[i].double(), want[i].double()
        rms = float(w.square().mean().sqrt())
        worst = max(worst, float(((g - w).abs() > PART * rms).double().mean()))
    return worst


def relative(got, want) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got, want, strict=True))


def compare(program: dict, reference: dict) -> dict:
    """The six numbers from two readings of one run
    (``reference.trainer.readings``' layout)."""
    grad_norms = _norms(reference["grads"])
    scale = statistics.median(grad_norms)
    moving = [i for i, n in enumerate(grad_norms) if n >= STILL * scale]

    def change(pair):
        return [after.double() - before.double()
                for before, after in zip(*pair)]

    got, want = change(program["params"]), change(reference["params"])
    updates = leaf_gaps(got, want, moving)
    return {
        "env_diff": env_diff(program["ticks"], reference["ticks"],
                             reference["ties"]),
        "loss_gap": relative(program["losses"], reference["losses"]),
        "grad_gap": max(leaf_gaps(program["grads"], reference["grads"])),
        "update_gap": statistics.median(updates),
        "update_parted": parted_share(got, want, moving),
        "eps_gap": relative(program["epsilons"], reference["epsilons"]),
    }


def compare_runs(program: dict, reference: dict) -> dict:
    """``compare`` of each run (``{phase: readings}``), named
    ``<phase>_<number>``."""
    return {f"{phase}_{name}": value for phase in PHASES
            for name, value in compare(program[phase],
                                       reference[phase]).items()}


def judge(numbers: dict, limits: dict):
    """``(correct, {name: {"value", "limit"}})``: correct where every
    number is at most its limit (a NaN is never within one)."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in NAMES}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
