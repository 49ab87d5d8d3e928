"""Each cell of BENCHMARK.json run end to end on the CPU at a tiny size
(the port's plain versions in its kernels' place), the result line's
shape checked: the keys a reader of the line needs, the metrics by name and
unit, and the numbers compared, each beside its limit, last."""

import json
import math

import pytest

from portbench import check, run
from portbench.tests.conftest import tiny_cell

BENCH = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _expected(kind, workload):
    return {m["name"]: m["unit"] for m in BENCH[kind]
            if workload in m.get("workloads", (workload,))}


@pytest.mark.parametrize("trace_on", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(workload, trace_on):
    out = run.run_cell(workload, 2**31 + 977, 0.2, trace_on, "cpu",
                       tiny_cell(workload))
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    kind = "per_layer" if trace_on else "end_to_end"
    want = _expected(kind, workload)
    got = {k: v["unit"] for k, v in out["metrics"].items()}
    if trace_on:
        # On the CPU the device readers find no kernel: those metrics are
        # left out, never written as 0.
        assert set(got) <= set(want)
        assert "host_ms_per_tick" in got and "tick_mfu" in got
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    for m in out["metrics"].values():
        assert math.isfinite(m["value"])
    assert out["device"]["count"] == 1
    assert list(out["checks"]) == list(check.NAMES)
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)
