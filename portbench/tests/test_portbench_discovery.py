"""Everything a cell needs is found by name, so that a later change adds
a cell, a configuration, a traffic mix or a metric by adding files and
entries alone; and BENCHMARK.json keeps the shape its readers expect."""

import importlib
import json
import os
import re

import pytest

from portbench import check, run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_budget_fits_24_cells():
    seconds = BENCH["run_seconds"]
    assert 1 <= seconds <= 51
    assert 24 * (2 * 90) + (2 + 14 * 24) * (seconds + 60) + 1200 <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_cell_finds_its_files(cell):
    c = run.load_cell(cell["name"])
    assert c.config["name"] == cell["config"]
    assert c.traffic["name"] == cell["traffic"]
    assert set(c.limits) == set(check.NAMES)
    importlib.import_module(f"portbench.engines.{c.traffic['engine']}")
    importlib.import_module(
        f"portbench.reference.engines.{c.traffic['engine']}")
    importlib.import_module(
        f"portbench.reference.nets.{c.flags['network_type']}")
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["source"].startswith("https://github.com/nyx-ai/droneRL")
    path = os.path.join(run.ROOT, config["file"])
    assert config["file"].startswith("portbench/configs/")
    data = json.load(open(path))
    assert data["reduced"] == config["reduced"] == []
    assert data["source"] == config["source"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    reader = importlib.import_module(f"portbench.metrics.{metric['name']}")
    assert callable(reader.read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_cli_argv():
    assert run.cli_argv({"hidden_layers": [16, 16], "gamma": 0.9,
                         "conv_matmul": True, "in_kernel_td": False}) == [
        "--hidden_layers", "16", "16", "--gamma", "0.9", "--conv_matmul"]


def test_large_seed_maps_into_the_cli_range():
    for seed in (0, 2**31 - 1, 2**31, 2**31 + 977, 2**32 + 5):
        assert 0 <= run.cli_seed(seed) < 2**31
    assert run.cli_seed(2**31 + 977) == 977
