"""``BENCHMARK.json`` against the benchmark's contract: names and units in
the allowed characters, every cell's files found by name, every per-layer
metric reported where the end-to-end metric it moves is."""
import json
import math
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths), w
            assert (ROOT / w).is_file()


def test_names_are_unique_and_allowed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in METRICS]
    assert len(metric_names) == len(set(metric_names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"}
    keys |= ({"layer", "moves"} if per_layer else {"bound"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_setup_is_measured_with_its_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


def _reports(cell: str, name: str) -> bool:
    m = next(x for x in METRICS if x["name"] == name)
    return "workloads" not in m or cell in m["workloads"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_cells_report_what_it_moves(metric):
    moved = [m["name"] for m in BENCH["end_to_end"]]
    assert metric["moves"] in moved
    cells = metric.get("workloads", CELLS)
    assert cells
    for cell in cells:
        assert _reports(cell, metric["moves"]), (metric["name"], cell)
    assert (ROOT / "portbench" / "layer_metrics"
            / f"{metric['name']}.py").is_file()


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0].lower(), set()).add(
            m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    wl = json.loads((ROOT / "portbench" / "workloads"
                     / f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"]
    assert (ROOT / "portbench" / "drivers" / f"{wl['driver']}.py").is_file()
    assert (ROOT / "portbench" / "refs" / f"{cell['config']}.py").is_file()
    assert wl["limits"] and all(math.isfinite(v) and v >= 0
                                for v in wl["limits"].values())
    reported = [m for m in METRICS if _reports(cell["name"], m["name"])]
    e2e = {m["name"] for m in reported if m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(m in BENCH["per_layer"] for m in reported)


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert _line(config["source"]) and _line(config["why"])
    assert config["file"].startswith("portbench/configs/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert sorted(config["reduced"]) == sorted(data["reduced"])
    assert len(config["reduced"]) <= 16
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(config["file"]) == 1


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel


def test_run_seconds_fit_a_full_check_of_24_cells():
    per_run = BENCH["run_seconds"] + 60
    total = (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200
    assert total <= 43200
