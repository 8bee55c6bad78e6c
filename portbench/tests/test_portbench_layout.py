"""BENCHMARK.json against the benchmark contract, and every piece it names
found by name under portbench/."""

import json
import re

import pytest

from portbench import bench
from portbench.bench import Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = bench.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_token|nwalkers|wave"
                   r"|bands)")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


@pytest.mark.parametrize("name", [x["name"] for x in B["configs"]]
                         + CELLS + [m["name"] for m in METRICS])
def test_names_pass_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_better(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_text_fields_are_one_short_line():
    texts = ([c["why"] for c in B["configs"]]
             + [c["source"] for c in B["configs"]]
             + [w["why"] for w in B["workloads"]]
             + [m["layer"] for m in B["per_layer"]] + B["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_names_unique_and_references_resolve():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in METRICS:
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in B["per_layer"]:
        assert m["moves"] in e2e


def test_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in B["end_to_end"]}["setup_s"] <= 0.25


def test_four_chip_cells_at_most_one():
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_pieces(cell):
    c = Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert c.config["chips"] == c.chips
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(bench.reader(m["name"]))
    # every number the check compares has its limit
    assert {"lnp_gap", "summary_gap", "frozen_share"} <= set(c.limits)
    for q in c.traffic["derived"]:
        assert f"{q}_gap" in c.limits
    if "posterior" in c.traffic["check"]:
        assert "post_gap" in c.limits


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith("portbench/configs/")
    with open(bench.ROOT / cfg["file"]) as fh:
        data = json.load(fh)
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
    assert "assumed" in data


def test_every_config_is_used():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}


def test_file_names_use_name_characters():
    for p in bench.HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(bench.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
