"""BENCHMARK.json against the benchmark's contract, `pending.json`'s cells
against the same rules, and every cell resolved from its files alone."""

import json
import re

import pytest

from harness import cells

SPEC = cells.load_spec()
ALL = cells.load_all()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
ALL_CELLS = [w["name"] for w in ALL["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fits_the_check_at_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("spec", [SPEC, ALL], ids=["gated", "with_pending"])
@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section, spec):
    entries = spec[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


@pytest.mark.parametrize("spec", [SPEC, ALL], ids=["gated", "with_pending"])
def test_entry_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in spec["end_to_end"]:
        # setup_s is reported in every cell, so it lists none
        keys = {"name", "unit", "better", "bound", "source"}
        assert set(m) == (keys if m["name"] == "setup_s"
                          else keys | {"workloads"})
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("spec,names", [(SPEC, CELLS), (ALL, ALL_CELLS)],
                         ids=["gated", "with_pending"])
def test_every_metric_lists_its_cells(spec, names):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] != "setup_s":
            assert m["workloads"] and set(m["workloads"]) <= set(names)
    for m in spec["per_layer"]:
        # the end-to-end metric it moves is reported in each of its cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
    for cell in names:
        reported = [m for m in spec["end_to_end"] if cells._applies(m, cell)]
        assert len(reported) >= 2 and e2e["setup_s"] in reported
        assert any(cell in m["workloads"] for m in spec["per_layer"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


def test_pending_cells_are_not_gated():
    """A cell is in one of the two files, never both."""
    assert not set(CELLS) & {w["name"] for w in
                             cells.load_spec(cells.PENDING)["workloads"]}


def test_shares_of_a_peak_are_named_so():
    for m in ALL["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_resolves_from_its_files(cell):
    c = cells.resolve(cell)
    assert cells.driver(c).Driver
    ref = cells.reference(c)
    assert ref.param_specs(c.config)
    assert c.traffic["driver"] in ("train", "serve", "al", "eval")
    assert c.limits and all("limit" in v for v in c.limits.values())
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)


@pytest.mark.parametrize("conf", ALL["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(conf):
    data = json.loads((cells.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []
    assert data["compute_dtype"] == "float32"
    assert (cells.BENCH / "reference" / data["reference"]).exists()
