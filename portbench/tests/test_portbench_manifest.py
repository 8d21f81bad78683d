"""``BENCHMARK.json`` against the benchmark's contract: names, units,
keys, metrics and the cells that report them, files found by name."""

import json
import re

import pytest

from portbench import run

MANIFEST = run.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token")


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MANIFEST) == KEYS["top"]
    assert (run.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_text_ok(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (run.ROOT / p).is_dir()


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries(section):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if section in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((run.ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS)


def test_cells():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert _text_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = run.Cell(MANIFEST, w["name"])
        assert cell.driver_path.is_file()


def test_every_metric_has_its_reader():
    cell = run.Cell(MANIFEST, MANIFEST["workloads"][0]["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert run.find(run.BENCH_DIR, "metrics", m["name"], ".py").is_file()
        assert callable(cell.reader(m).read)


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


def test_metrics_by_cell():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric; each per-layer metric moves an end-to-end metric
    that every cell it lists reports."""
    for w in MANIFEST["workloads"]:
        cell = run.Cell(MANIFEST, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
    e2e_names = {m["name"] for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e_names
        assert _text_ok(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        for name in m.get("workloads", [w["name"] for w in MANIFEST["workloads"]]):
            cell = run.Cell(MANIFEST, name)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}, (m, name)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    assert all(len(v) == 1 for v in layers.values())


def test_run_seconds_fits_a_full_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
