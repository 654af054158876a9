"""BENCHMARK.json and the files its names point to: every configuration,
traffic mix, check and metric reader is found by name, and the file keeps
to the rules of keys, names and units that the benchmark's file follows."""
import json
import re
from pathlib import Path

import pytest

from perfbench import harness, importcheck

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "perfbench/run.py"]


def test_names_and_units():
    names = METRICS + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.traffic["driver"] == "search"
    assert harness.driver(c.traffic["driver"]).run
    assert c.limits and all(v > 0 for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
    assert c.arch.padded_vocab % c.arch.vocab_pad_multiple == 0


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_by_name(metric):
    assert callable(harness.reader(metric))


def test_every_file_is_used():
    """Each configuration, mix, check and reader under ``perfbench/`` is
    named by ``BENCHMARK.json``: the benchmark holds nothing that no cell
    runs."""
    here = ROOT / "perfbench"
    used = {"configs": {Path(c["file"]).stem for c in BENCH["configs"]},
            "traffic": {w["traffic"] for w in BENCH["workloads"]},
            "checks": set(CELLS),
            "metrics": set(METRICS)}
    for folder, names in used.items():
        files = {f.stem for f in (here / folder).iterdir()
                 if f.suffix in (".json", ".py") and not f.stem.startswith("_")}
        assert files == names, folder


def test_config_files_state_their_cut():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg["config"]
            assert not key.endswith(("_dim", "_rank", "_size"))


def test_imports_by_top_level_name():
    assert importcheck.violations() == []


def test_import_check_compares_whole_names(tmp_path):
    ref = tmp_path / "reference"
    ref.mkdir()
    (tmp_path / "ok.py").write_text("import repro_torch.models\n")
    (tmp_path / "bad.py").write_text("from repro.core import quant\n")
    (ref / "bad.py").write_text("import repro_torch\nimport jax.numpy\n")
    found = importcheck.violations(tmp_path)
    assert len(found) == 3
    assert not any("ok.py" in f for f in found)
