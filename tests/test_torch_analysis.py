"""The port's static-analysis pass (``repro_torch.analysis``): the checkers
carried over give the reference's findings on its fixture corpus, the
port's own rules have fixture pairs of their own, the CLI keeps the
reference's exit codes and baseline round trip, ``launch-budget`` replays
the kernels' planners over the reference's zoo units, and the port's tree
is clean against the committed ``analysis_baseline_torch.json``."""
import json
import pathlib

import pytest

from repro.analysis import framework as jfw
from repro.analysis.pallas_budget import zoo_units as jzoo_units
from repro_torch.analysis import framework as fw
from repro_torch.analysis import launch_budget
from repro_torch.analysis.cli import main as analysis_main

HERE = pathlib.Path(__file__).parent
REPO = HERE.parent
REF_FIXTURES = HERE / "fixtures" / "analysis"
FIXTURES = HERE / "fixtures" / "analysis_torch"

EXPECTED_CHECKERS = {"rng-discipline", "monotonic-clock", "launch-budget",
                     "metrics-hygiene"}

# (rule, bad fixture, expected finding count, good fixture)
CASES = [
    ("rng-discipline", "rng_bad.py", 5, "rng_good.py"),
    ("launch-budget", "launch_bad.py", 5, "launch_good.py"),
]
CARRIED = [("monotonic-clock", "clocks"), ("metrics-hygiene", "metrics")]


def run(paths, select=None, root=FIXTURES):
    return fw.run_analysis([str(p) for p in paths], select=select, root=root)


def test_registry_has_the_ports_checkers():
    fw._load_default_checkers()
    assert set(fw.CHECKERS) == EXPECTED_CHECKERS
    for c in fw.CHECKERS.values():
        assert c.description and c.bug_class


@pytest.mark.parametrize("rule,stem", CARRIED, ids=[c[0] for c in CARRIED])
def test_carried_checkers_give_the_reference_findings(rule, stem):
    for kind in ("bad", "good"):
        path = [str(REF_FIXTURES / f"{stem}_{kind}.py")]
        got = fw.run_analysis(path, select=[rule], root=REF_FIXTURES)
        want = jfw.run_analysis(path, select=[rule], root=REF_FIXTURES)
        assert [f.to_json() for f in got.findings] == \
            [f.to_json() for f in want.findings]
        assert bool(got.findings) == (kind == "bad")


@pytest.mark.parametrize("rule,bad,n_bad,good", CASES,
                         ids=[c[0] for c in CASES])
def test_fixture_pair(rule, bad, n_bad, good):
    rep = run([FIXTURES / bad], select=[rule])
    assert len(rep.findings) == n_bad, [f.message for f in rep.findings]
    assert all(f.rule == rule and f.path == bad for f in rep.findings)
    rep = run([FIXTURES / good], select=[rule])
    assert rep.findings == [], [f.message for f in rep.findings]


def test_corpus_full_sweep_counts_by_rule():
    rep = run([FIXTURES])
    assert rep.to_json()["summary"]["by_rule"] == {r: n for r, _, n, _
                                                   in CASES}
    assert not any(f.path.endswith("_good.py") for f in rep.findings)
    assert rep.suppressed == []


def test_finding_messages_name_the_bug():
    rep = run([FIXTURES / "rng_bad.py"], select=["rng-discipline"])
    msgs = "\n".join(f.message for f in rep.findings)
    assert "'torch.randn' draws from the global generator" in msgs
    assert "'.normal_'" in msgs and "'torch.manual_seed' seeds" in msgs
    assert "'np.random.seed'" in msgs and "default_rng" in msgs
    assert sorted({f.symbol for f in rep.findings}) == [
        "bad_global_draw", "bad_in_place", "bad_numpy", "bad_seed"]
    rep = run([FIXTURES / "launch_bad.py"], select=["launch-budget"])
    msgs = "\n".join(f.message for f in rep.findings)
    assert "must be a positive multiple of group" in msgs
    assert "shared memory per CTA" in msgs
    assert "no cluster of at most 16 CTAs" in msgs
    assert "out of the kernel's range" in msgs
    assert "must be a multiple of 4" in msgs


def test_skip_file_and_inline_suppression(tmp_path):
    bad = ("import torch\n\n\n"
           "def f():\n"
           "    return torch.randn(3)\n")
    mod = tmp_path / "mod.py"
    mod.write_text("# analysis: skip-file\n" + bad)
    rep = fw.run_analysis([str(mod)], root=tmp_path)
    assert rep.findings == [] and rep.files == []
    mod.write_text(bad.replace("torch.randn(3)",
                               "torch.randn(3)  # analysis: ignore[rng-discipline]"))
    rep = fw.run_analysis([str(mod)], root=tmp_path)
    assert rep.findings == []
    assert [f.rule for f in rep.suppressed] == ["rng-discipline"]


def test_cli_baseline_roundtrip_and_exit_codes(tmp_path, capsys):
    mod = tmp_path / "mod.py"
    mod.write_text("import torch\n\n\n"
                   "def f():\n"
                   "    return torch.randn(3)\n")
    base = tmp_path / "baseline.json"
    argv = [str(mod), "--baseline", str(base), "--root", str(tmp_path)]
    assert analysis_main(argv) == 1               # unbaselined: gate fails
    assert analysis_main(argv + ["--update-baseline"]) == 0
    assert analysis_main(argv) == 0               # accepted: gate passes
    mod.write_text("# a comment pushing every line down\n\n"
                   + mod.read_text()
                   + "\n\ndef g():\n    return torch.rand(2)\n")
    assert analysis_main(argv) == 1               # only the NEW one fails
    mod.write_text(mod.read_text().replace(
        "torch.rand(2)", "torch.rand(2)  # analysis: ignore[rng-discipline]"))
    assert analysis_main(argv) == 0
    assert analysis_main([str(mod), "--root", str(tmp_path), "--select",
                          "no-such-checker"]) == 2
    assert analysis_main(argv[:1] + ["--baseline", "", "--update-baseline"]) \
        == 2
    assert analysis_main(["--list"]) == 0
    out = tmp_path / "report.json"
    assert analysis_main([str(mod), "--baseline", "", "--root", str(tmp_path),
                          "--json", str(out)]) == 1
    rep = json.loads(out.read_text())
    assert rep["tool"] == "repro_torch.analysis"
    assert set(rep["checkers"]) == EXPECTED_CHECKERS
    assert rep["summary"]["by_rule"] == {"rng-discipline": 1}
    assert rep["findings"][0]["symbol"] == "f"
    capsys.readouterr()


def test_launch_budget_checks_the_reference_zoo_units():
    """The (arch, proj, K, N, mode) set of the reference's pallas-budget
    rows, each at f32 and the config's own dtype, replayed through the
    port's planner."""
    rows = launch_budget.zoo_units()
    key = lambda r: (r["arch"], r["proj"], r.get("K"), r.get("N"),  # noqa: E731
                     r.get("mode"))
    assert {key(r) for r in rows} == {key(r) for r in jzoo_units()}
    from repro_torch.configs import get_config
    for r in rows:
        if r["proj"] is None:
            continue
        dtypes = {x["dtype"] for x in rows
                  if (x["arch"], x["proj"]) == (r["arch"], r["proj"])}
        assert dtypes == {"float32", get_config(r["arch"]).param_dtype}
        assert r["ok"] and r["group"] == 32 and r["anchor"] is None
    kern = launch_budget.zoo_kernels()
    assert all(r["ok"] for r in kern)
    assert {r["arch"] for r in kern if r["kernel"] == "decode"} == \
        {r["arch"] for r in rows if r["arch"] != "mamba2-2.7b"}


def test_a_refused_zoo_shape_is_anchored_at_its_raise(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "_MAX_GRID_Y", 4096)
    ops_py = REPO / "src" / "repro_torch" / "kernels" / "ops.py"
    rep = fw.run_analysis([str(ops_py)], select=["launch-budget"], root=REPO)
    line = next(i for i, s in enumerate(ops_py.read_text().splitlines(), 1)
                if "0 < N <= _MAX_GRID_Y" in s)
    assert rep.findings
    for f in rep.findings:
        assert (f.path, f.line, f.symbol) == (
            "src/repro_torch/kernels/ops.py", line, "_check_quant_args")
        assert "out of the kernel's range" in f.message
    msgs = "\n".join(f.message for f in rep.findings)
    assert "config qwen3-4b ffn_up (K=2560, N=9728" in msgs
    assert "config qwen3-4b blocks/mlp/up (K=92160, N=9728) by group_quant" \
        in msgs


def test_port_tree_is_clean_against_the_committed_baseline(capsys):
    """The gate itself: ``python -m repro_torch.analysis src/repro_torch``."""
    base = REPO / "analysis_baseline_torch.json"
    rc = analysis_main([str(REPO / "src" / "repro_torch"), "--baseline",
                        str(base), "--root", str(REPO)])
    assert rc == 0, capsys.readouterr().out
    for f in fw.load_baseline(base):
        if f.rule == "launch-budget":     # each names why it is refused
            assert " is refused: " in f.message and \
                not f.message.endswith(": ")
