"""Port parity: mapped islands (``SearchConfig(mapped=True)``, one island per
rank) in 2 real gloo ranks on the CPU against the port's own sequential
``islands=2`` run, and ``launch.search --mapped``.

The ranks (``helpers.dist_workers.search_checks``, started once in a
module-scoped fixture) run opt-tiny reduced (as the reference's
``dist_smoke``) for 3 steps with migration every 2, at population 1 and 3,
``shard_calib`` off and on; rank 0 also runs the sequential engine on the
same inputs. Mapped must equal sequential BIT FOR BIT: island histories,
initial and final loss, migrations, uphill accepts, the elite's (π, s, φ)
and the searched FFN weights. The merged registry (``obs.dist_snapshot``)
must reconcile with the stats: proposals over both ranks, migrations
counted once. The CLI must write one ``search_mapped_islands/`` row, on
rank 0, whose proposals equal the merged registry's. (The sequential lane
is held to the reference's islands by ``tests/test_torch_search_engine.py``
with the reference's candidates replayed.)
"""
import numpy as np
import pytest

from helpers.dist_ranks import run_ranks
from helpers.dist_workers import SEARCH_RUNS, search_checks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("search")
    return run_ranks(search_checks, 2, tmp, str(tmp))


@pytest.mark.parametrize("run", SEARCH_RUNS,
                         ids=[f"K{k}-{'shard' if s else 'full'}"
                              for k, s in SEARCH_RUNS])
def test_mapped_equals_sequential_bit_for_bit(ranks, run):
    seq = ranks[0]["runs"][run]["sequential"]
    assert not seq["mapped"]
    for r in ranks:
        got = r["runs"][run]["mapped"]
        assert got["mapped"]
        assert got["histories"] == seq["histories"]
        for key in ("final_loss", "initial_loss", "migrations", "uphill"):
            assert got[key] == seq[key], key
        for key in ("pi", "s", "phi", "up"):
            np.testing.assert_array_equal(got[key], seq[key])
    # the runs exercise what they claim: a migration and accepted moves
    assert seq["migrations"] >= 1
    assert sum(h[4] for hist in seq["histories"] for h in hist[1:]) > 0


@pytest.mark.parametrize("run", SEARCH_RUNS,
                         ids=[f"K{k}-{'shard' if s else 'full'}"
                              for k, s in SEARCH_RUNS])
def test_mapped_metrics_reconcile_over_ranks(ranks, run):
    K = run[0]
    for r in ranks:
        res = r["runs"][run]
        assert res["proposals"] == 3 * K * 2          # steps × K × islands
        assert res["migrations_metric"] == res["mapped"]["migrations"]
    # each rank counts the accepts of its own island only
    accepts = [sum(h[4] for h in ranks[0]["runs"][run]["mapped"]
                   ["histories"][i][1:]) for i in range(2)]
    assert [r["runs"][run]["accepts_local"] for r in ranks] == accepts


def test_search_cli_mapped_writes_one_row_on_rank_0(ranks):
    cli0, cli1 = ranks[0]["cli"], ranks[1]["cli"]
    assert cli0["bench_exists"]
    (row,) = cli0["rows"]
    assert row["name"].startswith("search_mapped_islands/opt-tinys3p2i2")
    proposals = sum(s["value"] for s in
                    cli0["metrics"]["search_proposals_total"]["series"])
    assert proposals == 3 * 2 * 2
    assert "migrations=" in row["derived"]
    assert cli1["rows"] is None

