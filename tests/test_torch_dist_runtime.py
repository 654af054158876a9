"""Port parity: the multi-process runtime (``repro_torch.dist.runtime``),
metrics aggregation (``obs.merge_snapshots`` / ``snapshot_json`` /
``dist_snapshot``) and format-2 checkpoints written by every rank, as
``tests/test_dist_runtime.py``, ``tests/test_obs.py`` and
``tests/test_ckpt_sharded.py`` hold the reference's.

In-process: the no-op world of one, both refusals, ``device_summary``'s
keys, the barrier and ``elite_broadcast`` in a world of one, the mapped
search's guard and its 1-island run equal to the sequential lane bit for
bit, a format-1 checkpoint restored as a rank's slices. Two real gloo ranks (``helpers.dist_workers.runtime_checks``, started
once in a module-scoped fixture): the barrier, a divergent collective
raising, ``dist_snapshot`` byte-identical on both ranks and equal to the
reference's merge, the preemption drain's barrier, and 2-rank format-2
saves over {"data": 2, "model": 1} and {"data": 1, "model": 2}: each
rank's file holds only its slices, ``remesh_restore`` onto the other shape
and onto whole tensors is equal bit for bit, the reference's
``restore_sharded_checkpoint`` reads the files equal, and retention works
across two hosts with a stale host file and a stale own file.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from helpers.dist_ranks import run_ranks
from helpers.dist_workers import (CKPT_MESHES, TINY, ckpt_specs, ckpt_tree,
                                  runtime_checks, skewed_registry)
from repro import obs as jobs
from repro.ckpt import checkpoint as jck
from repro_torch import obs as tobs
from repro_torch.core.quant import QuantConfig
from repro_torch.core.search import SearchConfig
from repro_torch.dist import runtime
from repro_torch.dist.collectives import elite_broadcast
from repro_torch.dist.fault import PreemptionGuard
from repro_torch.dist.sharding import shard_index
from repro_torch.search import run as run_search

ENV = ("REPRO_COORDINATOR", "JAX_COORDINATOR_ADDRESS", "REPRO_NUM_PROCESSES",
       "REPRO_PROCESS_ID")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runtime")
    outs = run_ranks(runtime_checks, 2, tmp, str(tmp))
    return outs, tmp


@pytest.fixture
def no_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# a world of one (in-process)
# ---------------------------------------------------------------------------

def test_initialize_single_process_is_noop(no_env):
    assert runtime.initialize(device="cpu") is False
    assert runtime.is_distributed() is False
    assert runtime.process_index() == 0 and runtime.process_count() == 1
    assert runtime.initialize("127.0.0.1:9", 1, 0, device="cpu") is False


def test_initialize_refuses_a_split_brain(no_env, monkeypatch):
    with pytest.raises(ValueError, match="num_processes"):
        runtime.initialize(coordinator="127.0.0.1:9999", device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        runtime.initialize(process_id=1, device="cpu")
    monkeypatch.setenv("REPRO_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="coordinator"):
        runtime.initialize(device="cpu")


def test_device_summary_keys(no_env):
    runtime.initialize(device="cpu")
    s = runtime.device_summary()
    assert set(s) == {"process_index", "process_count", "local_devices",
                      "local_device_count", "global_device_count", "platform"}
    assert (s["process_count"], s["local_device_count"],
            s["global_device_count"], s["platform"]) == (1, 1, 1, "cpu")


def test_barrier_and_elite_broadcast_in_a_world_of_one():
    h = tobs.histogram("dist_barrier_seconds", "Barrier wait latency")
    before = h.count()
    runtime.barrier("test")
    runtime.barrier("test-again")
    assert h.count() == before + 2
    tree = {"v": torch.tensor([3.0]), "w": (torch.tensor([6.0]), None)}
    out = elite_broadcast(tree, 0)
    assert torch.equal(out["v"], tree["v"]) and out["w"][1] is None


def test_preemption_drain_reaches_the_barrier(monkeypatch):
    tags = []
    monkeypatch.setattr(runtime, "barrier", lambda tag="", group=None:
                        tags.append(tag))
    with PreemptionGuard() as guard:
        guard.drain(None, 3, {})
    assert tags == ["preemption-drain"]


def _tiny():
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("opt-tiny").reduced(**TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = torch.randint(0, cfg.vocab_size, (2, 32),
                          generator=torch.Generator().manual_seed(1))
    return cfg, params, calib


def test_mapped_requires_one_island_per_device():
    cfg, params, calib = _tiny()
    scfg = SearchConfig(steps=1, islands=2, mapped=True, n_match_layers=2,
                        log_every=0)
    with pytest.raises(ValueError, match="one island per device"):
        run_search(params, params, cfg, QuantConfig(bits=2, group_size=32),
                   calib, scfg)
    with pytest.raises(ValueError, match="tabu"):
        run_search(params, params, cfg, QuantConfig(bits=2, group_size=32),
                   calib, dataclasses.replace(scfg, islands=1, tabu=4))


def test_mapped_single_island_equals_sequential():
    cfg, params, calib = _tiny()
    scfg = SearchConfig(steps=3, islands=1, n_match_layers=2, log_every=0,
                        population=2)
    qcfg = QuantConfig(bits=2, group_size=32)
    r_seq = run_search(params, params, cfg, qcfg, calib, scfg)
    r_map = run_search(params, params, cfg, qcfg, calib,
                       dataclasses.replace(scfg, mapped=True))
    assert r_seq.history == r_map.history
    assert r_seq.final_loss == r_map.final_loss
    assert r_map.stats["mapped"] and not r_seq.stats["mapped"]
    for a, b in zip(r_seq.transforms, r_map.transforms):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rank", [0, 1])
def test_format1_restores_as_a_ranks_slices(tmp_path, rank):
    """A format-1 checkpoint (one process wrote it whole) re-meshed onto a
    2-rank mesh shape: each leaf comes back as the rank's slice."""
    from repro_torch.ckpt.checkpoint import (restore_sharded_checkpoint,
                                             save_checkpoint)
    from repro_torch.dist.sharding import shard_of
    tree = ckpt_tree()
    save_checkpoint(tmp_path, 2, tree)
    mesh = CKPT_MESHES[0]
    specs = ckpt_specs(tree, "data")
    got, manifest = restore_sharded_checkpoint(tmp_path, 2, specs=specs,
                                               mesh=mesh, rank=rank,
                                               device="cpu")
    assert manifest["format"] == 1
    assert torch.equal(got["w"], shard_of(tree["w"], specs["w"], mesh, rank))
    assert torch.equal(got["qt"].packed, shard_of(
        tree["qt"].packed, specs["qt"].packed, mesh, rank))
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"],
                                                            tree["b"])
    assert got["t"][1] is None and torch.equal(got["step"], tree["step"])


# ---------------------------------------------------------------------------
# obs: the merge against the reference's
# ---------------------------------------------------------------------------

def _both_registries(values):
    """The same per-pid registries in both packages (counters, labels,
    gauges and histograms skewed by pid)."""
    return ([skewed_registry(tobs, p) for p in values],
            [skewed_registry(jobs, p) for p in values])


@pytest.mark.parametrize("pids", [(0, 1), (0, 1, 2, 3), (2,)])
def test_merge_snapshots_matches_reference(pids):
    t_regs, j_regs = _both_registries(pids)
    t_m, j_m = {}, {}
    for t, j in zip(t_regs, j_regs):
        assert tobs.snapshot_json(t.snapshot()) == jobs.snapshot_json(
            j.snapshot())
        t_m = tobs.merge_snapshots(t_m, t.snapshot())
        j_m = jobs.merge_snapshots(j_m, j.snapshot())
    assert tobs.snapshot_json(t_m) == jobs.snapshot_json(j_m)
    assert tobs.snapshot_json(tobs.dist_snapshot(t_regs[0])) == \
        jobs.snapshot_json(jobs.merge_snapshots(j_regs[0].snapshot(), {}))


def test_merge_snapshots_refuses_what_the_reference_refuses():
    a, b = tobs.Registry(), tobs.Registry()
    a.histogram("h", buckets=(0.1, 1.0)).observe(0.5)
    b.histogram("h", buckets=(0.2, 2.0)).observe(0.5)
    with pytest.raises(ValueError, match="edges"):
        tobs.merge_snapshots(a.snapshot(), b.snapshot())
    c = tobs.Registry()
    c.counter("h").inc()
    with pytest.raises(ValueError, match="kind"):
        tobs.merge_snapshots(a.snapshot(), c.snapshot())


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def test_two_ranks_bring_up_and_barrier(ranks):
    outs, _ = ranks
    for r, o in enumerate(outs):
        assert o["distributed"] is True
        s = o["summary"]
        assert (s["process_index"], s["process_count"],
                s["global_device_count"], s["platform"]) == (r, 2, 2, "cpu")


def test_divergent_collective_fails_the_barrier(ranks):
    outs, _ = ranks
    assert "divergent programs" in outs[0]["divergent"]
    assert "got 3, want 2" in outs[0]["divergent"]
    assert outs[1]["divergent_peer_total"] == 3.0


def test_dist_snapshot_identical_on_both_ranks(ranks):
    outs, tmp = ranks
    assert outs[0]["snapshot"] == outs[1]["snapshot"]
    _, j_regs = _both_registries((0, 1))
    want = jobs.merge_snapshots(j_regs[0].snapshot(), j_regs[1].snapshot())
    assert outs[0]["snapshot"] == jobs.snapshot_json(want)
    # rank 0 alone commits the report
    assert outs[1]["metrics_file"] == "None"
    written = json.loads(pathlib.Path(outs[0]["metrics_file"]).read_text())
    assert jobs.snapshot_json(written) == jobs.snapshot_json(want)


def test_preemption_drain_barrier_in_two_ranks(ranks):
    outs, _ = ranks
    assert [o["drain_barriers"] for o in outs] == [1, 1]


@pytest.mark.parametrize("m", [0, 1])
def test_format2_each_rank_writes_only_its_slices(ranks, m):
    outs, _ = ranks
    mesh = CKPT_MESHES[m]
    axis = "data" if mesh["data"] > 1 else "model"
    tree = ckpt_tree()
    specs = ckpt_specs(tree, axis)
    for r, o in enumerate(outs):
        recs = {rec["key"]: rec for rec in o["ckpt"][m]["records"]}
        assert o["ckpt"][m]["members"] == sorted(rec["npz"] for rec in
                                                 recs.values())
        # sharded leaves: exactly this rank's box; others: rank 0 only
        assert recs["w"]["index"] == shard_index(specs["w"], (8, 16), mesh, r)
        assert recs["qt/__qt_packed"]["index"] == shard_index(
            specs["qt"].packed, tuple(tree["qt"].packed.shape), mesh, r)
        assert ("step" in recs) == (r == 0)
        assert ("qt/__qt_meta" in recs) == (r == 0)
        assert ("t/__1/__none" in recs) == (r == 0)
        # "b" shards over "model" only: on the data mesh it is replicated
        # over "data", so rank 0 (data coordinate 0) writes it whole
        assert ("b" in recs) == (axis == "model" or r == 0)


@pytest.mark.parametrize("m", [0, 1])
def test_format2_remesh_and_whole_restore_bit_for_bit(ranks, m):
    outs, _ = ranks
    for o in outs:
        res = o["ckpt"][m]
        assert all(res["remesh_equal"].values()), res["remesh_equal"]
        assert res["whole_equal"] and res["manifest_hosts"] == 2


@pytest.mark.parametrize("m", [0, 1])
def test_reference_reads_the_ports_format2_files(ranks, m):
    outs, _ = ranks
    tree = ckpt_tree()
    got, manifest = jck.restore_sharded_checkpoint(outs[0]["ckpt"][m]["dir"],
                                                   1, None)
    assert manifest["format"] == 2 and manifest["hosts"] == 2
    np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got["qt"].packed),
                                  tree["qt"].packed.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(got["qt"].scale),
                                  tree["qt"].scale.numpy())
    np.testing.assert_array_equal(
        np.asarray(got["b"]).astype(np.float32), tree["b"].float().numpy())
    np.testing.assert_array_equal(np.asarray(got["t"][0]),
                                  tree["t"][0].numpy())
    assert got["t"][1] is None and int(got["step"]) == 3


def test_format2_retention_across_two_hosts(ranks):
    outs, _ = ranks
    for o in outs:
        gc = o["gc"]
        # keep 2: step 1's directory (with a shrunk-away host's stale
        # files) is gone; step 4 committed over a stale own shard manifest
        assert gc["dirs"] == ["step_00000003", "step_00000004"], gc
        assert gc["steps"] == [3, 4]
        assert gc["restored_equal"] and gc["step"] == 4
