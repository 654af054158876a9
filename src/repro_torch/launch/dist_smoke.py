"""Multi-process smoke: real ``torch.distributed`` bring-up, mapped-island
parity, metrics aggregation, sharded-checkpoint re-mesh (the reference's
``repro.launch.dist_smoke``). Run one process per rank against one
coordinator, here two on the CPU over gloo:

    PYTHONPATH=src python -m repro_torch.launch.dist_smoke \\
        --coordinator 127.0.0.1:29512 --num-processes 2 --process-id 1 \\
        --ckpt-dir /tmp/dist_ckpt --device cpu &
    ... the same with --process-id 0 ...

Each process asserts, and exits non-zero on any failure:

  1. bring-up: ``dist.runtime.initialize`` + the all-reduce ``barrier()``;
  2. mapped-island parity: a small ``mapped=True`` search, one island per
     rank, must reproduce the sequential engine's ``islands=world`` run
     BIT FOR BIT (histories, final loss, migrations, π; the sequential run
     is process-local compute, so it doubles as the reference);
  3. obs aggregation: each rank fills a registry with rank-skewed values;
     ``obs.dist_snapshot()`` must merge them (counters summed, gauges
     min/max/sum, histogram buckets added) into byte-identical snapshots
     on every rank, with rank 0 writing the merged report;
  4. sharded checkpoint: a tree (dense + QTensor leaves) sharded over a
     {"data": 1, "model": world} mesh shape is saved with each rank
     writing ONLY its slices, then restored onto a DIFFERENT mesh shape
     ({"data": world, "model": 1}) and onto whole tensors; both must equal
     the original bit for bit.

One process per device (PyTorch's idiom): 2 processes run 2 islands,
where the reference's lane ran 4 on 2 processes x 2 forced devices.
``--num-processes 1`` (the default) runs the same checks alone, a world of
one with 1 island. ``--device cuda`` puts rank r on ``cuda:{r % cards}``
over NCCL; ``--backend gloo`` overrides (two ranks sharing one card).
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import torch

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
            n_kv_heads=4, max_seq_len=256)


def _check_mapped_parity(steps: int, migrate_every: int, population: int,
                         dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.dist import runtime
    from repro_torch.models.model import init_params
    from repro_torch.search import run as run_search

    cfg = get_config("opt-tiny").reduced(**TINY)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    calib = torch.randint(0, cfg.vocab_size, (2, 64),
                          generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    qcfg = QuantConfig(bits=2, group_size=32)
    n_islands = runtime.process_count()
    scfg = SearchConfig(steps=steps, seed=0, n_match_layers=2, log_every=0,
                        islands=n_islands, migrate_every=migrate_every,
                        population=population)

    r_map = run_search(params, params, cfg, qcfg, calib,
                       dataclasses.replace(scfg, mapped=True))
    r_seq = run_search(params, params, cfg, qcfg, calib, scfg)
    if r_seq.island_histories != r_map.island_histories:
        for i, (a, b) in enumerate(zip(r_seq.island_histories,
                                       r_map.island_histories)):
            for ea, eb in zip(a, b):
                if ea != eb:
                    raise AssertionError(
                        f"mapped-island divergence at island {i}: "
                        f"sequential {ea} vs mapped {eb}")
        raise AssertionError("mapped-island histories differ in length")
    assert r_seq.final_loss == r_map.final_loss
    assert r_seq.stats["migrations"] == r_map.stats["migrations"]
    assert torch.equal(r_seq.transforms.pi, r_map.transforms.pi)
    print(f"[dist_smoke] mapped parity OK: {n_islands} islands x "
          f"{steps} steps, {r_map.stats['migrations']} migrations, "
          f"loss {r_map.initial_loss:.4f}->{r_map.final_loss:.4f}",
          flush=True)


def _check_obs_aggregation(metrics_out: str = None):
    """Every rank contributes a rank-skewed registry; ``dist_snapshot()``
    must give the SAME merged snapshot on every rank, counters summed,
    gauges min/max/sum-merged and histogram buckets added exactly. Rank 0
    commits the report."""
    import json

    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.dist import runtime

    pid, nproc = runtime.process_index(), runtime.process_count()
    reg = obs.Registry()
    # rank-dependent values so a "merge" that is secretly a local snapshot
    # (or that double-counts a rank) cannot pass the sum checks
    reg.counter("smoke_widgets_total", "per-host counter").inc(10 + pid)
    reg.counter("smoke_labelled_total", "labelled counter").inc(
        2, host=f"h{pid}")
    reg.gauge("smoke_depth", "per-host gauge").set(float(pid))
    h = reg.histogram("smoke_lat_seconds", "per-host histogram",
                      buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5 + pid)     # rank 0 lands in bucket 1, rank >= 1 in +Inf

    snap = obs.dist_snapshot(reg)
    blob = obs.snapshot_json(snap)

    want_widgets = sum(10 + p for p in range(nproc))
    got_widgets = snap["smoke_widgets_total"]["series"][0]["value"]
    assert got_widgets == want_widgets, \
        f"counter merge: {got_widgets} != {want_widgets}"
    assert len(snap["smoke_labelled_total"]["series"]) == nproc, \
        "labelled series lost in the merge"
    g = snap["smoke_depth"]["series"][0]
    assert (g["min"], g["max"], g["n"]) == (0.0, float(nproc - 1), nproc), \
        f"gauge merge: {g}"
    hs = snap["smoke_lat_seconds"]["series"][0]
    assert hs["count"] == 2 * nproc and hs["counts"][0] == nproc, \
        f"histogram merge: {hs}"

    # cross-rank identity: every rank's JSON of the MERGED snapshot
    peers = [None] * nproc
    if nproc > 1:
        dist.all_gather_object(peers, blob)
    else:
        peers = [blob]
    assert len(set(peers)) == 1, "merged snapshots differ across ranks"

    if metrics_out:
        p = obs.write_snapshot(snap, path=metrics_out)
        if p is not None:   # rank 0 only
            back = json.loads(p.read_text())
            assert back["smoke_widgets_total"]["series"][0]["value"] == \
                want_widgets
    print(f"[dist_smoke] obs aggregation OK: {nproc} process(es), "
          f"widgets={int(got_widgets)}, identical snapshots on all hosts",
          flush=True)


def _check_sharded_ckpt(ckpt_dir: str, dev):
    import numpy as np

    from repro_torch.ckpt.checkpoint import (restore_sharded_checkpoint,
                                             save_sharded_checkpoint)
    from repro_torch.core.quant import QTensor, QuantConfig, quantize_tensor
    from repro_torch.dist import runtime
    from repro_torch.dist.sharding import shard_of

    n, rank = runtime.process_count(), runtime.process_index()
    save_mesh = {"data": 1, "model": n}
    load_mesh = {"data": n, "model": 1}

    rng = np.random.default_rng(7)
    w_full = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    qt_src = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    qt = quantize_tensor(qt_src, QuantConfig(bits=2, group_size=32))
    t_full = torch.arange(2 * n, dtype=torch.float32)
    tree = {"w": w_full.to(dev), "qt": qt.to(dev),
            "t": (t_full.to(dev), None)}
    qspec = (None, "model")
    specs = {"w": ("data", "model"),
             "qt": QTensor(qspec, qspec, qspec, qt.bits, qt.group_size,
                           qt.shape),
             "t": (("model",), None)}
    save_sharded_checkpoint(ckpt_dir, 1, tree, specs=specs, mesh=save_mesh)
    runtime.barrier("ckpt-saved")

    # re-mesh: this rank's slices on the other mesh shape
    lspec = (None, "data")
    lspecs = {"w": ("data", None),
              "qt": QTensor(lspec, lspec, lspec, qt.bits, qt.group_size,
                            qt.shape),
              "t": (("data",), None)}
    restored, manifest = restore_sharded_checkpoint(
        ckpt_dir, 1, specs=lspecs, mesh=load_mesh, device=dev)
    assert manifest["step"] == 1 and manifest["format"] == 2
    assert manifest["hosts"] == n

    def same(got, full, spec):
        want = shard_of(full, spec, load_mesh, rank)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), \
            f"re-meshed slice differs ({spec})"

    same(restored["w"], w_full, lspecs["w"])
    for c in ("packed", "scale", "zero"):
        same(getattr(restored["qt"], c), getattr(qt, c), lspec)
    same(restored["t"][0], t_full, ("data",))
    assert restored["t"][1] is None

    # degenerate re-mesh: whole tensors
    whole, _ = restore_sharded_checkpoint(ckpt_dir, 1, device=dev)
    assert torch.equal(whole["w"].cpu(), w_full)
    for c in ("packed", "scale", "zero"):
        assert torch.equal(getattr(whole["qt"], c).cpu(), getattr(qt, c))
    assert torch.equal(whole["t"][0].cpu(), t_full)
    runtime.barrier("ckpt-restored")
    print(f"[dist_smoke] sharded ckpt OK: saved on {save_mesh}, "
          f"restored onto {load_mesh} + whole", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (e.g. 127.0.0.1:29512)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--migrate-every", type=int, default=2)
    ap.add_argument("--population", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl for cuda, gloo for cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="SHARED directory for the sharded-checkpoint phase "
                         "(all processes must see the same files)")
    ap.add_argument("--metrics-out", default=None,
                    help="merged metrics snapshot path for the obs phase "
                         "(rank 0 writes; default: no file)")
    args = ap.parse_args(argv)

    from repro_torch.dist import runtime
    runtime.initialize(args.coordinator, args.num_processes, args.process_id,
                       device=args.device, backend=args.backend)
    dev = runtime.local_device(args.device)
    print(f"[dist_smoke] {runtime.device_summary()}", flush=True)
    if args.num_processes > 1:
        assert runtime.process_count() == args.num_processes, \
            f"expected {args.num_processes} processes, got " \
            f"{runtime.process_count()}"
    runtime.barrier("bring-up")
    print(f"[dist_smoke] barrier OK across {runtime.global_device_count()} "
          f"devices", flush=True)

    _check_mapped_parity(args.steps, args.migrate_every, args.population, dev)

    _check_obs_aggregation(args.metrics_out)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="dist_smoke_ckpt_")
    _check_sharded_ckpt(ckpt_dir, dev)

    print(f"DIST_SMOKE_OK process={runtime.process_index()}/"
          f"{runtime.process_count()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
