"""Rank bodies for the port's multi-process tests (``tests/test_torch_dist_*``),
run by ``helpers.dist_ranks.run_ranks``. Torch and the port only — no JAX —
so a spawned rank starts quickly; the tests hold what the ranks return
against the JAX reference in the test process.

Every input comes from a numpy seed (``collective_inputs``,
``paged_inputs``), the same call in the ranks and in the test, stacked
with one leading row per rank as the reference's ``jax.vmap(...,
axis_name=...)`` wants it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

PSUM_CASES = ((8, 32), (8, 64), (4, 32))   # (bits, group) of compressed_psum
PSUM_SHAPE = (5, 37)                        # 185 values: pads at every case
TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
            n_kv_heads=4, max_seq_len=256)
PSZ = 4                                     # page size of the paged cases
PAGED_CASES = (  # (name, H, Hkv, Dh, pages a rank, global lengths, dtype)
    ("mha", 4, 4, 16, 3, (24, 12, 7, 13), "float32"),
    ("gqa", 4, 2, 16, 3, (5, 19, 12, 1), "float32"),
    ("gqa-bf16", 4, 2, 16, 3, (24, 9, 3, 17), "bfloat16"),
)


def collective_inputs(world: int) -> dict:
    """Per-rank inputs of the collective checks (leading axis: rank)."""
    rng = np.random.default_rng(100 + world)
    ties = np.array([3.0, 1.0, 1.0, 2.0][:world] if world > 2
                    else [1.0, 1.0], np.float32)
    return {
        "argmin": rng.normal(size=(world,)).astype(np.float32),
        "argmin_ties": ties,
        "tree_v": rng.normal(size=(world, 3, 4)).astype(np.float32),
        "tree_w": rng.integers(0, 9, size=(world, 5)).astype(np.int32),
        "psum": rng.normal(size=(world,) + PSUM_SHAPE).astype(np.float32),
        # contiguous decode: B 2, S 8 a rank, H 4, Dh 16; kv_len 5 masks
        # every shard but the first
        "q": rng.normal(size=(2, 4, 16)).astype(np.float32),
        "k": rng.normal(size=(world, 2, 8, 4, 16)).astype(np.float32),
        "v": rng.normal(size=(world, 2, 8, 4, 16)).astype(np.float32),
        "kv_lens": (5, 8 * world - 3),
    }


def paged_inputs(world: int, H, Hkv, Dh, pages, lens, seed=7) -> dict:
    """A global paged cache split into ``world`` per-rank pools: rank r
    holds pages [r·pages, (r+1)·pages) of every sequence in its own pool
    (page 0 of each pool unused), with local lengths. Returns the stacked
    per-rank pools / tables / lengths, q, and the whole cache in one pool."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    per = pages * PSZ
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    kv = rng.normal(size=(2, B, world * per, Hkv, Dh)).astype(np.float32)
    n_pool = B * pages + 1
    kp = np.zeros((world, n_pool, PSZ, Hkv, Dh), np.float32)
    vp = np.zeros_like(kp)
    bt = np.zeros((world, B, pages), np.int32)
    ln = np.zeros((world, B), np.int32)
    for r in range(world):
        order = rng.permutation(B * pages) + 1
        for b in range(B):
            for p in range(pages):
                page = order[b * pages + p]
                bt[r, b, p] = page
                rows = slice(r * per + p * PSZ, r * per + (p + 1) * PSZ)
                kp[r, page] = kv[0, b, rows]
                vp[r, page] = kv[1, b, rows]
            ln[r, b] = min(max(lens[b] - r * per, 0), per)
    whole_k = np.concatenate([np.zeros((1, PSZ, Hkv, Dh), np.float32),
                              kv[0].reshape(-1, PSZ, Hkv, Dh)])
    whole_v = np.concatenate([np.zeros((1, PSZ, Hkv, Dh), np.float32),
                              kv[1].reshape(-1, PSZ, Hkv, Dh)])
    whole_bt = (1 + np.arange(B * world * pages, dtype=np.int32)).reshape(
        B, world * pages)
    return {"q": q, "kp": kp, "vp": vp, "bt": bt, "lens": ln,
            "whole": (whole_k, whole_v, whole_bt,
                      np.asarray(lens, np.int32))}


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def collective_checks(rank, world):
    """argmin_allgather (ties included), elite_broadcast, compressed_psum,
    sharded_decode_attention and sharded_paged_decode_attention on this
    rank's row of the seeded inputs."""
    from repro_torch.dist import attention, collectives

    x = collective_inputs(world)
    out = {}
    for name in ("argmin", "argmin_ties"):
        v, i = collectives.argmin_allgather(torch.tensor(x[name][rank]))
        out[name] = (float(v), i)
    tree = {"v": torch.tensor(x["tree_v"][rank]),
            "w": (torch.tensor(x["tree_w"][rank]), None)}
    out["broadcast"] = {}
    for owner in range(world):
        got = collectives.elite_broadcast(tree, owner)
        out["broadcast"][owner] = (got["v"].numpy(), got["w"][0].numpy(),
                                   got["w"][1])
    out["psum"] = {}
    for bits, g in PSUM_CASES:
        got = collectives.compressed_psum(torch.tensor(x["psum"][rank]),
                                          bits=bits, group_size=g)
        out["psum"][bits, g] = got.numpy()
    out["decode"] = {}
    for kv_len in x["kv_lens"]:
        got = attention.sharded_decode_attention(
            torch.tensor(x["q"]), torch.tensor(x["k"][rank]),
            torch.tensor(x["v"][rank]), shard_start=rank * 8, kv_len=kv_len)
        out["decode"][kv_len] = got.numpy()
    out["paged"] = {}
    for name, H, Hkv, Dh, pages, lens, dtype in PAGED_CASES:
        c = paged_inputs(world, H, Hkv, Dh, pages, lens)
        cast = _bf16 if dtype == "bfloat16" else torch.from_numpy
        for mp in ((1, 2) if H > Hkv else (1,)):
            got = attention.sharded_paged_decode_attention(
                torch.from_numpy(c["q"]), cast(c["kp"][rank]),
                cast(c["vp"][rank]), torch.from_numpy(c["bt"][rank]),
                torch.from_numpy(c["lens"][rank]), gqa_pages_per_block=mp)
            out["paged"][name, mp] = got.numpy()
    return out


# ---------------------------------------------------------------------------
# runtime, obs and format-2 checkpoints (2 ranks)
# ---------------------------------------------------------------------------

def skewed_registry(obs, pid):
    """A registry with rank-skewed counters, labels, gauges and histograms
    (as the reference's dist_smoke fills one)."""
    reg = obs.Registry()
    reg.counter("smoke_widgets_total", "per-host counter").inc(10 + pid)
    reg.counter("smoke_labelled_total", "labelled counter").inc(
        2, host=f"h{pid}")
    reg.gauge("smoke_depth", "per-host gauge").set(float(pid))
    h = reg.histogram("smoke_lat_seconds", "per-host histogram",
                      buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5 + pid)
    return reg


def ckpt_tree():
    """Dense, QTensor, tuple and None leaves (seeded), and the component
    spec of its QTensor on a given axis."""
    from repro_torch.core.quant import QuantConfig, quantize_tensor
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    qt = quantize_tensor(
        torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)),
        QuantConfig(bits=2, group_size=32))
    b = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)).to(
        torch.bfloat16)
    return {"w": w, "qt": qt, "t": (torch.arange(8, dtype=torch.float32),
                                    None), "b": b, "step": torch.tensor(3)}


def ckpt_specs(tree, axis):
    from repro_torch.core.quant import QTensor
    qt = tree["qt"]
    q = (None, axis)
    return {"w": ("data", "model"),
            "qt": QTensor(q, q, q, qt.bits, qt.group_size, qt.shape),
            "t": ((axis,), None), "b": (None, "model"), "step": ()}


CKPT_MESHES = ({"data": 2, "model": 1}, {"data": 1, "model": 2})


def _npz_members(path):
    with np.load(path) as z:
        return sorted(z.files)


def runtime_checks(rank, world, tmp):
    """The barrier, a divergent collective, dist_snapshot, the preemption
    drain and 2-rank format-2 checkpoints (save on each mesh shape, remesh
    onto the other and onto whole tensors, gc across two hosts with a stale
    host file, and a stale own file of an uncommitted earlier attempt)."""
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.ckpt.checkpoint import (CheckpointManager, list_steps,
                                             save_sharded_checkpoint)
    from repro_torch.dist import runtime
    from repro_torch.dist.fault import PreemptionGuard, remesh_restore
    from repro_torch.dist.sharding import shard_of

    tmp = pathlib.Path(tmp)
    out = {"summary": runtime.device_summary(),
           "distributed": runtime.is_distributed()}
    runtime.barrier("bring-up")
    # a peer running a different collective: rank 1 contributes 2 to the
    # all-reduce rank 0's barrier is waiting in
    if rank == 0:
        try:
            runtime.barrier("divergent")
            out["divergent"] = None
        except RuntimeError as e:
            out["divergent"] = str(e)
    else:
        two = torch.full((1,), 2.0)
        dist.all_reduce(two)
        out["divergent_peer_total"] = float(two)
    runtime.barrier("after")

    reg = skewed_registry(obs, rank)
    out["snapshot"] = obs.snapshot_json(obs.dist_snapshot(reg))
    out["metrics_file"] = str(obs.write_snapshot(
        registry=reg, path=tmp / "metrics.json"))

    h = obs.histogram("dist_barrier_seconds", "Barrier wait latency")
    before = h.count()
    with PreemptionGuard() as guard:
        guard.drain(None, 4, {})
    out["drain_barriers"] = h.count() - before

    tree = ckpt_tree()
    out["ckpt"] = {}
    for m, mesh in enumerate(CKPT_MESHES):
        d = tmp / f"ck{m}"
        axis = "data" if mesh["data"] > 1 else "model"
        specs = ckpt_specs(tree, axis)
        save_sharded_checkpoint(d, 1, tree, specs=specs, mesh=mesh)
        runtime.barrier("saved")
        other = CKPT_MESHES[1 - m]
        oaxis = "data" if other["data"] > 1 else "model"
        ospecs = ckpt_specs(tree, oaxis)
        mgr = CheckpointManager(d, sharded=True, device="cpu")
        got, manifest = remesh_restore(mgr, ospecs, mesh_shape=other)
        whole, _ = remesh_restore(mgr)
        flat = {"w": (got["w"], tree["w"], ospecs["w"]),
                "b": (got["b"], tree["b"], ospecs["b"]),
                "t": (got["t"][0], tree["t"][0], ospecs["t"][0])}
        for c in ("packed", "scale", "zero"):
            flat[c] = (getattr(got["qt"], c), getattr(tree["qt"], c),
                       getattr(ospecs["qt"], c))
        out["ckpt"][m] = {
            "dir": str(d),
            "members": _npz_members(d / "step_00000001" /
                                    f"host{rank:04d}.npz"),
            "records": json.loads((d / "step_00000001" /
                                   f"shards_host{rank:04d}.json").read_text()
                                  )["shards"],
            "remesh_equal": {k: bool(g.dtype == t.dtype and torch.equal(
                g, shard_of(t, s, other, rank))) for k, (g, t, s)
                in flat.items()},
            "whole_equal": bool(
                all(torch.equal(whole[k], tree[k]) for k in ("w", "b",
                                                             "step"))
                and all(torch.equal(getattr(whole["qt"], c),
                                    getattr(tree["qt"], c))
                        for c in ("packed", "scale", "zero"))
                and whole["t"][1] is None and whole["qt"].shape ==
                tree["qt"].shape),
            "manifest_hosts": manifest["hosts"]}
        runtime.barrier("restored")

    # retention across two hosts, a stale file of a shrunk-away host, and a
    # stale own file of an uncommitted earlier attempt at step 4
    gd = tmp / "gc"
    mesh = CKPT_MESHES[0]
    specs = ckpt_specs(tree, "data")
    mgr = CheckpointManager(gd, keep=2, sharded=True, device="cpu",
                            specs=specs, mesh=mesh)
    for step in (1, 2, 3):
        if step == 2 and rank == 0:
            s1 = gd / "step_00000001"
            for f in ("host0002.npz", "shards_host0002.json"):
                (s1 / f).write_text("stale")
        mgr.save(step, tree)
        mgr.wait()
        runtime.barrier(f"gc-{step}")
    s4 = gd / "step_00000004"
    s4.mkdir(parents=True, exist_ok=True)
    (s4 / f"shards_host{rank:04d}.json").write_text(
        json.dumps({"host": rank, "shards": []}))
    runtime.barrier("stale")
    mgr.save(4, tree)
    mgr.wait()
    runtime.barrier("gc-4")
    restored, manifest = mgr.restore(4)
    out["gc"] = {"steps": list_steps(gd),
                 "dirs": sorted(p.name for p in gd.glob("step_*")),
                 "restored_equal": bool(torch.equal(restored["w"],
                                                    tree["w"])),
                 "step": manifest["step"]}
    return out


# ---------------------------------------------------------------------------
# mapped search (2 ranks)
# ---------------------------------------------------------------------------

SEARCH_RUNS = ((1, False), (3, False), (1, True), (3, True))  # (K, shard)


def _tiny_search_inputs():
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("opt-tiny").reduced(**TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = torch.randint(0, cfg.vocab_size, (4, 32),
                          generator=torch.Generator().manual_seed(1))
    return cfg, params, calib


def _summary(r):
    return {"histories": r.island_histories, "final_loss": r.final_loss,
            "initial_loss": r.initial_loss,
            "migrations": r.stats["migrations"],
            "uphill": r.stats["uphill_accepts"],
            "pi": r.transforms.pi.numpy(), "s": r.transforms.s.numpy(),
            "phi": r.transforms.phi.numpy(),
            "up": r.params_q["blocks"]["mlp"]["up"].numpy(),
            "mapped": r.stats["mapped"]}


def search_checks(rank, world, tmp):
    """Mapped (one island per rank) and, on rank 0, the sequential
    ``islands=world`` run of each ``SEARCH_RUNS`` case, 3 steps, migration
    every 2; the ``launch.search --mapped`` CLI with its registry merged."""
    from repro_torch import obs
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.launch import search as launch
    from repro_torch.search import run as run_search

    cfg, params, calib = _tiny_search_inputs()
    qcfg = QuantConfig(bits=2, group_size=32)
    out = {"runs": {}}
    for K, shard in SEARCH_RUNS:
        scfg = SearchConfig(steps=3, seed=0, n_match_layers=2, log_every=0,
                            islands=world, migrate_every=2, population=K,
                            shard_calib=shard)
        obs.get_registry().reset()
        r_map = run_search(params, params, cfg, qcfg, calib,
                           dataclasses.replace(scfg, mapped=True))
        snap = obs.dist_snapshot()
        res = {"mapped": _summary(r_map),
               "proposals": _counter(snap, "search_proposals_total"),
               "accepts_local": obs.counter("search_accepts_total").total(),
               "migrations_metric": _counter(snap, "search_migrations_total")}
        if rank == 0:
            res["sequential"] = _summary(run_search(
                params, params, cfg, qcfg, calib, scfg))
        out["runs"][K, shard] = res
    bench = pathlib.Path(tmp) / "bench.json"
    metrics = pathlib.Path(tmp) / "metrics.json"
    obs.get_registry().reset()
    launch.main(["--steps", "3", "--islands", str(world), "--mapped",
                 "--population", "2", "--migrate-every", "2", "--seqs", "2",
                 "--seq-len", "32", "--out", str(bench),
                 "--metrics-out", str(metrics)], device="cpu")
    out["cli"] = {"bench_exists": bench.exists(),
                  "rows": json.loads(bench.read_text()) if rank == 0 else None,
                  "metrics": (json.loads(metrics.read_text()) if rank == 0
                              else None)}
    return out


def _counter(snap, name):
    entry = snap.get(name)
    return sum(s["value"] for s in entry["series"]) if entry else 0.0

