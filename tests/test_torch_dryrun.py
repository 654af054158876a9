"""Port parity: the dry run's cells and inputs (``repro_torch.launch.steps``'
``SHAPES`` / ``input_specs`` / ``*_structs``, ``launch.mesh``,
``launch.roofline``, ``launch.dryrun``, ``launch.report``) against the JAX
reference, and the fake-tensor trace against a real CPU run.

Bars:
- ``SHAPES``, ``shape_applicable``, ``model_flops`` and the report's tables
  on the same records: equal (the tables byte for byte);
- the fake input trees: every leaf's shape and dtype equal to the
  reference's ``jax.eval_shape`` structs, leaf for leaf (packed words are
  the reference's uint32 bits in int32; the decode index is a host int);
- the fake trace of a reduced config's train / prefill / decode step
  against the same step on real CPU tensors: FLOPs equal; the live peak
  within 512 bytes (one allocator block: a lifted constant); the eager
  bytes within 2e-2 (PyTorch decomposes a few composite ops another way on
  fake tensors: ``one_hot`` without its host range check, a decode
  step's ``matmul`` into ``bmm`` where the real run folds it into ``mm``);
- ``run_cell`` on reduced configs: ``ok``, the per-device argument bytes
  equal to each leaf's bytes over the mesh axes its spec names, and a
  linearity gap of 0.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import frontends as jfrontends
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.core.quant import QTensor, QuantConfig
from repro_torch.dist.sharding import (ShardingRules, opt_state_specs,
                                       param_specs)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, report, roofline, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import frontends
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = ("opt-tiny", "qwen3-4b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
            "zamba2-7b", "seamless-m4t-medium", "internvl2-1b")
# small stand-ins for SHAPES (the batch divides the 16-way data axis)
SMALL_SHAPES = {
    "train_4k": dict(seq=32, batch=16, kind="train"),
    "prefill_32k": dict(seq=32, batch=16, kind="prefill"),
    "decode_32k": dict(seq=32, batch=16, kind="decode"),
    "long_500k": dict(seq=64, batch=1, kind="decode"),
}


def tleaves(x):
    """The port's tree in ``jax.tree.leaves`` order (sorted keys; a QTensor
    by packed, scale, zero; a host int as a 0-d int32)."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in tleaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in tleaves(y)]
    if isinstance(x, QTensor):
        return [x.packed, x.scale, x.zero]
    if x is None:
        return []
    if isinstance(x, int):
        return [torch.zeros((), dtype=torch.int32)]
    return [x]


def assert_same_structs(jtree, ttree, what):
    jl, tl = jax.tree.leaves(jtree), tleaves(ttree)
    assert len(jl) == len(tl), (what, len(jl), len(tl))
    for i, (a, b) in enumerate(zip(jl, tl)):
        jd = np.dtype(a.dtype).name.replace("uint32", "int32")
        assert tuple(a.shape) == tuple(b.shape), (what, i, a.shape, b.shape)
        assert jd == str(b.dtype).replace("torch.", ""), (what, i, jd,
                                                            b.dtype)


def test_shapes_and_applicability_equal_reference():
    assert steps.SHAPES == jsteps.SHAPES
    for arch in tlist_archs(assigned_only=False):
        for shape in steps.SHAPES:
            assert steps.shape_applicable(tget_config(arch), shape) == \
                jsteps.shape_applicable(jget_config(arch), shape), \
                (arch, shape)


@pytest.mark.parametrize("arch", jlist_archs())
def test_input_specs_equal_reference_structs(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for shape in steps.SHAPES:
        if not steps.shape_applicable(tcfg, shape):
            continue
        jkind, jargs = jsteps.input_specs(jcfg, shape)
        tkind, targs = steps.input_specs(tcfg, shape, device="meta")
        assert tkind == jkind
        assert_same_structs(jargs, targs, (arch, shape))
        if tkind == "decode":
            assert targs[3] == steps.SHAPES[shape]["seq"] - 1


@pytest.mark.parametrize("arch", jlist_archs())
def test_struct_builders_equal_reference(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert_same_structs(jsteps.param_structs(jcfg),
                        steps.param_structs(tcfg, device="meta"), "params")
    assert_same_structs(jsteps.opt_structs(jcfg),
                        steps.opt_structs(tcfg, device="meta"), "opt")
    from repro.core.quant import QuantConfig as JQuantConfig
    assert_same_structs(jsteps.qparam_structs(jcfg, JQuantConfig(2, 32)),
                        steps.qparam_structs(tcfg, QuantConfig(2, 32),
                                             device="meta"), "qparams")
    assert_same_structs(jsteps.cache_structs(jcfg, 4, 64),
                        steps.cache_structs(tcfg, 4, 64, device="meta"),
                        "cache")
    if tcfg.block_pattern in ("dense", "moe"):
        assert_same_structs(jsteps.paged_pool_structs(jcfg, 8, 16),
                            steps.paged_pool_structs(tcfg, 8, 16,
                                                     device="meta"),
                            "pools")
    t = frontends.frontend_spec(tcfg, 2, 7)
    j = jfrontends.frontend_spec(jcfg, 2, 7)
    assert tuple(t.shape) == tuple(j.shape)
    assert str(t.dtype).replace("torch.", "") == np.dtype(j.dtype).name
    assert t.device.type == "cuda"   # the card's route; nothing allocated


def test_fake_builders_default_to_the_card_route():
    dev = steps.fake_device()
    assert dev == ("cuda" if torch.backends.cuda.is_built() else "meta")
    p = steps.param_structs(tget_config("opt-tiny"))
    assert all(x.device.type == dev for x in tleaves(p))


def test_production_mesh_is_the_reference_pod_shape():
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16,
                                                    "model": 16}


@pytest.mark.parametrize("arch", jlist_archs(assigned_only=False))
def test_model_flops_equal_reference(arch):
    for n, train in ((1000, True), (4096, False)):
        assert roofline.model_flops(tget_config(arch), n, train) == \
            jroofline.model_flops(jget_config(arch), n, train)


def test_roofline_terms_and_extrapolation():
    """tests/test_roofline.py's cases at the H100's figures."""
    hw = roofline.HW
    t = roofline.roofline_terms(flops_dev=hw["peak_flops"],
                                bytes_dev=hw["hbm_bw"] * 2,
                                coll_dev=hw["link_bw"] * 0.5)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["dominant"] == "memory_s"
    assert t["overlap_fraction"] == pytest.approx(2.0 / 3.5)
    t = roofline.roofline_terms(hw["peak_flops"] * 3, hw["hbm_bw"], None)
    assert t["collective_s"] is None and t["dominant"] == "compute_s"
    assert t["overlap_fraction"] == pytest.approx(3.0 / 4.0)

    def f(L):
        return 7 + 3 * L
    assert roofline.extrapolate(f(2), f(3), 2, 3, 24) == pytest.approx(f(24))
    assert roofline.extrapolate(5.0, 11.0, 2, 4, 10) == \
        jroofline.extrapolate(5.0, 11.0, 2, 4, 10)
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 450e9}


# ---------------------------------------------------------------------------
# the fake trace against a real run
# ---------------------------------------------------------------------------

def _small_args(cfg, kind, fake, B=2, S=16):
    gen = None if fake else torch.Generator().manual_seed(0)
    p = M.init_params(cfg, gen, device="cpu")
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.zeros(B, cfg.frontend_len, cfg.d_model)
    if cfg.is_enc_dec:
        batch["enc_embeds"] = torch.zeros(B, 12, cfg.d_model)
    if kind == "train":
        return (p, adamw_init(p), batch)
    from repro_torch.quantized.qmodel import pack_model
    pq = pack_model(p, QuantConfig(2, 32))
    if kind == "prefill":
        return (pq, batch)
    cache = M.init_cache(cfg, B, S, device="cpu")
    if cfg.is_enc_dec:
        cache["cross"] = tuple(torch.zeros(
            (cfg.n_layers, B, 12, cfg.n_kv_heads, cfg.resolved_head_dim))
            for _ in range(2))
    return (pq, batch["tokens"][:, :1], cache, S - 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_fake_trace_counts_equal_a_real_cpu_run(arch):
    cfg = tget_config(arch).reduced()
    for kind in ("train", "prefill", "decode"):
        step = {"train": steps.make_train_step(
                    dataclasses.replace(cfg, remat=True)),
                "prefill": steps.make_prefill_step(
                    cfg, 16 + (cfg.frontend_len if cfg.frontend == "vision"
                               else 0)),
                "decode": steps.make_serve_step(cfg)}[kind]
        mode = steps.new_fake_mode()
        with mode:
            fake_args = _small_args(cfg, kind, fake=True)
        fake = dryrun.trace_step(step, fake_args, mode)
        real = dryrun.trace_step(step, _small_args(cfg, kind, fake=False))
        assert fake["flops"] == real["flops"] > 0, (arch, kind)
        assert fake["argument_bytes"] == real["argument_bytes"]
        assert abs(fake["peak_bytes"] - real["peak_bytes"]) <= 512, \
            (arch, kind, fake["peak_bytes"], real["peak_bytes"])
        assert fake["bytes"] == pytest.approx(real["bytes"], rel=2e-2)
        assert fake["collectives"] == real["collectives"] == {}


def test_remat_lowers_the_traced_peak():
    """The train step's live peak and FLOPs under each remat policy:
    recomputing saves memory and costs the recomputed FLOPs; "dots" saves
    the non-batched matmuls' outputs (recomputing attention's), "dots_all"
    every matmul's (recomputing none)."""
    cfg = tget_config("qwen3-4b").reduced(n_layers=4)
    peaks, flops = {}, {}
    for pol in ("off", "full", "dots", "dots_all"):
        c = cfg if pol == "off" else dataclasses.replace(cfg, remat=True,
                                                         remat_policy=pol)
        mode = steps.new_fake_mode()
        with mode:
            args = _small_args(c, "train", fake=True, B=8, S=128)
        r = dryrun.trace_step(steps.make_train_step(c), args, mode)
        peaks[pol], flops[pol] = r["peak_bytes"], r["flops"]
    assert peaks["full"] < peaks["dots"] <= peaks["dots_all"] < peaks["off"]
    assert flops["off"] == flops["dots_all"] < flops["dots"] < flops["full"]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _expected_argument_bytes(cfg, kind, args, mesh):
    """Each leaf's bytes over the sizes of the mesh axes its spec names."""
    rules = ShardingRules(mesh, cfg)

    def over(tree, spec):
        if isinstance(tree, QTensor):
            return sum(over(getattr(tree, k), getattr(spec, k))
                       for k in ("packed", "scale", "zero"))
        if isinstance(tree, dict):
            return sum(over(v, spec[k]) for k, v in tree.items())
        n = 1
        for e in spec:
            for ax in ((e,) if isinstance(e, str) else (e or ())):
                n *= mesh[ax]
        return tree.numel() * tree.element_size() // n

    assert kind == "train"
    params, _, batch = args
    ps = param_specs(rules, params)
    os_ = opt_state_specs(rules, params)
    total = over(params, ps) + over(args[1]["m"], os_["m"]) \
        + over(args[1]["v"], os_["v"]) + 4
    data = math.prod(v for k, v in mesh.items() if k != "model")
    for t in batch.values():
        total += t.numel() * t.element_size() // data
    return total


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_on_reduced_configs(arch, monkeypatch):
    """Every shape's cell is ``ok``; the train cell (with its Δ-check)
    holds the exact per-device argument bytes and a linearity gap of 0 —
    except on the hybrid stack, whose L2 / L3 (one and two shared-block
    groups) do not extrapolate to a group and a tail block exactly."""
    for k, v in SMALL_SHAPES.items():
        monkeypatch.setitem(steps.SHAPES, k, v)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: tget_config(a).reduced())
    cfg = tget_config(arch).reduced()
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        rec = dryrun.run_cell(arch, shape, multi_pod=False,
                              delta=shape == "train_4k",
                              qcfg=QuantConfig(2, 32))
        if not steps.shape_applicable(cfg, shape):
            assert rec["ok"] and rec["skipped"]
            continue
        assert rec["ok"], rec.get("error")
        mem = rec["memory"]
        assert mem["temp_bytes"] is None and rec["coll_dev"] is None
        assert rec["roofline"]["collective_s"] is None
        assert rec["flops_dev"] == rec["flops_global"] / 256
        assert mem["temp_bytes_unsharded"] > 0
        if shape != "train_4k":
            assert "delta" not in rec
            continue
        gaps = rec["delta"]["flops_gap"], rec["delta"]["bytes_gap"]
        if cfg.block_pattern == "hybrid":
            assert all(0 < g < 0.1 for g in gaps), gaps
        else:
            assert gaps == (0.0, 0.0)
        mode = steps.new_fake_mode()
        kind, args = steps.input_specs(cfg, shape, fake_mode=mode,
                                       device="meta")
        assert mem["argument_bytes"] == _expected_argument_bytes(
            cfg, kind, args, make_production_mesh())
    if arch == "opt-tiny":
        rec = dryrun.run_cell(arch, "decode_32k", multi_pod=True,
                              qcfg=QuantConfig(2, 32))
        assert rec["ok"] and rec["mesh"] == "2x16x16"
        assert rec["n_chips"] == 512 and "delta" not in rec


def test_full_size_cell_internvl2_decode():
    """The reference's cheapest cell, at full size: per-device argument
    bytes of the packed weights, the token column and the 32k cache on the
    16 x 16 mesh."""
    rec = dryrun.run_cell("internvl2-1b", "decode_32k", multi_pod=False,
                          delta=False)
    assert rec["ok"], rec.get("error")
    cfg = tget_config("internvl2-1b")
    # 14 query / 2 KV heads replicate across model=16; the cache shards its
    # batch of 128 over data=16
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2 // 16
    assert rec["memory"]["argument_bytes"] > cache
    assert rec["memory"]["output_bytes"] >= cache
    assert rec["roofline"]["dominant"] == "memory_s"
    assert rec["flops_global"] > 2 * cfg.active_param_count() * 128


def test_collective_bytes_counts_two_gloo_ranks(tmp_path):
    from helpers.dist_ranks import run_ranks
    from helpers.dryrun_workers import collective_counts
    n = 37
    for counts in run_ranks(collective_counts, 2, tmp_path, n):
        assert counts == {"all-gather": 2 * n * 4, "broadcast": n * 4,
                          "all-reduce": n * 4 + n * 8}


def _numeric_cells():
    cells = {}
    for i, arch in enumerate(report.ARCH_ORDER):
        for j, shape in enumerate(report.SHAPE_ORDER):
            for mesh in ("16x16", "2x16x16"):
                if shape == "long_500k" and i % 3 == 0:
                    cells[(arch, shape, mesh)] = {
                        "arch": arch, "shape": shape, "mesh": mesh,
                        "ok": True, "skipped": True}
                    continue
                x = (i + 1) * (j + 2)
                cells[(arch, shape, mesh)] = {
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "ok": (i + j) % 7 != 3,
                    "memory": {"argument_bytes": x * 2**28,
                               "output_bytes": x * 2**27,
                               "temp_bytes": x * 2**26,
                               "peak_bytes": x * 3 * 2**28},
                    "coll_schedule": ({"all-reduce": x * 2**21}
                                      if j % 2 else {}),
                    "roofline": {"compute_s": x * 1e-3,
                                 "memory_s": x * 7e-4,
                                 "collective_s": x * 2e-4,
                                 "dominant": "compute_s",
                                 "model_flops_global": x * 1e15,
                                 "useful_ratio": 0.5 + j / 10,
                                 "mfu_bound": 0.25 + i / 100}}
    return cells


def test_report_tables_equal_reference_byte_for_byte(tmp_path, capsys):
    cells = _numeric_cells()
    assert report.dryrun_table(cells) == jreport.dryrun_table(cells)
    assert report.roofline_table(cells) == jreport.roofline_table(cells)
    assert report.summary(cells) == jreport.summary(cells)
    # a record without the collective term or the per-device peak
    cell = json.loads(json.dumps(cells[("qwen3-4b", "train_4k", "16x16")]))
    cell["roofline"]["collective_s"] = None
    cell["memory"]["peak_bytes"] = None
    one = {("qwen3-4b", "train_4k", "16x16"): cell}
    assert "| n/a |" in report.roofline_table(one)
    assert "| n/a |" in report.dryrun_table(one)
    for key, rec in cells.items():
        (tmp_path / f"{key[0]}__{key[1]}__{key[2]}.json").write_text(
            json.dumps(rec))
    assert report.load_cells(art=tmp_path) == cells
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert report.dryrun_table(cells) in out and \
        report.roofline_table(cells) in out


def test_kernel_wrappers_refuse_fake_and_meta_tensors():
    mode = steps.new_fake_mode()
    with mode:
        w = torch.empty((64, 32), device="cuda")
    with pytest.raises(ValueError, match="fake"):
        ops.group_quant(w, bits=2, group=32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.group_quant(torch.empty((64, 32), device="meta"), bits=2,
                        group=32)


def test_cli_writes_cells_under_build_and_the_report_reads_them(
        tmp_path, monkeypatch, capsys):
    for k, v in SMALL_SHAPES.items():
        monkeypatch.setitem(steps.SHAPES, k, v)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: tget_config(a).reduced())
    monkeypatch.chdir(tmp_path)
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--no-delta"]) == 0
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--opt", "remat_dots_all", "--no-delta"]) == 0
    names = sorted(p.name for p in (tmp_path / "build" / "dryrun").iterdir())
    assert names == ["qwen3-4b__train_4k__16x16.json",
                     "qwen3-4b__train_4k__16x16__opt-remat_dots_all.json"]
    assert not (tmp_path / "artifacts").exists()
    rec = json.loads((tmp_path / "build" / "dryrun" / names[1]).read_text())
    assert rec["opts"] == ["remat_dots_all"] and rec["ok"]
    capsys.readouterr()
    report.main([])
    out = capsys.readouterr().out
    assert out.startswith("1 cells: 1 compiled PASS")
    assert "| qwen3-4b | train_4k | PASS | FAIL | n/a |" in out
