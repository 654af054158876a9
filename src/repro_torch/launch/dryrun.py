"""Dry run: trace every (arch × shape × mesh) cell with fake tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all      # 80 cells, both meshes
    PYTHONPATH=src python -m repro_torch.launch.report            # the tables

The reference's ``repro.launch.dryrun`` lowers and compiles each cell for a
256- or 512-chip TPU mesh. The port has no SPMD partitioner: a cell here
traces the port's own step at the cell's full global size — the train step
with ``remat=True``, the prefill step or the serve step, over the
``launch.steps.input_specs`` fake tensors — under
``torch._subclasses.fake_tensor.FakeTensorMode`` with
``torch.utils.flop_counter.FlopCounterMode`` and :class:`StepTrace`, a
dispatch mode that sums every op's input and output bytes and follows the
live bytes of the storages. Nothing is allocated, so no card is needed:
this is the one entry point that does not check for one. ``--device``
picks the traced route: the card's, "cuda" (``launch.steps.fake_device``:
"meta" on a PyTorch build without CUDA, which cannot index a fake CUDA
tensor), or ``--device cpu``, the CPU route. The cells' steps reach no
kernel wrapper on the card's route; a trace that reached one would raise
(``kernels.ops``), not build, launch or fall back.

What a cell's record holds, under the reference's keys:
- exact: ``memory.argument_bytes`` / ``output_bytes``, per device — the
  largest shard of every leaf under the cell's ``dist.sharding`` specs on
  the production mesh (``launch.mesh.make_production_mesh``,
  ``dist.sharding.shard_index``); ``ok`` — the trace ran and every spec
  names mesh axes that exist;
- idealised (``"idealised"`` in the record): ``flops_dev`` and
  ``bytes_dev``, the global counts divided by the chip count, and the
  roofline terms computed from them;
- not given: per-device ``temp_bytes`` (null) — the record holds
  ``temp_bytes_unsharded``, the trace's live peak less its arguments, for
  the whole step on one device; ``coll_dev`` (None) — the cells' steps
  issue no collective and nothing partitions them.

``delta``: the reference compiles L2 and L3 layers fully unrolled and
extrapolates, because XLA counts a scan body once. The port counts every
layer, so the trace at full depth is the count; ``delta`` traces L2 and L3
too and records the extrapolation beside it and their relative gap — a
linearity self-check, 0 on a dense stack.

Cells are written to ``build/dryrun/<arch>__<shape>__<mesh>[__opt-...].json``
under the working directory (``--out``), never to ``artifacts/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_archs
from repro_torch.core.quant import QTensor
from repro_torch.dist.sharding import (ShardingRules, cache_specs, data_spec,
                                       opt_state_specs, param_specs,
                                       shard_index)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (HW, collective_bytes, extrapolate,
                                         model_flops, roofline_terms)
from repro_torch.launch.steps import (SHAPES, fake_device, input_specs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, new_fake_mode,
                                      shape_applicable)
from repro_torch.models.config import ModelConfig

__all__ = ["StepTrace", "trace_step", "run_cell", "OPTS", "main"]

OUT = pathlib.Path("build") / "dryrun"

# the CUDA caching allocator hands out blocks of 512-byte multiples
_BLOCK = 512
# ops that move no bytes: allocations that write nothing, and lifting a
# host constant into the trace
_NO_BYTES = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided", "lift_fresh"})


def _tensors(tree):
    """The tensor leaves of a step's arguments or results (a QTensor by its
    packed words, scale and zero)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, QTensor):
        yield from (tree.packed, tree.scale, tree.zero)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(TorchDispatchMode):
    """Bytes and live memory of the ops run inside it.

    ``bytes``: per op, each input read once and each output written once
    (the eager bound); an op whose outputs all alias its inputs and that
    mutates nothing (a view) moves none, nor does an empty allocation or a
    lifted constant.
    ``live`` / ``peak``: the bytes of the storages alive, each counted once
    (views share theirs) in the caching allocator's 512-byte blocks, added
    when an op returns a new storage or :meth:`track` is given one, taken
    away when the storage is freed (a weak reference's callback): autograd's
    saved tensors and aliasing views count as they hold memory on the
    card."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs = {}

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key,
                                                            n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, n, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def track(self, tree) -> int:
        """Count the storages of ``tree`` (a step's arguments) as live;
        returns the bytes they add."""
        before = self.live
        for t in _tensors(tree):
            self._add(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = list(_tensors((args, kwargs)))
        in_st = {id(t.untyped_storage()) for t in ins}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        mutates = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        fresh = any(id(t.untyped_storage()) not in in_st for t in outs)
        if (mutates or fresh) and \
                func._schema.name.split("::")[-1] not in _NO_BYTES:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._add(t)
        return out


def trace_step(step, args, fake_mode=None) -> dict:
    """Run ``step(*args)`` (fake tensors of ``fake_mode``, or real ones with
    no mode) under FlopCounterMode, :class:`StepTrace` and
    ``roofline.collective_bytes``: {"flops", "bytes", "peak_bytes" (the
    arguments included), "argument_bytes" (their storages, in allocator
    blocks), "collectives", "seconds", "out"}."""
    t0 = time.monotonic()
    with fake_mode or contextlib.nullcontext():
        tracer = StepTrace()
        arg_bytes = tracer.track(args)
        with FlopCounterMode(display=False) as flops, tracer, \
                collective_bytes() as coll:
            out = step(*args)
    return {"flops": flops.get_total_flops(), "bytes": tracer.bytes,
            "peak_bytes": tracer.peak, "argument_bytes": arg_bytes,
            "collectives": coll.as_dict(),
            "seconds": time.monotonic() - t0, "out": out}


# ---------------------------------------------------------------------------
# per-device bytes under the sharding specs
# ---------------------------------------------------------------------------

def _spec_pairs(tree, spec):
    """(tensor, spec tuple) over ``tree``. A tuple or list of the tree pairs
    with a LIST of specs (a spec tuple is one leaf's entries); a leaf
    without a spec (None, a missing key) is replicated."""
    if isinstance(tree, torch.Tensor):
        yield tree, (spec if isinstance(spec, tuple) else ())
    elif isinstance(tree, QTensor):
        for name in ("packed", "scale", "zero"):
            yield from _spec_pairs(getattr(tree, name),
                                   getattr(spec, name, None))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_pairs(v, spec.get(k) if isinstance(spec, dict)
                                   else None)
    elif isinstance(tree, (list, tuple)):
        specs = spec if isinstance(spec, list) else [None] * len(tree)
        for v, sp in zip(tree, specs):
            yield from _spec_pairs(v, sp)


def _axes(spec) -> set:
    out = set()
    for entry in spec:
        if entry is not None:
            out.update((entry,) if isinstance(entry, str) else entry)
    return out


def _shard_bytes(pairs, mesh) -> int:
    """Sum over the leaves of their largest shard's bytes (rank 0's: the
    specs split every sharded dim into equal parts)."""
    total = 0
    for t, spec in pairs:
        idx = shard_index(spec, tuple(t.shape), mesh, 0)
        total += math.prod(b - a for a, b in idx) * t.element_size()
    return total


def _batch_specs(rules, batch_tree, batch):
    d = data_spec(rules, batch)
    return {k: (d if k == "tokens" else d + (None,)) for k in batch_tree}


def _arg_specs(kind, rules, args, cfg, batch):
    if kind == "train":
        params, _, b = args
        return [param_specs(rules, params), opt_state_specs(rules, params),
                _batch_specs(rules, b, batch)]
    if kind == "prefill":
        params, b = args
        return [param_specs(rules, params), _batch_specs(rules, b, batch)]
    params = args[0]
    return [param_specs(rules, params), data_spec(rules, batch),
            cache_specs(rules, cfg, batch), None]


def _out_specs(kind, rules, args, cfg, batch):
    """Outputs that mirror an argument take its specs (new params, optimizer
    state, the cache; an encoder-decoder cache's cross K/V replicated, as
    the reference's); a new per-row result (logits, tokens) is sharded on
    its batch dim as the tokens are; the train metrics are replicated."""
    if kind == "train":
        specs = _arg_specs(kind, rules, args, cfg, batch)
        return [specs[0], specs[1], None]
    rows = data_spec(rules, batch)
    return [rows + (None,) if kind == "prefill" else rows,
            cache_specs(rules, cfg, batch)]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _scaled_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """The Δ-check's config: ``n_layers`` blocks (and as many encoder
    blocks in an encoder-decoder stack)."""
    kw = {"n_layers": n_layers}
    if cfg.is_enc_dec:
        kw["encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def _delta_layers(cfg: ModelConfig):
    if cfg.block_pattern == "hybrid":
        return cfg.hybrid_period, 2 * cfg.hybrid_period
    return 2, 3


def _step_for(cfg: ModelConfig, kind: str, shape: str, accum: int):
    if kind == "train":
        return make_train_step(dataclasses.replace(cfg, remat=True),
                               accum_steps=accum)
    if kind == "prefill":
        extra = cfg.frontend_len if cfg.frontend == "vision" else 0
        return make_prefill_step(cfg, max_len=SHAPES[shape]["seq"] + extra)
    return make_serve_step(cfg)


def _trace_once(cfg, shape, mesh, rules, *, accum, device, qcfg=None):
    mode = new_fake_mode()
    kind, args = input_specs(cfg, shape, qcfg, fake_mode=mode, device=device)
    batch = SHAPES[shape]["batch"]
    res = trace_step(_step_for(cfg, kind, shape, accum), args, mode)
    arg_pairs = list(_spec_pairs(args, _arg_specs(kind, rules, args, cfg,
                                                  batch)))
    out_pairs = list(_spec_pairs(res.pop("out"),
                                 _out_specs(kind, rules, args, cfg, batch)))
    axes = set().union(*(_axes(s) for _, s in arg_pairs + out_pairs))
    res.update(kind=kind, specs_ok=axes <= set(mesh),
               bad_axes=sorted(axes - set(mesh)),
               memory={"argument_bytes": _shard_bytes(arg_pairs, mesh),
                       "output_bytes": _shard_bytes(out_pairs, mesh),
                       "temp_bytes": None, "peak_bytes": None,
                       "temp_bytes_unsharded":
                           res["peak_bytes"] - res["argument_bytes"],
                       "peak_bytes_unsharded": res["peak_bytes"]})
    return res


# §Perf knobs, as the reference's: --opt a,b,c applies these config / rule
# overrides and writes the cell under a suffixed name
OPTS = {
    "remat_dots": {"remat_policy": "dots"},
    "remat_dots_all": {"remat_policy": "dots_all"},
    "bf16_scores": {"attn_softmax_dtype": "bfloat16"},
    "repeat_kv": {"gqa_repeat_kv": True},
    "kv_int8": {"kv_cache_dtype": "int8"},
    "chunk4k": {"attn_chunk": 4096},
    "chunk8k": {"attn_chunk": 8192},
    "chunk32k": {"attn_chunk": 32768},
    "heads_shard": {},  # rules-level (long_decode_shard="heads")
    "cap1": {},         # moe capacity_factor 1.25 -> 1.0 (in run_cell)
    "accum4": {},       # 4x gradient accumulation (in run_cell)
}

_EXACTNESS = {
    "exact": ["memory.argument_bytes", "memory.output_bytes", "ok"],
    "idealised": ["flops_dev", "bytes_dev", "roofline"],
    "not_given": ["memory.temp_bytes", "memory.peak_bytes", "coll_dev"],
}


def run_cell(arch: str, shape: str, *, multi_pod: bool, delta: bool = True,
             zero1: bool = False, opts=(), device=None, qcfg=None) -> dict:
    """One cell's record (see the module docstring); a failed trace is
    recorded with ``ok`` False and its error, not raised. ``qcfg``: the
    serving cells' packing (``input_specs``' 2-bit g128 by default)."""
    cfg = get_config(arch)
    overrides = {}
    for o in opts:
        overrides.update(OPTS[o])
    if "cap1" in opts and cfg.moe is not None:
        overrides["moe"] = dataclasses.replace(cfg.moe, capacity_factor=1.0)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    device = device or fake_device()
    rec = {"arch": arch, "shape": shape, "opts": list(opts),
           "mesh": "2x16x16" if multi_pod else "16x16", "ok": False,
           "device": device}
    if not shape_applicable(cfg, shape):
        rec.update(ok=True, skipped=True,
                   note="long_500k skipped: pure full-attention arch")
        return rec
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = ShardingRules(
            mesh, cfg, zero1=zero1,
            long_decode_shard="heads" if "heads_shard" in opts else "seq")
        n_chips = math.prod(mesh.values())
        accum = 4 if "accum4" in opts else 1
        full = _trace_once(cfg, shape, mesh, rules, accum=accum,
                           device=device, qcfg=qcfg)
        flops_dev = full["flops"] / n_chips
        bytes_dev = full["bytes"] / n_chips
        terms = roofline_terms(flops_dev, bytes_dev, None)
        info = SHAPES[shape]
        n_tokens = info["batch"] * (info["seq"] if full["kind"] != "decode"
                                    else 1)
        mf = model_flops(cfg, n_tokens, train=(full["kind"] == "train"))
        terms["model_flops_global"] = mf
        terms["hlo_flops_global"] = full["flops"]
        terms["useful_ratio"] = mf / max(full["flops"], 1.0)
        step_time = max(terms["compute_s"], terms["memory_s"])
        terms["mfu_bound"] = (mf / n_chips / HW["peak_flops"]) / max(
            step_time, 1e-12)
        rec.update(ok=full["specs_ok"], kind=full["kind"],
                   compile_s=round(full["seconds"], 2),
                   memory=full["memory"], coll_schedule=full["collectives"],
                   flops_global=full["flops"], bytes_global=full["bytes"],
                   flops_dev=flops_dev, bytes_dev=bytes_dev, coll_dev=None,
                   roofline=terms, n_chips=n_chips, exactness=_EXACTNESS)
        if not full["specs_ok"]:
            rec["error"] = f"specs name axes {full['bad_axes']} absent " \
                           f"from the mesh {mesh}"
        if delta and not multi_pod:
            l2, l3 = _delta_layers(cfg)
            r2, r3 = (_trace_once(_scaled_cfg(cfg, n), shape, mesh, rules,
                                  accum=accum, device=device, qcfg=qcfg)
                      for n in (l2, l3))
            lf = cfg.n_layers
            ex = {k: extrapolate(r2[k], r3[k], l2, l3, lf)
                  for k in ("flops", "bytes")}
            rec["delta_layers"] = [l2, l3]
            rec["delta"] = {
                "flops_extrapolated": ex["flops"],
                "bytes_extrapolated": ex["bytes"],
                "flops_gap": abs(ex["flops"] - full["flops"])
                / max(full["flops"], 1),
                "bytes_gap": abs(ex["bytes"] - full["bytes"])
                / max(full["bytes"], 1)}
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug to record
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def _cell_path(out, arch, shape, multi_pod, opts=()):
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = ("__opt-" + "-".join(opts)) if opts else ""
    return pathlib.Path(out) / f"{arch}__{shape}__{mesh}{suffix}.json"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--no-delta", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell, each in a "
                         "process of its own")
    ap.add_argument("--opt", default="",
                    help="comma-separated perf knobs: " + ",".join(OPTS))
    ap.add_argument("--force", action="store_true",
                    help="with --all, rerun cells already written")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all, cells traced at once (one process "
                         "each)")
    ap.add_argument("--device", default=None,
                    help="the traced route: cuda (the card's; meta on a "
                         "build without CUDA, the default) or cpu")
    ap.add_argument("--out", default=str(OUT),
                    help="directory of the cell records (default "
                         "build/dryrun under the working directory)")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s, mp) for a in list_archs() for s in SHAPES
                 for mp in (False, True)]
        todo = [(a, s, mp) for a, s, mp in cells
                if args.force or not _cell_path(out, a, s, mp).exists()]
        print(f"[dryrun] {len(todo)}/{len(cells)} cells to run", flush=True)

        def one(cell):
            a, s, mp = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--out", str(out)] \
                + (["--multi-pod"] if mp else []) \
                + (["--device", args.device] if args.device else []) \
                + (["--no-delta"] if args.no_delta else [])
            t0 = time.monotonic()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               env={**os.environ}, timeout=3600)
            return r, time.monotonic() - t0

        with ThreadPoolExecutor(max_workers=args.jobs) as pool:
            for i, ((a, s, mp), (r, dt)) in enumerate(
                    zip(todo, pool.map(one, todo))):
                p = _cell_path(out, a, s, mp)
                ok = json.loads(p.read_text()).get("ok") if p.exists() \
                    else "?"
                print(f"[dryrun {i + 1}/{len(todo)}] {a} {s} mp={mp} "
                      f"ok={ok} ({dt:.0f}s)", flush=True)
                if r.returncode != 0:
                    print(r.stderr[-1500:], flush=True)
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all) are required")
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   delta=not args.no_delta, zero1=args.zero1, opts=opts,
                   device=args.device)
    path = _cell_path(out, args.arch, args.shape, args.multi_pod, opts)
    path.write_text(json.dumps(rec, indent=1, default=str))
    if rec.get("memory"):
        print(f"memory: {rec['memory']}")
    if rec.get("roofline"):
        rl = {k: v for k, v in rec["roofline"].items()
              if isinstance(v, (int, float))}
        print(f"roofline: {rl}")
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "ok")
                      if k in rec}))
    if not rec["ok"] and "error" in rec:
        print(rec["error"])
        print(rec.get("trace", ""))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
