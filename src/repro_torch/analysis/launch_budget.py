"""launch-budget checker: every zoo shape the kernels get, they can launch.

The port's CUDA wrappers have no fallback (``kernels/ops.py``): a shape a
planner cannot size raises ``ValueError`` on the card, at run time. This
checker replays the planners at lint time over every architecture in the
config zoo, so a config that can never launch is a finding, not a failure
in the middle of a search:

- ``transform_quant`` (``kernels/transform_quant.py::plan`` and the
  wrapper's argument checks): the search adapters' ``up``-family weights
  (d_model, d_ff) in ``mode="up"`` and the ``down`` projection (d_ff,
  d_model) in ``mode="down"``, under the canonical search
  ``QuantConfig(bits=2, group_size=32)``, at f32 and at the config's own
  parameter dtype — the (arch, proj, K, N, mode) set of the reference's
  ``pallas-budget`` checker (:func:`zoo_units`);
- ``group_quant`` (``kernels/ops.py::_check_quant_args``: K a multiple of
  the group, N within ``_MAX_GRID_Y`` columns; then
  ``kernels/group_quant.py::plan`` at f32 and bf16, which refuses the same
  shapes): every quantizable leaf of the config, as ``fake_quant``
  flattens it, (L·K, N);
- the decode kernels (``kernels/ops.py::_check_head_dim``): the head dim a
  multiple of 4, for every config with attention (:func:`zoo_kernels`).

A refused shape is a finding anchored at the ``raise`` (or the ``_require``
call) that refuses it, found from the exception's traceback; it is
reported when that file is in the scan set. Expected refusals, with their
reasons, live in the committed baseline.

Fixture / self-test hook: any scanned file may declare a literal
``LAUNCH_SHAPE_PROBES = [("transform_quant", K, N, group, mode, dtype),
("group_quant", K, N, group), ("decode", head_dim), ...]``; each refused
probe is a finding at the declaration.
"""
from __future__ import annotations

import ast
import importlib
import math
import pathlib
import traceback
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.framework import (Checker, Finding, SourceFile,
                                            register)

RULE = "launch-budget"

# the canonical search quantization the zoo is checked under
_BITS, _GROUP_SIZE = 2, 32
_ESIZE = {"float32": 4, "bfloat16": 2}


def _refusal(fn) -> Tuple[Optional[str], Optional[Tuple[str, int]]]:
    """(reason, (file, line) of the refusing raise) when ``fn()`` raises
    ValueError, else (None, None)."""
    try:
        fn()
    except ValueError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.name != "_require"]
        return str(e), (frames[-1].filename, frames[-1].lineno)
    return None, None


def _tq_check(K: int, N: int, group: int, mode: str, dtype: str):
    """Replay ``ops.transform_quant``'s argument checks and planner."""
    from repro_torch.kernels import ops
    tq = importlib.import_module("repro_torch.kernels.transform_quant")

    def run():
        f = N if mode == "up" else K
        if f % 2:
            raise ValueError(f"transformed axis f={f} must be even")
        ops._check_quant_args(K, N, _BITS, group)
        return tq.plan(K, N, group, mode, _ESIZE[dtype])
    return _refusal(run)


def _gq_check(K: int, N: int, group: int):
    """Replay ``ops.group_quant``'s argument checks and the planner."""
    import torch

    from repro_torch.kernels import ops
    gq = importlib.import_module("repro_torch.kernels.group_quant")

    def run():
        ops._check_quant_args(K, N, _BITS, group)
        for dtype in (torch.float32, torch.bfloat16):
            gq.plan(K, N, group, dtype)
    return _refusal(run)


def _decode_check(head_dim: int):
    from repro_torch.kernels import ops
    return _refusal(lambda: ops._check_head_dim(head_dim))


def _refusing_files() -> set:
    """The files whose raises a replayed shape can reach."""
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    tq = importlib.import_module("repro_torch.kernels.transform_quant")
    gq = importlib.import_module("repro_torch.kernels.group_quant")
    return {pathlib.Path(m.__file__).resolve() for m in (ops, tq, gq, quant)}


def _archs() -> List[str]:
    from repro_torch.configs import list_archs
    return list_archs() + ["opt-1.3b"]


def zoo_units() -> List[dict]:
    """One row per (arch, projection, dtype): the ``transform_quant`` call
    shapes the search adapters produce, f32 and the config's own dtype, with
    the replayed verdict (``ok``, ``reason``, ``anchor``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig

    qcfg = QuantConfig(bits=_BITS, group_size=_GROUP_SIZE)
    rows: List[dict] = []
    for arch in _archs():
        cfg = get_config(arch)
        d, f = cfg.d_model, cfg.d_ff
        if not f:  # pure-SSM archs have no FFN unit to transform
            rows.append({"arch": arch, "proj": None, "ok": True,
                         "reason": "no FFN"})
            continue
        for proj, K, N, mode in (("up", d, f, "up"), ("down", f, d, "down")):
            for dtype in dict.fromkeys(("float32", cfg.param_dtype)):
                row = {"arch": arch, "proj": proj, "K": K, "N": N,
                       "mode": mode, "dtype": dtype, "group": None}
                reason, anchor = _refusal(lambda: qcfg.resolve_group(K))
                if reason is None:
                    row["group"] = qcfg.resolve_group(K)
                    reason, anchor = _tq_check(K, N, row["group"], mode,
                                               dtype)
                row.update(ok=reason is None, reason=reason or "",
                           anchor=anchor)
                rows.append(row)
    return rows


def zoo_kernels() -> List[dict]:
    """One row per (arch, group_quant leaf) and per (arch, decode head
    dim): the shapes ``fake_quant`` and the decode routes give the
    kernels, with the replayed verdict."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.steps import param_structs
    from repro_torch.models.model import quantizable_paths
    from repro_torch.core.rtn import get_by_path

    qcfg = QuantConfig(bits=_BITS, group_size=_GROUP_SIZE)
    rows: List[dict] = []
    for arch in _archs():
        cfg = get_config(arch)
        params = param_structs(cfg, device="meta")
        for path in quantizable_paths(params):
            shape = tuple(get_by_path(params, path).shape)
            K, N = shape[-2], shape[-1]
            row = {"arch": arch, "kernel": "group_quant",
                   "leaf": "/".join(map(str, path)),
                   "K": math.prod(shape[:-1]), "N": N}
            reason, anchor = _refusal(lambda: qcfg.resolve_group(K))
            if reason is None:
                reason, anchor = _gq_check(row["K"], N,
                                           qcfg.resolve_group(K))
            row.update(ok=reason is None, reason=reason or "",
                       anchor=anchor)
            rows.append(row)
        if cfg.block_pattern != "ssm":
            hd = cfg.resolved_head_dim
            reason, anchor = _decode_check(hd)
            rows.append({"arch": arch, "kernel": "decode", "head_dim": hd,
                         "ok": reason is None, "reason": reason or "",
                         "anchor": anchor})
    return rows


def _literal_probes(sf: SourceFile) -> List[Tuple[int, Tuple]]:
    """(line, entry) per entry of a literal LAUNCH_SHAPE_PROBES."""
    out: List[Tuple[int, Tuple]] = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "LAUNCH_SHAPE_PROBES"
                for t in node.targets)):
            continue
        try:
            probes = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            continue
        for entry in probes:
            out.append((node.lineno, tuple(entry)))
    return out


def probe(entry: tuple) -> Optional[str]:
    """The refusal reason of one ``LAUNCH_SHAPE_PROBES`` entry, or None
    when the kernel takes it."""
    kind, *args = entry
    if kind == "transform_quant":
        K, N, group, mode, dtype = args
        return _tq_check(int(K), int(N), int(group), str(mode), str(dtype))[0]
    if kind == "group_quant":
        K, N, group = args
        return _gq_check(int(K), int(N), int(group))[0]
    if kind == "decode":
        (head_dim,) = args
        return _decode_check(int(head_dim))[0]
    raise ValueError(f"unknown probe kind {kind!r}")


@register
class LaunchBudgetChecker(Checker):
    name = RULE
    description = ("transform_quant / group_quant / decode shapes across the "
                   "config zoo are taken by the CUDA kernels' planners")
    bug_class = "a ValueError on the card mid-run: the wrappers have no " \
                "fallback"

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        findings: List[Finding] = []
        for line, entry in _literal_probes(sf):
            try:
                reason = probe(entry)
            except (TypeError, ValueError, KeyError) as e:
                reason = f"malformed LAUNCH_SHAPE_PROBES entry {entry!r}: {e}"
            if reason is not None:
                findings.append(Finding(
                    rule=self.name, path=sf.rel, line=line,
                    symbol=sf.symbol_at(line),
                    message=f"probe {entry!r} cannot launch: {reason}"))
        return findings

    def check_project(self, files: Sequence[SourceFile]) -> Iterable[Finding]:
        by_path = {pathlib.Path(sf.path).resolve(): sf for sf in files}
        if not set(by_path) & _refusing_files():
            return []  # no refusing code in the scan set (fixture runs)
        findings: List[Finding] = []

        def emit(row, what):
            sf = by_path.get(pathlib.Path(row["anchor"][0]).resolve())
            if sf is None:
                return  # the refusing code is not in the scan set
            line = row["anchor"][1]
            findings.append(Finding(
                rule=self.name, path=sf.rel, line=line,
                symbol=sf.symbol_at(line),
                message=f"config {row['arch']} {what} is refused: "
                        f"{row['reason']}"))

        for row in zoo_units():
            if not row["ok"]:
                emit(row, f"ffn_{row['proj']} (K={row['K']}, N={row['N']}, "
                          f"group={row['group']}, mode={row['mode']}, "
                          f"dtype={row['dtype']}) by transform_quant")
        for row in zoo_kernels():
            if row["ok"]:
                continue
            if row["kernel"] == "decode":
                emit(row, f"head dim {row['head_dim']} by the decode kernels")
            else:
                emit(row, f"{row['leaf']} (K={row['K']}, N={row['N']}) by "
                          f"group_quant")
        return findings
