"""Search configuration, result and the dense FFN adapter (paper Algorithm 1).

The loop lives in ``repro_torch.search.engine``; this module keeps what is
model-family specific. :class:`DenseFFNAdapter` exposes each decoder
block's FFN as a transformable unit, with two candidate builds:

- ``transform_unit`` + ``quant_unit``: the transformed fp32 weights are
  materialized, then ``fake_quant`` (the ``group_quant`` kernel on CUDA)
  quantizes them — the plain, unfused lane;
- ``transform_quant_unit``: the fused lane, one ``transform_quant`` kernel
  launch per weight (up, down) reading the original weights once.

Stacks are never modified in place: :meth:`DenseFFNAdapter.install_unit`
returns a fresh stack, so a stack held as the elite snapshot stays what it
was when it was taken.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import invariance as inv
from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.model import layer_slice

__all__ = ["SearchConfig", "SearchResult", "DenseFFNAdapter", "make_adapter"]


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    steps: int = 2000
    seed: int = 0
    # registry name ("ce" Eqn. 23 | "kl" Algorithm-1 listing) or an
    # core.objective.Objective instance
    objective: Any = "ce"
    n_match_layers: int = 10       # activation-matching depth (paper Table 4)
    ce_weight: float = 10.0        # CE is 10x more important at step 0 (§4.1)
    proposal: inv.ProposalConfig = dataclasses.field(default_factory=inv.ProposalConfig)
    log_every: int = 200
    population: int = 1            # candidates per step
    islands: int = 1               # >1 not ported yet (ROADMAP item 7)
    temperature: float = 0.0       # initial annealing T; 0 = greedy climb
    anneal: str = "geometric"      # schedule: constant | geometric | linear
    fused_kernel: bool = False     # kernels.transform_quant fused lane
    mapped: bool = False           # not ported yet (ROADMAP item 14)
    tabu: int = 0                  # not ported yet (ROADMAP item 7)
    shard_calib: bool = False      # not ported yet (ROADMAP item 7)
    measure_memory: bool = False   # not ported yet (ROADMAP item 7)


@dataclasses.dataclass
class SearchResult:
    params_q: dict                 # model with searched fake-quant weights installed
    transforms: inv.FFNTransform   # stacked per-unit transforms
    history: list                  # (step, loss, ce, mse, accepted)
    accept_rate: float
    final_loss: float
    initial_loss: float
    island_histories: Optional[list] = None
    stats: Optional[dict] = None   # uphill accepts / proposals-per-sec / ...


class DenseFFNAdapter:
    """Dense decoder blocks: unit = one FFN (up[/gate]/down[,b_up,b_gate])."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_units = cfg.n_layers
        self.f_dim = cfg.d_ff

    def base_stack(self, params):
        mlp = params["blocks"]["mlp"]
        return {k: mlp[k] for k in ("up", "down", "gate", "b_up", "b_gate") if k in mlp}

    def transform_unit(self, base, t: inv.FFNTransform, u: int):
        b = layer_slice(base, u)
        up, down, b_up, gate, b_gate = inv.apply_transform_ffn(
            t, b["up"], b["down"], b.get("b_up"), b.get("gate"), b.get("b_gate"))
        out = {"up": up, "down": down}
        if b_up is not None:
            out["b_up"] = b_up
        if gate is not None:
            out["gate"] = gate
        if b_gate is not None:
            out["b_gate"] = b_gate
        return out

    def quant_unit(self, unit, qcfg: QuantConfig):
        return {k: fake_quant(v, qcfg) if v.ndim >= 2 else v
                for k, v in unit.items()}

    def quant_stack(self, stack, qcfg: QuantConfig):
        """``quant_unit`` of every unit at once: stacked (L, K, N) weights go
        through one ``fake_quant`` call each; (L, F) biases stay as they are."""
        return {k: fake_quant(v, qcfg) if v.ndim >= 3 else v
                for k, v in stack.items()}

    def transform_quant_unit(self, base, t: inv.FFNTransform, u: int,
                             qcfg: QuantConfig):
        """Fused lane: (π, s, φ) + group fake-quant in ONE kernel launch per
        weight instead of materializing the transformed fp32 weights and
        re-reading them to quantize. Biases are tiny and never quantized."""
        from repro_torch.kernels import transform_quant
        b = layer_slice(base, u)
        out = {}
        if "up" in b:
            out["up"] = transform_quant(
                b["up"], t.pi, t.s, t.phi, bits=qcfg.bits,
                group=qcfg.resolve_group(b["up"].shape[0]), mode="up")[0]
        if "gate" in b:   # gate branch is permuted only (see apply_transform_ffn)
            out["gate"] = transform_quant(
                b["gate"], t.pi, torch.ones_like(t.s), torch.zeros_like(t.phi),
                bits=qcfg.bits, group=qcfg.resolve_group(b["gate"].shape[0]),
                mode="up")[0]
        out["down"] = transform_quant(
            b["down"], t.pi, t.s, t.phi, bits=qcfg.bits,
            group=qcfg.resolve_group(b["down"].shape[0]), mode="down")[0]
        if "b_up" in b:
            out["b_up"] = (inv.apply_rotation_rows(b["b_up"], t.phi) * t.s)[t.pi]
        if "b_gate" in b:
            out["b_gate"] = b["b_gate"][t.pi]
        return out

    def install(self, params, fq_stack):
        """``params`` with the FFN leaves taken from ``fq_stack`` (no copy)."""
        params = dict(params)
        blocks = dict(params["blocks"])
        blocks["mlp"] = {**blocks["mlp"], **fq_stack}
        params["blocks"] = blocks
        return params

    def unit_override(self, u: int, unit):
        """``forward(layer_override=...)`` argument that makes layer ``u``
        read the candidate ``unit`` instead of its slice of the stack."""
        return (u, {"mlp": unit})

    def install_unit(self, fq_stack, u: int, unit):
        """A fresh stack equal to ``fq_stack`` with unit ``u`` replaced."""
        out = {}
        for k, v in fq_stack.items():
            nv = v.clone()
            nv[u] = unit[k]
            out[k] = nv
        return out


def make_adapter(cfg: ModelConfig):
    check_supported(cfg)
    return DenseFFNAdapter(cfg)
