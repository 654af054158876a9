"""Search configuration, result and the unit adapters (paper Algorithm 1).

The loop lives in ``repro_torch.search.engine``; this module keeps what is
model-family specific. :class:`DenseFFNAdapter` exposes each decoder
block's FFN as a transformable unit, :class:`MoEAdapter` each expert of
each MoE block, :class:`MambaAdapter` each Mamba2 block (within-head
permutations only) and :class:`SharedFFNAdapter` the FFN of a hybrid
stack's one shared block, with two candidate builds:

- ``transform_unit`` + ``quant_unit``: the transformed fp32 weights are
  materialized, then ``fake_quant`` (the ``group_quant`` kernel on CUDA)
  quantizes them — the plain, unfused lane;
- ``transform_quant_unit``: the fused lane, one ``transform_quant`` kernel
  launch per weight (up, down[, gate]) reading the original weights once.
  A Mamba block has no fused build (as in the reference): the engine warns
  and takes the unfused lane.

Stacks are never modified in place: ``install_unit`` returns a fresh stack
(``search.install.tree_install_unit``), so a stack held as the elite
snapshot stays what it was when it was taken.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch

from repro_torch.core import invariance as inv
from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.layers import EXPERT_OVERRIDE
from repro_torch.models.model import layer_slice
from repro_torch.search.install import tree_install_unit

__all__ = ["SearchConfig", "SearchResult", "DenseFFNAdapter", "MoEAdapter",
           "MambaAdapter", "SharedFFNAdapter", "make_adapter", "run_search",
           "run_search_hybrid"]


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    steps: int = 2000
    seed: int = 0
    # registry name ("ce" Eqn. 23 | "kl" Algorithm-1 listing |
    # "swd_actmatch" | "saliency_ce") or a core.objective.Objective instance
    objective: Any = "ce"
    n_match_layers: int = 10       # activation-matching depth (paper Table 4)
    ce_weight: float = 10.0        # CE is 10x more important at step 0 (§4.1)
    proposal: inv.ProposalConfig = dataclasses.field(default_factory=inv.ProposalConfig)
    log_every: int = 200
    # --- engine scale-out (repro_torch.search); defaults = legacy behavior ---
    population: int = 1            # candidates per step
    islands: int = 1               # independent chains, run in turn
    temperature: float = 0.0       # initial annealing T; 0 = greedy climb
    anneal: str = "geometric"      # schedule: constant | geometric | linear
    migrate_every: int = 50        # elite-migration cadence (0 = never)
    fused_kernel: bool = False     # kernels.transform_quant fused lane
    mapped: bool = False           # one island per rank (torch.distributed)
    # --- candidate-eval memory model + calibration sharding ---
    install: str = "unit"          # "unit": stack + K×unit, one override
                                   # forward each; "stack": K full stacks
    tabu: int = 0                  # tried-point memory capacity (0 = off)
    shard_calib: bool = False      # per-island calibration slices
    measure_memory: bool = False   # CUDA allocator peak into
                                   # stats["peak_live_bytes"] (bench)


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
        return tree_install_unit(fq_stack, u, unit)


class MoEAdapter:
    """MoE blocks: unit = one expert's FFN (up[/gate]/down, no biases).
    n_units = L·E in unit-major order (u = l·E + e): ``base_stack`` views
    the (L, E, ...) expert leaves as (L·E, ...)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.E = cfg.moe.num_experts
        self.n_units = cfg.n_layers * self.E
        self.f_dim = cfg.d_ff

    def base_stack(self, params):
        moe = params["blocks"]["moe"]
        return {k: moe[k].reshape((-1,) + tuple(moe[k].shape[2:]))
                for k in ("up", "down", "gate") if k in moe}

    def transform_unit(self, base, t: inv.FFNTransform, u: int):
        b = layer_slice(base, u)
        up, down, _, gate, _ = inv.apply_transform_ffn(
            t, b["up"], b["down"], None, b.get("gate"), None)
        out = {"up": up, "down": down}
        if gate is not None:
            out["gate"] = gate
        return out

    def quant_unit(self, unit, qcfg: QuantConfig):
        """Every leaf is a weight (no biases): one ``fake_quant`` call each,
        for one expert's (K, N) leaves and for the (L·E, K, N) stack alike
        (``quant_stack``)."""
        return {k: fake_quant(v, qcfg) for k, v in unit.items()}

    quant_stack = quant_unit

    # an expert carries a dense FFN's up/down[/gate] layout, so the fused
    # lane (one transform_quant launch a weight) applies unchanged
    transform_quant_unit = DenseFFNAdapter.transform_quant_unit

    def install(self, params, fq_stack):
        """``params`` with the expert leaves taken from ``fq_stack``
        (viewed back as (L, E, ...); no copy)."""
        params = dict(params)
        blocks = dict(params["blocks"])
        moe = dict(blocks["moe"])
        for k, v in fq_stack.items():
            moe[k] = v.reshape((self.cfg.n_layers, self.E) + tuple(v.shape[1:]))
        blocks["moe"] = moe
        params["blocks"] = blocks
        return params

    def unit_override(self, u: int, unit):
        """``forward(layer_override=...)`` argument that makes expert e of
        layer l (u = l·E + e) read the candidate ``unit``: ``moe_ffn`` takes
        that one expert's leaves from it, so no expert stack is copied."""
        layer, e = divmod(u, self.E)
        return (layer, {"moe": {EXPERT_OVERRIDE: (e, unit)}})

    install_unit = DenseFFNAdapter.install_unit


class MambaAdapter:
    """Mamba2 blocks: unit = one block, moved by a within-head permutation
    only (exact invariance): w_z / w_x / conv_x columns, conv_b_x and
    norm_w entries and out_proj rows permute together. In a hybrid stack
    only the Mamba blocks are units (unit u is the u-th block of the
    ``params["blocks"]`` stack). Its ``f_dim`` is d_inner; no fused build."""

    _UNIT_KEYS = ("w_z", "w_x", "conv_x", "conv_b_x", "norm_w", "out_proj")
    _QUANT_KEYS = ("w_z", "w_x", "out_proj")

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_units = (cfg.hybrid_layout()[0] if cfg.block_pattern == "hybrid"
                        else cfg.n_layers)
        self.di = cfg.ssm.d_inner(cfg.d_model)
        self.head_dim = cfg.ssm.head_dim
        self.f_dim = self.di

    def base_stack(self, params):
        ssm = params["blocks"]["ssm"]
        return {k: ssm[k] for k in self._UNIT_KEYS}

    def transform_unit(self, base, t: inv.FFNTransform, u: int):
        b = layer_slice(base, u)
        pi = t.pi      # within-head block structured (self.propose)
        w_x, w_z, conv_x, out_proj = inv.apply_transform_mamba(
            pi, b["w_x"], b["w_z"], b["conv_x"], b["out_proj"], self.head_dim)
        return {"w_z": w_z, "w_x": w_x, "conv_x": conv_x,
                "conv_b_x": b["conv_b_x"][pi], "norm_w": b["norm_w"][pi],
                "out_proj": out_proj}

    def quant_unit(self, unit, qcfg: QuantConfig):
        """Fake-quant the three projections, one ``fake_quant`` call each,
        for one block's (K, N) leaves and the (L, K, N) stack alike
        (``quant_stack``); the conv and norm leaves pass through."""
        return {k: fake_quant(v, qcfg) if k in self._QUANT_KEYS else v
                for k, v in unit.items()}

    quant_stack = quant_unit

    def install(self, params, fq_stack):
        """``params`` with the unit leaves taken from ``fq_stack`` (no copy)."""
        params = dict(params)
        blocks = dict(params["blocks"])
        blocks["ssm"] = {**blocks["ssm"], **fq_stack}
        params["blocks"] = blocks
        return params

    def unit_override(self, u: int, unit):
        """``forward(layer_override=...)`` argument that makes the u-th SSM
        block read the candidate ``unit``."""
        return (u, {"ssm": unit})

    install_unit = DenseFFNAdapter.install_unit

    def propose(self, gen: torch.Generator, t: inv.FFNTransform,
                pcfg: inv.ProposalConfig) -> inv.FFNTransform:
        """Within-head partial shuffle (``inv.propose_within_head``)."""
        return inv.propose_within_head(gen, t, pcfg, self.head_dim)


class SharedFFNAdapter:
    """Hybrid (Zamba2): the FFN of the ONE shared block as a single unit —
    its weights serve every application, so one transform covers them all
    exactly. The stack has one unit (a leading axis of 1); the builds are
    the dense FFN's, the fused ``transform_quant`` lane included."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_units = 1
        self.f_dim = cfg.d_ff

    def base_stack(self, params):
        mlp = params["shared"]["mlp"]
        return {k: mlp[k][None] for k in ("up", "down", "gate", "b_up",
                                          "b_gate") if k in mlp}

    transform_unit = DenseFFNAdapter.transform_unit
    quant_unit = DenseFFNAdapter.quant_unit
    quant_stack = DenseFFNAdapter.quant_stack
    transform_quant_unit = DenseFFNAdapter.transform_quant_unit
    install_unit = DenseFFNAdapter.install_unit

    def install(self, params, fq_stack):
        """``params`` with the shared FFN's leaves taken from ``fq_stack``
        (views of its one unit; no copy)."""
        params = dict(params)
        shared = dict(params["shared"])
        shared["mlp"] = {**shared["mlp"],
                         **{k: v[0] for k, v in fq_stack.items()}}
        params["shared"] = shared
        return params

    def unit_override(self, u: int, unit):
        """``forward(layer_override=...)`` argument that makes every
        application of the shared block read the candidate ``unit``."""
        return ("shared", {"mlp": unit})


def make_adapter(cfg: ModelConfig, phase: str = None):
    """The search adapter of ``cfg``'s block pattern (the reference's
    dispatch): dense FFN units, one unit per expert for MoE, Mamba blocks
    for SSM; for hybrid the Mamba blocks, or with ``phase="shared"`` the
    shared block's FFN (the two phases of ``search.api``'s hybrid run). An
    encoder-decoder stack is dense: its units are the decoder's FFNs
    (``params["blocks"]``), so the encoder's FFNs are never searched."""
    check_supported(cfg)
    if cfg.block_pattern == "moe":
        return MoEAdapter(cfg)
    if cfg.block_pattern == "ssm":
        return MambaAdapter(cfg)
    if cfg.block_pattern == "hybrid":
        return SharedFFNAdapter(cfg) if phase == "shared" else MambaAdapter(cfg)
    return DenseFFNAdapter(cfg)


def _merge_phase_stats(s1, s2):
    """Sum the counters of two engine stats dicts (the reference's three,
    and the tabu counters); proposals_per_sec recombines as TOTAL proposals
    over TOTAL wall time; fused if either phase ran fused."""
    if s1 is None or s2 is None:
        return s2 or s1
    out = dict(s2)
    for k in ("migrations", "uphill_accepts", "proposals", "tabu_hits",
              "tabu_skips", "tabu_rebuilds"):
        out[k] = s1.get(k, 0) + s2.get(k, 0)
    t1 = s1.get("proposals", 0) / max(s1.get("proposals_per_sec", 0.0), 1e-9)
    t2 = s2.get("proposals", 0) / max(s2.get("proposals_per_sec", 0.0), 1e-9)
    out["proposals_per_sec"] = out["proposals"] / max(t1 + t2, 1e-9)
    out["fused"] = s1.get("fused", False) or s2.get("fused", False)
    return out


def run_search_hybrid(params_fp, params_base, cfg, qcfg, calib_tokens,
                      scfg: SearchConfig = SearchConfig(),
                      forward_kwargs=None):
    """Deprecated (the reference's shim): warns with ``DeprecationWarning``
    and runs ``repro_torch.search.run``, which two-phases hybrid block
    patterns automatically."""
    warnings.warn(
        "core.search.run_search_hybrid is deprecated; use "
        "repro_torch.search.run(...) (hybrid configs two-phase "
        "automatically)", DeprecationWarning, stacklevel=2)
    from repro_torch.search import run
    return run(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
               forward_kwargs=forward_kwargs, hybrid=True)


def run_search(params_fp, params_base, cfg, qcfg, calib_tokens,
               scfg: SearchConfig = SearchConfig(), adapter=None,
               forward_kwargs: Optional[dict] = None) -> SearchResult:
    """Deprecated (the reference's shim): warns with ``DeprecationWarning``
    and runs ``repro_torch.search.run`` with the legacy single-phase
    semantics — on a hybrid config it searches the Mamba blocks only."""
    warnings.warn(
        "core.search.run_search is deprecated; use repro_torch.search.run(...)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.search import run
    return run(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
               adapter=adapter, forward_kwargs=forward_kwargs, hybrid=False)
